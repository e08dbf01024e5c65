"""Importance sampler (parity: reference samplers/importance.py:6-23).

Draw n samples from the flow proposal, evaluate log-prior/likelihood, and
compute importance weights, evidence, and ESS. On device the flow sampling +
density evaluation is one fused XLA computation over the whole batch.
"""

from __future__ import annotations

import logging

from ..samples import Samples
from ..utils import track_calls
from .base import Sampler

logger = logging.getLogger("aspire_tpu")


class ImportanceSampler(Sampler):
    """Importance sampling with the flow as proposal."""

    @track_calls
    def sample(self, n_samples: int) -> Samples:
        # Closed signature: sample_posterior warns about (instead of
        # silently swallowing) kwargs this sampler does not support.
        x, log_q = self.prior_flow.sample_and_log_prob(
            n_samples, key=self.next_key()
        )
        samples = Samples(
            x=x,
            log_q=log_q,
            dtype=self.dtype,
            parameters=self.parameters,
        )
        samples.log_prior = self.evaluate_log_prior(samples.x)
        samples.log_likelihood = self.evaluate_log_likelihood(samples.x)
        samples.compute_weights()
        return samples
