"""Fit a flow to existing samples and importance-reweight the posterior.

JAX counterpart of the reference's examples/basic_example.py:
a 4-D Gaussian likelihood with a uniform prior (analytic log-evidence
``-dims * log(20)``). The likelihood/prior here are jittable, so the
entire sampling path runs on device.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from aspire_tpu import Aspire, Samples, configure_logger
from aspire_tpu.io import AspireFile
from aspire_tpu.plot import plot_comparison

configure_logger("INFO")

outdir = Path("outdir") / "basic_example"
outdir.mkdir(parents=True, exist_ok=True)

dims = 4


def log_likelihood(samples):
    # The log likelihood receives a samples object; samples.x is (n, d).
    return jnp.sum(
        -0.5 * (samples.x - 2.0) ** 2 - 0.5 * jnp.log(2 * jnp.pi), axis=-1
    )


def log_prior(samples):
    x = samples.x
    inside = jnp.all((x >= -10) & (x <= 10), axis=-1)
    return jnp.where(inside, -dims * jnp.log(20.0), -jnp.inf)


true_log_evidence = -dims * math.log(20)

# Initial samples, slightly biased compared to the true posterior.
rng = np.random.default_rng(42)
initial_samples = Samples(rng.normal(2.5, 1.0, size=(5000, dims)))

parameters = [f"x_{i}" for i in range(dims)]
prior_bounds = {p: [-10, 10] for p in parameters}

aspire = Aspire(
    log_likelihood=log_likelihood,
    log_prior=log_prior,
    dims=dims,
    parameters=parameters,
    prior_bounds=prior_bounds,
)

history = aspire.fit(initial_samples, n_epochs=50)
history.plot_loss().savefig(outdir / "loss.png")

samples = aspire.sample_posterior(5000)
print(f"log Z = {float(samples.log_evidence):.3f} "
      f"+/- {float(samples.log_evidence_error):.3f} "
      f"(true {true_log_evidence:.3f})")

with AspireFile(outdir / "aspire_result.h5", "w") as f:
    aspire.save_config(f, "aspire_config")
    samples.save(f, "posterior_samples")
    history.save(f, "flow_history")
    aspire.save_flow(f, "flow")

fig = plot_comparison(
    initial_samples,
    samples,
    samples,
    per_samples_kwargs=[
        dict(include_weights=True, color="C0"),
        dict(include_weights=False, color="lightgrey"),
        dict(include_weights=True, color="C1"),
    ],
    labels=["Training samples", "Samples (w/o weights)", "Posterior samples"],
)
fig.savefig(outdir / "comparison.png")
