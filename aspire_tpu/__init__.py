"""aspire_tpu: accelerated sequential posterior inference on JAX.

A from-scratch JAX/XLA framework with the capabilities of ``aspire``
(sequential posterior reuse: normalizing-flow proposal fit to existing
posterior samples; importance sampling, MCMC, and adaptive-tempered SMC
with evidence estimation, diagnostics, and checkpoint/resume), designed
accelerator-first: particles live in device-resident ``(n, d)`` arrays
sharded over a device mesh, densities are fused XLA kernels, reductions are psum trees,
and resampling runs on device.
"""

import logging

__version__ = "0.1.0"

from .samples import (  # noqa: E402,F401
    BaseSamples,
    MCMCSamples,
    PTMCMCSamples,
    Samples,
    SMCSamples,
)
from .aspire import Aspire  # noqa: E402,F401
from .utils import PoolHandler, configure_logger  # noqa: E402,F401

logging.getLogger("aspire_tpu").addHandler(logging.NullHandler())

__all__ = [
    "Aspire",
    "BaseSamples",
    "MCMCSamples",
    "PTMCMCSamples",
    "PoolHandler",
    "Samples",
    "SMCSamples",
    "configure_logger",
    "__version__",
]
