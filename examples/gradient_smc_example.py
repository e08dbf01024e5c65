"""SMC with gradient-based (NUTS) mutations.

JAX counterpart of the reference's examples/blackjax_smc_example.py.
``sampler="nuts_smc"`` runs a real static-shape No-U-Turn sampler: each
particle doubles its own trajectory under ``vmap`` (multinomial
progressive sampling, bounded ``max_depth``), so trajectory lengths adapt
per particle with every shape static under ``jit``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pathlib import Path

import numpy as np

from aspire_tpu import Aspire, Samples, configure_logger
from aspire_tpu.models import FunnelProblem

configure_logger("INFO")

outdir = Path("outdir") / "gradient_smc_example"
outdir.mkdir(parents=True, exist_ok=True)

rng = np.random.default_rng(0)
problem = FunnelProblem(dims=5)

initial_samples = Samples(problem.draw_initial_samples(rng, 4000))

aspire = Aspire(
    log_likelihood=problem.log_likelihood,
    log_prior=problem.log_prior,
    dims=problem.dims,
    flow_backend="maf",
)

aspire.fit(initial_samples, n_epochs=30)

samples, history = aspire.sample_posterior(
    sampler="nuts_smc",
    n_samples=500,
    target_efficiency=0.8,
    sampler_kwargs=dict(n_steps=10, step_size=0.1, max_depth=6),
    return_history=True,
)

print(
    f"log Z = {float(samples.log_evidence):.3f} "
    f"+/- {float(samples.log_evidence_error):.3f}"
)
history.plot().savefig(outdir / "smc_diagnostics.png")
samples.plot_corner().savefig(outdir / "posterior.png")
