"""Sequential posterior inference with adaptive-tempered SMC.

JAX counterpart of the reference's examples/smc_example.py: a 4-D
two-Gaussian-mixture target with deliberately offset initial samples, an
NSF flow proposal, tpCN mutations, checkpoint/resume via
``auto_checkpoint``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pathlib import Path

import numpy as np

from aspire_tpu import Aspire, Samples, configure_logger
from aspire_tpu.io import AspireFile
from aspire_tpu.models import GaussianMixtureProblem
from aspire_tpu.plot import plot_comparison

configure_logger("INFO")

outdir = Path("outdir") / "smc_example"
outdir.mkdir(parents=True, exist_ok=True)

rng = np.random.default_rng(42)
dims = 4
problem = GaussianMixtureProblem(dims=dims)

prior_samples = Samples(rng.normal(0, 1, size=(5000, dims)))
initial_samples = Samples(problem.draw_initial_samples(rng, 5000))

aspire = Aspire(
    log_likelihood=problem.log_likelihood,
    log_prior=problem.log_prior,
    dims=dims,
    flow_backend="nsf",
)

with aspire.auto_checkpoint(
    outdir / "aspire_smc_checkpoint.h5", every=1, resume=True
):
    fit_history = aspire.fit(initial_samples, n_epochs=30)
    fit_history.plot_loss().savefig(outdir / "loss.png")
    samples, history = aspire.sample_posterior(
        sampler="smc",
        n_samples=500,
        n_final_samples=5000,
        sampler_kwargs=dict(n_steps=20),
        return_history=True,
    )

history.plot().savefig(outdir / "smc_diagnostics.png")
history.plot_sample_history(x_axis="log_likelihood").savefig(
    outdir / "smc_sample_history.png"
)
# Mutation-quality diagnostics recorded for every mutation (ladder
# iterations + the final n_final_samples mutation): the online
# integrated-autocorrelation-time estimate and the independent-lineage
# fraction that inflates the evidence error bar.
assert len(history.mcmc_autocorr) >= len(history.beta) > 0
history.plot_mcmc_autocorr().savefig(outdir / "smc_mcmc_autocorr.png")
history.plot_lineage_fraction().savefig(
    outdir / "smc_lineage_fraction.png"
)

with AspireFile(outdir / "aspire_smc_results.h5", "w") as f:
    aspire.save_config(f, "aspire_config")
    aspire.save_sampler_config(f, "sampler_config")
    aspire.save_flow(f, "flow")
    samples.save(f, "posterior_samples")
    history.save(f, "smc_history")
    fit_history.save(f, "fit_history")

plot_comparison(
    initial_samples,
    prior_samples,
    samples,
    labels=["Initial Samples", "Prior Samples", "SMC Samples"],
).savefig(outdir / "posterior.png")
