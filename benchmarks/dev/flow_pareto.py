"""Pareto sweep: flow shape vs throughput vs statistical-gate margin.

The bench flow config (nsf, 4 layers, (64,64) hidden, 8 bins) is
inherited from the reference's CPU-era defaults
(reference flows/torch/flows.py:155-158); round 3 measured the mutation
kernel to be VPU-op-count bound in the spline phase, so FEWER
layers/bins is the remaining throughput lever — IF the smaller flow
keeps the statistical gates at unchanged margins (the flow is the
beta=0 proposal and independence-move kernel, not the estimator).

Phase 1 (rate): mutation throughput of each config at the headline
workload (n=131072, 500 in-jit steps, median of reps). Configs are
measured SEQUENTIALLY in one process back-to-back — each config's
median-of-reps absorbs dispatch jitter, but slow drift across configs
is NOT controlled; interleave configs before trusting small
differences.
Phase 2 (gate): fit each config on the mixture + funnel targets and run
the production SMC gate (n=16384, 20 steps); report |logZ - truth| and
the delta-method error.

Usage: python benchmarks/dev/flow_pareto.py [rate|gate|all]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

CONFIGS = {
    "L4-H64x2-B8 (default)": {
        "n_layers": 4, "n_hidden": (64, 64), "num_bins": 8,
    },
    "L4-H64x2-B4": {"n_layers": 4, "n_hidden": (64, 64), "num_bins": 4},
    "L3-H64x2-B8": {"n_layers": 3, "n_hidden": (64, 64), "num_bins": 8},
    "L2-H64x2-B8": {"n_layers": 2, "n_hidden": (64, 64), "num_bins": 8},
    "L2-H64x2-B4": {"n_layers": 2, "n_hidden": (64, 64), "num_bins": 4},
    "L2-H32x2-B8": {"n_layers": 2, "n_hidden": (32, 32), "num_bins": 8},
    "L2-H32x2-B4": {"n_layers": 2, "n_hidden": (32, 32), "num_bins": 4},
    "L2-H128x1-B8": {"n_layers": 2, "n_hidden": (128,), "num_bins": 8},
}


def flow_kwargs(cfg):
    return {"architecture": "nsf", "key": 0, **cfg}


def phase_rate():
    import bench

    rows = {}
    for name, cfg in CONFIGS.items():
        rate = bench.measure_rate(
            n_particles=131072,
            n_steps=500,
            reps=3,
            flow_kwargs=flow_kwargs(cfg),
        )
        model = bench.roofline_model(
            131072, flow_kwargs=flow_kwargs(cfg)
        )
        rows[name] = {
            "rate": rate,
            "flops_per_ps": model["flops_per_particle_step"],
        }
        print(
            json.dumps({"phase": "rate", "config": name, **rows[name]}),
            flush=True,
        )
    return rows


def phase_gate():
    from aspire_tpu import Aspire, Samples, configure_logger
    from aspire_tpu.models import FunnelProblem, GaussianMixtureProblem
    from validate import analytic_log_z

    configure_logger("WARNING")
    for problem, init_fn in [
        (
            GaussianMixtureProblem(dims=4),
            lambda rng: GaussianMixtureProblem(
                dims=4
            ).draw_initial_samples(rng, 8192),
        ),
        (
            FunnelProblem(dims=5),
            lambda rng: FunnelProblem(dims=5).draw_initial_samples(
                rng, 8192
            ),
        ),
    ]:
        true = analytic_log_z(problem)
        for name, cfg in CONFIGS.items():
            rng = np.random.default_rng(0)
            asp = Aspire(
                log_likelihood=problem.log_likelihood,
                log_prior=problem.log_prior,
                dims=problem.dims,
                prior_bounds=problem.prior_bounds,
                flow_backend="nsf",
                seed=1,
                **cfg,
            )
            asp.fit(Samples(init_fn(rng)), n_epochs=25, batch_size=512)
            post = asp.sample_posterior(
                sampler="smc",
                n_samples=16384,
                store_sample_history=False,
                sampler_kwargs={"n_steps": 20},
            )
            lz = float(post.log_evidence)
            err = float(post.log_evidence_error)
            print(
                json.dumps(
                    {
                        "phase": "gate",
                        "problem": type(problem).__name__,
                        "config": name,
                        "log_z": round(lz, 4),
                        "err": round(err, 4),
                        "abs_diff": round(abs(lz - true), 4),
                        "true": round(true, 4),
                    }
                ),
                flush=True,
            )


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode in ("rate", "all"):
        phase_rate()
    if mode in ("gate", "all"):
        phase_gate()
