"""BASELINE config 5: d=32 hierarchical posterior, ~1M particles.

Runs the full pipeline (fit NSF proposal -> adaptive-tempered SMC with
tpCN mutations) at production scale on whatever device is available and
reports throughput + two independent evidence estimates (importance
sampling vs SMC) as a consistency anchor (the model has no closed-form
evidence: the log-scale parameter breaks conjugacy).

Usage:
  python benchmarks/hierarchical.py [--particles 1048576] [--dims 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--particles", type=int, default=1_048_576)
    parser.add_argument("--dims", type=int, default=32)
    parser.add_argument("--n-steps", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--train-samples", type=int, default=32_768)
    parser.add_argument("--waste-free", action="store_true",
                        help="pool k-step chains from n/k ancestors")
    args = parser.parse_args()

    import jax
    import numpy as np

    from aspire_tpu import Aspire, Samples, configure_logger
    from aspire_tpu.models import HierarchicalProblem
    from aspire_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    configure_logger("INFO")
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    problem = HierarchicalProblem(dims=args.dims)
    rng = np.random.default_rng(7)
    initial = Samples(problem.draw_initial_samples(rng, args.train_samples))

    asp = Aspire(
        log_likelihood=problem.log_likelihood,
        log_prior=problem.log_prior,
        dims=args.dims,
        flow_backend="nsf",
        n_layers=6,
        n_hidden=(128, 128),
        seed=3,
    )
    t0 = time.time()
    asp.fit(initial, n_epochs=args.epochs, batch_size=1024)
    fit_s = time.time() - t0

    # Importance-sampling anchor (independent of the SMC machinery).
    is_post = asp.sample_posterior(
        sampler="importance", n_samples=min(args.particles, 262_144)
    )
    is_logz = float(is_post.log_evidence)
    is_err = float(is_post.log_evidence_error)

    t0 = time.time()
    post, hist = asp.sample_posterior(
        sampler="smc",
        n_samples=args.particles,
        sampler_kwargs=dict(
            n_steps=args.n_steps, waste_free=args.waste_free
        ),
        store_sample_history=False,
        return_history=True,
    )
    smc_s = time.time() - t0
    prof = asp.sampler.profiler
    # Host ladder times mutation separately; the (default) device
    # ladder is one dispatch, so its whole wall time is the honest
    # denominator.
    mutate_s = prof.phases["mutate"].total_s
    if mutate_s == 0 and "ladder" in prof.phases:
        mutate_s = prof.phases["ladder"].total_s
    n_temps = len(hist.beta)
    particle_steps = args.particles * args.n_steps * n_temps
    report = {
        "dims": args.dims,
        "particles": args.particles,
        "n_temperatures": n_temps,
        "fit_s": round(fit_s, 2),
        "smc_wall_s": round(smc_s, 2),
        "mutation_particle_steps_per_s": round(particle_steps / mutate_s),
        "log_z_smc": round(float(post.log_evidence), 4),
        "log_z_smc_err": round(float(post.log_evidence_error), 4),
        "log_z_importance": round(is_logz, 4),
        "log_z_importance_err": round(is_err, 4),
        "min_iter_ess": round(min(hist.ess)) if hist.ess else None,
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
