"""PT throughput: tempered-ensemble chain-steps/s on the device.

Measures the parallel-tempering round scan (vmapped tempered stretch
sweeps + DEO swaps) with the RTT-robust methodology from bench.py:
long in-jit chains (>= 100 rounds per dispatch), value-fetch sync,
medians of repeated calls. Reports chain-steps/s counting every
(temperature, walker, move) density evaluation.

Usage: python benchmarks/dev/pt_rate.py [n_walkers] [n_temps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from aspire_tpu.flows import Flow
from aspire_tpu.models import GaussianMixtureProblem
from aspire_tpu.samplers import ParallelTemperedSampler


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n_temps = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    dims = 4
    swap_every = 5
    n_steps = 500  # >= 100 rounds in one jit: amortizes dispatch

    problem = GaussianMixtureProblem(dims=dims)
    rng = np.random.default_rng(0)
    flow = Flow(dims=dims, architecture="nsf", key=0, n_layers=4)
    flow.fit(
        problem.draw_initial_samples(rng, 8192),
        n_epochs=10,
        batch_size=512,
    )
    sampler = ParallelTemperedSampler(
        log_likelihood=problem.log_likelihood,
        log_prior=problem.log_prior,
        dims=dims,
        prior_flow=flow,
        parameters=problem.parameters,
        rng=jax.random.key(3),
    )
    # Warm-up compiles every program (draws + rounds).
    sampler.sample(n, n_steps=n_steps, n_temperatures=n_temps,
                   swap_every=swap_every)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        post = sampler.sample(
            n, n_steps=n_steps, n_temperatures=n_temps,
            swap_every=swap_every,
        )
        # A value fetch waits for the device.
        float(np.sum(np.asarray(post.x[:8])))
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]
    # One tempered-density pass per (temperature, walker, move).
    steps = n_steps * n_temps * n
    print(
        f"pt_rate: {steps / wall / 1e6:.2f} M chain-steps/s "
        f"(n={n}, T={n_temps}, {n_steps} steps, wall {wall:.3f}s, "
        f"rounds phase "
        f"{sampler.profiler.phases['pt/rounds'].total_s:.2f}s total)"
    )
    lz, err = post.log_evidence_stepping_stone()
    print(f"anchor: logZ={lz:.4f} +- {err:.4f}")


if __name__ == "__main__":
    main()
