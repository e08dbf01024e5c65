"""Weak-scaling harness: particles/s and ESS/s vs device count.

BASELINE.md target: >= 80% weak-scaling efficiency of particles/s from
1 host to 4 hosts. Without multi-chip hardware this harness runs on a
virtual CPU mesh (``--cpu N``) to validate the scaling *structure*
(collective placement, shard balance); on a pod slice it runs unchanged
over the real mesh after ``initialize_distributed()``.

Usage:
  python benchmarks/scaling.py --cpu 8 --particles-per-device 4096
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
    parser.add_argument("--cpu", type=int, default=0,
                        help="force a virtual CPU mesh of this many devices")
    parser.add_argument("--particles-per-device", type=int, default=8192)
    parser.add_argument("--dims", type=int, default=4)
    parser.add_argument("--n-steps", type=int, default=10)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)
    else:
        from aspire_tpu.utils import enable_compilation_cache

        enable_compilation_cache()

    import jax.numpy as jnp
    import numpy as np

    from aspire_tpu.parallel.mesh import make_mesh, particle_sharding
    from aspire_tpu.ops.special import effective_sample_size
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "bench",
        os.path.join(os.path.dirname(__file__), "..", "bench.py"),
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    total_devices = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= total_devices]
    results = []
    base_rate = None
    for n_dev in counts:
        mesh = make_mesh(n_dev)
        n = args.particles_per_device * n_dev
        mutate, params, x, beta, key, n_steps = bench.build_workload(
            n, dims=args.dims, n_steps=args.n_steps
        )
        x = jax.device_put(x, particle_sharding(mesh))
        out = mutate(params, x, beta, key, n_steps=n_steps)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i in range(args.reps):
            key = jax.random.fold_in(key, i)
            out = mutate(params, out[0], beta, key, n_steps=n_steps)
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - t0
        rate = n * n_steps * args.reps / elapsed
        ess = float(effective_sample_size(out[1] - jnp.max(out[1])))
        ess_rate = ess * args.reps / elapsed
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n_dev)
        results.append(
            {
                "devices": n_dev,
                "particles": n,
                "particle_steps_per_s": rate,
                "ess_per_s": ess_rate,
                "weak_scaling_efficiency": eff,
            }
        )
        print(
            f"devices={n_dev:3d} n={n:8d} rate={rate:.3e} p-s/s "
            f"eff={eff:.2%}",
            file=sys.stderr,
        )
    print(json.dumps(results))


if __name__ == "__main__":
    main()
