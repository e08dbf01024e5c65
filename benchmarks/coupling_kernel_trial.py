"""Fused coupling-density kernel against XLA's density pass, on one GPU.

For each shape (by default the d=4 ``nsf-tpu`` preset at n=131072 and
the d=32 flow of benchmarks/hierarchical.py at n=2^20), times

- one density evaluation inside a ``lax.scan`` of ``--scan-steps``
  evaluations: the kernel against ``Coupling._forward_xla``;
- bench.py's XLA mutation chain, end to end, with each of the two as
  the flow's density pass.

A shape the dispatch predicate does not give to the kernel is timed on
XLA only, unless the shape is marked ``trial`` (the d=8 and d=16 flows
at the hierarchical widths): those time the kernel outside the
predicate, to decide whether to widen it. Both variants are compiled
first; timed calls then alternate (XLA, kernel, kernel, XLA, ...) and
the median of each is reported. ``--sweep`` first sweeps the kernel's
rows per program and warps at d=4; ``--crossover N ...`` times one
evaluation at d=4 for each population N. Prints one JSON line per
shape, sweep and crossover.

    python benchmarks/coupling_kernel_trial.py [--sweep] [--crossover 1024 4096]
    python benchmarks/coupling_kernel_trial.py --shapes d8_hierarchical
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

HIERARCHICAL_FLOW = {"architecture": "nsf", "n_layers": 6,
                     "n_hidden": (128, 128)}
SHAPES = {
    "d4_nsf_tpu": dict(n=131072, dims=4, flow={"architecture": "nsf-tpu"},
                       chain_steps=500),
    "d32_hierarchical": dict(n=1 << 20, dims=32, flow=HIERARCHICAL_FLOW,
                             chain_steps=100),
    "d8_hierarchical": dict(n=1 << 20, dims=8, flow=HIERARCHICAL_FLOW,
                            chain_steps=100, trial=True),
    "d16_hierarchical": dict(n=1 << 20, dims=16, flow=HIERARCHICAL_FLOW,
                             chain_steps=100, trial=True),
}
DEFAULT_SHAPES = ["d4_nsf_tpu", "d32_hierarchical"]


def _alternate(fns: dict, reps: int) -> dict:
    """Median seconds per call of each zero-argument callable, in turns."""
    import jax

    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(reps):
        for name in order if r % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[name]())
            times[name].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in times.items()}


def density_scan(
    shape: dict, scan_steps: int, reps: int, configs: dict | None = None
) -> dict:
    """Seconds per density evaluation, XLA and kernel configs, in turns.

    ``configs`` maps a name to ``(block, num_warps)``; by default the
    kernel runs with the configuration the library picks, and only when
    the predicate would choose it or the shape is a ``trial``.
    """
    import jax
    import jax.numpy as jnp

    from aspire_tpu.flows import Flow
    from aspire_tpu.ops import fused_coupling as FC

    flow = Flow(dims=shape["dims"], key=0, **shape["flow"])
    arch = flow.architecture
    params = jax.tree.map(
        lambda p: p
        + 0.1 * jax.random.normal(jax.random.key(7), p.shape, p.dtype),
        flow.params,
    )
    x0 = jax.random.normal(
        jax.random.key(1), (shape["n"], shape["dims"]), jnp.float32
    )
    base = FC.kernel_config(arch)
    if configs is None:
        chosen = FC.use_kernel(arch, x0) or shape.get("trial", False)
        configs = {"kernel": (base.block, base.num_warps)} if chosen else {}

    def kernel(block, warps):
        cfg = dataclasses.replace(base, block=block, num_warps=warps)
        return lambda p, x: FC.coupling_density_pallas(
            cfg, FC.prepare_params(cfg, p), x
        )

    def scanned(density):
        @jax.jit
        def run(p, x):
            def body(x, _):
                z, ld = density(p, x)
                # Feed the result back so no evaluation is loop-invariant.
                return x + 1e-6 * jnp.tanh(z) + 1e-9 * ld[:, None], None

            return jax.lax.scan(body, x, None, length=scan_steps)[0]

        return run

    runs = {"xla": scanned(arch._forward_xla)}
    runs.update({k: scanned(kernel(*c)) for k, c in configs.items()})
    for run in runs.values():
        jax.block_until_ready(run(params, x0))
    med = _alternate({k: (lambda r=r: r(params, x0)) for k, r in runs.items()},
                     reps)
    return {k: v / scan_steps for k, v in med.items()}


def chain_rate(shape: dict, reps: int) -> dict:
    """bench.py's mutation rate (particle-steps/s), kernel vs XLA."""
    import jax
    import jax.numpy as jnp

    import bench
    from aspire_tpu.flows import Flow
    from aspire_tpu.ops import fused_coupling as FC

    chains = {}
    use_kernel = FC.use_kernel
    probe = jnp.zeros((shape["n"], shape["dims"]), jnp.float32)
    trial = shape.get("trial", False)
    chosen = trial or use_kernel(
        Flow(dims=shape["dims"], key=0, **shape["flow"]).architecture, probe
    )
    for name in ("xla", "kernel") if chosen else ("xla",):
        # The dispatch predicate is read while the chain is traced.
        if name == "xla":
            FC.use_kernel = lambda arch, x: False
        elif trial:
            FC.use_kernel = lambda arch, x: True
        try:
            mutate, params, x, beta, key, n_steps = bench.build_workload(
                shape["n"],
                dims=shape["dims"],
                n_steps=shape["chain_steps"],
                flow_kwargs={**shape["flow"], "key": 0},
            )
            out = mutate(params, x, beta, key, n_steps=n_steps)
            jax.block_until_ready(out)
        finally:
            FC.use_kernel = use_kernel
        chains[name] = (mutate, params, out[0], beta, key, n_steps)
    med = _alternate(
        {
            name: (
                lambda c=c: c[0](c[1], c[2], c[3], c[4], n_steps=c[5])
            )
            for name, c in chains.items()
        },
        reps,
    )
    return {
        k: shape["n"] * shape["chain_steps"] / v for k, v in med.items()
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scan-steps", type=int, default=200)
    parser.add_argument("--reps", type=int, default=6)
    parser.add_argument("--shapes", nargs="*", default=DEFAULT_SHAPES,
                        choices=list(SHAPES))
    parser.add_argument("--sweep", action="store_true",
                        help="sweep block x warps at d=4 first")
    parser.add_argument("--crossover", nargs="*", type=int, default=[],
                        help="populations at which to time d=4 once each")
    args = parser.parse_args()

    import jax

    import bench
    from aspire_tpu.profiling import card_line
    from aspire_tpu.utils import enable_compilation_cache

    device = bench.device_record()
    if device["platform"] != "gpu":
        sys.exit(f"this trial measures a GPU; JAX found {jax.devices()}")
    enable_compilation_cache()
    card = card_line()
    d4 = SHAPES["d4_nsf_tpu"]
    if args.sweep:
        sweep = density_scan(
            d4,
            args.scan_steps,
            args.reps,
            {
                f"block{b}_warps{w}": (b, w)
                for b in (64, 128, 256)
                for w in (2, 4, 8)
            },
        )
        print(json.dumps({"sweep_d4_s_per_eval": sweep, "card": card}),
              flush=True)
    for n in args.crossover:
        per_eval = density_scan(
            {**d4, "n": n, "trial": True}, args.scan_steps, args.reps
        )
        print(json.dumps({"crossover_d4_n": n, "density_s_per_eval": per_eval,
                          "card": card}), flush=True)
    for name in args.shapes:
        shape = SHAPES[name]
        per_eval = density_scan(shape, args.scan_steps, args.reps)
        rates = chain_rate(shape, args.reps)
        print(
            json.dumps(
                {
                    "shape": name,
                    "n": shape["n"],
                    "device": device,
                    "card": card,
                    "precision": bench.chain_dot_precision(),
                    "density_s_per_eval": per_eval,
                    "chain_particle_steps_per_s": rates,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
