"""Smoke test of the main path on an NVIDIA GPU.

Drives ``Aspire.fit`` -> ``sample_posterior(sampler="smc")`` -> logZ
through the public API at the benchmark's sizes, on random weights made
from fixed seeds:

- kernel parity: the compiled coupling-density kernel against
  ``Coupling._forward_xla`` in full float32, on random flows covering
  every axis of the domain the kernel is chosen for
  (``fused_coupling.supported``) at n=16384, and on the anchor's fitted
  d=4 nsf-tpu flow at n=131072;
- anchor: the d=4 two-Gaussian mixture, fit on 4000 samples, SMC with
  131072 particles on the compiled device ladder, logZ against the
  analytic evidence within max(5 sigma, 0.02);
- realistic dimension: the d=32 hierarchical posterior at 2^20
  particles must reach beta = 1 with a finite logZ;
- precision: the anchor again under ``jax.default_matmul_precision
  ("highest")``.

With ``--four`` it runs only the sharded path on four GPUs in one
process: the anchor at 2^20 particles over a 4-device mesh against the
same run on one card, and the ring and all-to-all resamplers against the
GSPMD gather (bit-identical).

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs

Prints one line per phase, the card's name and power limit, and as its
last line one JSON object ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no JSON, when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import numpy as np

ANCHOR_N = 131072
REALISTIC_N = 1 << 20
# The d=32 flow of benchmarks/hierarchical.py.
WIDE_FLOW = dict(n_layers=6, n_hidden=(128, 128))


def _say(*args):
    print(*args, flush=True)


def peak_bytes() -> int | None:
    """Largest ``peak_bytes_in_use`` over the devices (None on CPU)."""
    import jax

    peaks = [
        (d.memory_stats() or {}).get("peak_bytes_in_use")
        for d in jax.devices()
    ]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


# Flows of the kernel's parity sweep: every dims x transformer pair the
# kernel is chosen for, with the depths, hidden widths and bin counts
# spread over them so that each value of each axis of
# ``fused_coupling.supported`` appears at least once.
SWEEP_FLOWS = (
    dict(dims=2, transformer="rqs", n_layers=3, n_hidden=(64, 64), num_bins=4),
    dict(dims=2, transformer="affine", n_layers=1, n_hidden=(16,)),
    dict(dims=3, transformer="rqs", n_layers=4, n_hidden=(32, 32), num_bins=8),
    dict(dims=3, transformer="affine", n_layers=2, n_hidden=(32,)),
    dict(dims=4, transformer="rqs", n_layers=3, n_hidden=(64, 64),
         num_bins=16),
    dict(dims=4, transformer="affine", n_layers=3, n_hidden=(64, 64)),
)

# The kernel's errors against float64 may be at most these multiples of
# XLA's float32 errors on the same batch (RMS, max), or _ERR_FLOOR, about
# eight float32 ulps at 1, where XLA's own error is smaller still. On an
# H100 the kernel's spline arithmetic alone (a d=1 flow, no products)
# read 2.5x XLA's RMS error and 2.85x its maximum; a fault of 1e-4 in a
# few rows exceeds these bounds five times over on the sweep's flows.
_RMS_FACTOR, _MAX_FACTOR, _ERR_FLOOR = 3.0, 4.0, 1e-6


def _parity(arch, params, x, interpret: bool = False) -> dict:
    """Fused kernel vs ``_forward_xla``, both in full float32, against
    ``_forward_xla`` in float64 on the batch ``x``.

    Passes when the kernel's outputs are finite and its RMS and maximum
    errors in z (relative to 1 + |z|) and in log_det are within
    ``_RMS_FACTOR`` and ``_MAX_FACTOR`` of XLA's own float32 errors. A
    fixed bound would sit below float32's conditioning: XLA against XLA
    with only its output product re-blocked differs by 1.9e-5 (1 + |z|)
    on the anchor flow at n=131072.
    """
    import jax
    import jax.numpy as jnp

    from aspire_tpu.ops import fused_coupling as FC

    cfg = FC.kernel_config(arch)
    kernel = jax.jit(
        lambda p, x: FC.coupling_density_pallas(
            cfg, FC.prepare_params(cfg, p), x, interpret=interpret
        )
    )
    with jax.default_matmul_precision("highest"):
        xla = jax.jit(arch._forward_xla)(params, x)
        t0 = time.perf_counter()
        fused = jax.block_until_ready(kernel(params, x))
        first_call_s = time.perf_counter() - t0
        with jax.enable_x64(True):
            exact = jax.jit(arch._forward_xla)(
                jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params),
                jnp.asarray(x, jnp.float64),
            )
    z64, ld64 = (np.asarray(a, np.float64) for a in exact)

    def errors(out):
        dz = (np.asarray(out[0], np.float64) - z64) / (1 + np.abs(z64))
        dld = np.asarray(out[1], np.float64) - ld64
        return {
            "rms_rel_dz": float(np.sqrt(np.mean(dz**2))),
            "rms_dlogdet": float(np.sqrt(np.mean(dld**2))),
            "max_rel_dz": float(np.max(np.abs(dz))),
            "max_abs_dlogdet": float(np.max(np.abs(dld))),
        }

    kernel_err, xla_err = errors(fused), errors(xla)
    finite = bool(np.isfinite(fused[0]).all() and np.isfinite(fused[1]).all())
    within = all(
        kernel_err[k]
        <= max((_RMS_FACTOR if k.startswith("rms") else _MAX_FACTOR)
               * xla_err[k], _ERR_FLOOR)
        for k in kernel_err
    )
    return {
        "n": int(x.shape[0]),
        "block": cfg.block,
        "kernel_first_call_s": first_call_s,
        "kernel_vs_f64": kernel_err,
        "xla_vs_f64": xla_err,
        "ok": finite and within,
    }


def kernel_parity(
    n: int = ANCHOR_N,
    n_train: int = 4000,
    n_epochs: int = 20,
    interpret: bool = False,
) -> dict:
    """The kernel on the anchor's flow (nsf-tpu, fitted to the d=4
    mixture) and its own draws in the flow's space, as the density pass
    sees them during SMC (see ``_parity``)."""
    import jax
    import jax.numpy as jnp

    asp, _ = _fitted_mixture(n_train, n_epochs)
    arch, params = asp.flow.architecture, asp.flow.params
    z0 = jax.random.normal(jax.random.key(3), (n, arch.dims), jnp.float32)
    with jax.default_matmul_precision("highest"):
        x, _ = jax.jit(arch._inverse_xla)(params, z0)
    return {"dims": arch.dims, **_parity(arch, params, x, interpret)}


def kernel_sweep(
    n: int = 16384, flows=SWEEP_FLOWS, interpret: bool = False
) -> dict:
    """The kernel on each of ``flows`` with random weights (the zero-init
    flow plus 0.05-scale noise, which keeps float32 rounding, not the
    flow's conditioning, the source of error), on inputs of scale 2.5, so
    that some rows lie beyond the spline's tail bound (see ``_parity``)."""
    import jax
    import jax.numpy as jnp

    from aspire_tpu.flows.architectures import Coupling

    results = {}
    for i, flow in enumerate(flows):
        arch = Coupling(**flow)
        params = jax.tree.map(
            lambda p: p + 0.05 * jax.random.normal(
                jax.random.key(20 + i), p.shape, p.dtype
            ),
            arch.init(jax.random.key(i)),
        )
        x = 2.5 * jax.random.normal(
            jax.random.key(40 + i), (n, arch.dims), jnp.float32
        )
        name = "d{dims}_{transformer}_{n_layers}x{n_hidden}".format(**flow)
        if arch.transformer == "rqs":
            name += f"_k{arch.num_bins}"
        results[name] = _parity(arch, params, x, interpret)
    return {
        "n": n,
        "flows": results,
        "ok": all(r["ok"] for r in results.values()),
    }


def _fitted_mixture(n_train: int, n_epochs: int, seed: int = 1):
    from aspire_tpu import Aspire, Samples
    from aspire_tpu.models import GaussianMixtureProblem

    problem = GaussianMixtureProblem(dims=4)
    rng = np.random.default_rng(42)
    init = Samples(problem.draw_initial_samples(rng, n_train))
    asp = Aspire(
        log_likelihood=problem.log_likelihood,
        log_prior=problem.log_prior,
        dims=4,
        parameters=problem.parameters,
        flow_backend="nsf",
        architecture="nsf-tpu",
        seed=seed,
    )
    asp.fit(init, n_epochs=n_epochs, batch_size=512, learning_rate=3e-3)
    return asp, problem


def _smc(asp, n_samples: int, n_steps: int, **kwargs):
    import jax

    t0 = time.perf_counter()
    post = asp.sample_posterior(
        sampler="smc",
        n_samples=n_samples,
        store_sample_history=False,
        device_ladder=True,
        sampler_kwargs=dict(n_steps=n_steps),
        **kwargs,
    )
    jax.block_until_ready(post.x)
    return post, time.perf_counter() - t0


def anchor(
    n_train: int = 4000,
    n_epochs: int = 20,
    n_samples: int = ANCHOR_N,
    n_steps: int = 20,
    repeats: int = 3,
) -> dict:
    """Mixture logZ against the analytic evidence; compiled wall time."""
    asp, problem = _fitted_mixture(n_train, n_epochs)
    post, first_s = _smc(asp, n_samples, n_steps)
    walls = [_smc(asp, n_samples, n_steps)[1] for _ in range(repeats)]
    log_z = float(post.log_evidence)
    err = float(post.log_evidence_error)
    truth = problem.true_log_evidence
    tol = max(5.0 * err, 0.02)
    return {
        "n": n_samples,
        "log_z": log_z,
        "log_z_err": err,
        "truth": truth,
        "tol": tol,
        "first_call_s": first_s,
        "compiled_wall_s": float(np.median(walls)),
        "peak_bytes": peak_bytes(),
        "ok": bool(abs(log_z - truth) < tol),
    }


def realistic(
    dims: int = 32,
    n_samples: int = REALISTIC_N,
    n_steps: int = 32,
    n_epochs: int = 20,
    n_train: int = 32768,
    flow_kwargs: dict = WIDE_FLOW,
) -> dict:
    """The hierarchical posterior of benchmarks/hierarchical.py: SMC must
    reach beta = 1 with a finite logZ (no closed-form evidence)."""
    from aspire_tpu import Aspire, Samples
    from aspire_tpu.models import HierarchicalProblem

    problem = HierarchicalProblem(dims=dims)
    rng = np.random.default_rng(7)
    initial = Samples(problem.draw_initial_samples(rng, n_train))
    asp = Aspire(
        log_likelihood=problem.log_likelihood,
        log_prior=problem.log_prior,
        dims=dims,
        flow_backend="nsf",
        seed=3,
        **flow_kwargs,
    )
    t0 = time.perf_counter()
    asp.fit(initial, n_epochs=n_epochs, batch_size=1024)
    fit_s = time.perf_counter() - t0
    _, first_s = _smc(asp, n_samples, n_steps)
    post, wall_s = _smc(asp, n_samples, n_steps)
    betas = asp.sampler.history.beta
    log_z = float(post.log_evidence)
    final_beta = float(betas[-1])
    return {
        "dims": dims,
        "n": n_samples,
        "fit_s": fit_s,
        "n_temperatures": len(betas),
        "final_beta": final_beta,
        "log_z": log_z,
        "log_z_err": float(post.log_evidence_error),
        "first_call_s": first_s,
        "compiled_wall_s": wall_s,
        "peak_bytes": peak_bytes(),
        "ok": final_beta == 1.0 and math.isfinite(log_z),
    }


def precision(**anchor_kwargs) -> dict:
    """The anchor with every float32 dot in full precision."""
    import jax

    with jax.default_matmul_precision("highest"):
        return anchor(**anchor_kwargs)


def four_cards(
    n_samples: int = REALISTIC_N,
    n_steps: int = 20,
    n_train: int = 4000,
    n_epochs: int = 20,
) -> dict:
    """Anchor over a 4-device mesh vs one card; collective resamplers vs
    the GSPMD gather."""
    import jax

    from aspire_tpu.parallel.mesh import make_mesh
    from aspire_tpu.samples import SMCSamples

    mesh = make_mesh(4)
    asp, problem = _fitted_mixture(n_train, n_epochs)
    one, one_s = _smc(asp, n_samples, n_steps)
    four, first_s = _smc(asp, n_samples, n_steps, mesh=mesh)
    four, four_s = _smc(asp, n_samples, n_steps, mesh=mesh)
    spread = len(four.x.sharding.device_set)
    lz1, e1 = float(one.log_evidence), float(one.log_evidence_error)
    lz4, e4 = float(four.log_evidence), float(four.log_evidence_error)
    tol_pair = max(5.0 * math.hypot(e1, e4), 0.02)
    truth = problem.true_log_evidence

    sampler = asp.sampler
    x, log_q = asp.flow.sample_and_log_prob(n_samples, key=jax.random.key(1))
    samples = SMCSamples(
        x=sampler.shard_array(x),
        log_q=sampler.shard_array(log_q),
        beta=0.0,
        parameters=problem.parameters,
    )
    samples.log_prior = sampler.shard_array(
        sampler.evaluate_log_prior(samples.x)
    )
    samples.log_likelihood = sampler.shard_array(
        sampler.evaluate_log_likelihood(samples.x)
    )
    key = jax.random.key(11)
    base = samples.resample(1.0, key=key, impl="auto")
    identical, differing_rows = {}, {}
    for impl in ("ring", "alltoall"):
        out = samples.resample(1.0, key=key, impl=impl)
        diff = {
            f: int(
                np.sum(
                    np.asarray(getattr(out, f)).reshape(n_samples, -1)
                    != np.asarray(getattr(base, f)).reshape(n_samples, -1)
                )
            )
            for f in ("x", "log_likelihood", "log_prior", "log_q")
        }
        differing_rows[impl] = diff
        identical[impl] = (
            len(out.x.sharding.device_set) == 4 and not any(diff.values())
        )
    return {
        "n": n_samples,
        "devices_holding_particles": spread,
        "log_z_one": lz1,
        "log_z_one_err": e1,
        "log_z_four": lz4,
        "log_z_four_err": e4,
        "truth": truth,
        "tol_pair": tol_pair,
        "one_card_s": one_s,
        "four_first_call_s": first_s,
        "four_compiled_s": four_s,
        "resample_bit_identical": identical,
        "resample_differing_entries": differing_rows,
        "peak_bytes": peak_bytes(),
        "ok": spread == 4
        and abs(lz4 - lz1) < tol_pair
        and abs(lz4 - truth) < max(5.0 * e4, 0.02)
        and all(identical.values()),
    }


def _run_phase(name: str, fn, *args, **kwargs) -> bool:
    try:
        result = fn(*args, **kwargs)
    except Exception:  # noqa: BLE001 - report the phase, run the rest
        _say(f"[{name}] FAILED with an exception")
        traceback.print_exc()
        return False
    _say(f"[{name}] {'ok' if result['ok'] else 'FAILED'} {result}")
    return bool(result["ok"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four",
        action="store_true",
        help="run only the sharded path on four GPUs",
    )
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU found: JAX sees {devices}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"--four needs four GPUs, found {devices}", file=sys.stderr)
        return 2

    from aspire_tpu.profiling import card_line
    from aspire_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    _say(f"[card] devices={devices} kind={devices[0].device_kind} "
         f"count={len(devices)}")
    _say(f"[card] nvidia-smi: {card_line()}")

    if args.four:
        phases = [("four", four_cards)]
    else:
        phases = [
            ("parity sweep", kernel_sweep),
            ("parity d=4", kernel_parity),
            ("anchor", anchor),
            ("realistic d=32", realistic),
            ("precision highest", precision),
        ]
    ok = True
    for name, fn, *fn_args in phases:
        ok &= _run_phase(name, fn, *fn_args)
    if not ok:
        return 1
    dev = devices[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(devices),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
