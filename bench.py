"""Benchmark: tempered-SMC mutation throughput on one NVIDIA GPU.

Prints ONE JSON line on stdout:
  {"metric": "smc_particle_steps_per_s", "value": N, "unit":
   "particle-steps/s", "device": {...}, ...}

The workload is the SMC hot loop: tpCN mutation chains over a
device-resident (n, d) particle array, each step evaluating the flow
density plus the tempered target, compiled by XLA as one program. Also
runs the end-to-end logZ anchor (two-Gaussian mixture, analytic
evidence) and reports it on stderr and in the record.

    python bench.py

Fails when JAX finds no GPU: a CPU number is not a measurement of the
card.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


# The benchmarked flow configuration (the compact NSF preset).
BENCH_FLOW_KWARGS = {"architecture": "nsf-tpu", "key": 0}

# Published peaks per device, keyed by ``jax.devices()[0].device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
# (no sparsity) at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 data sheet (SXM5, dense)",
        "tflops": {"bf16": 989.0, "tf32": 495.0, "f32": 67.0},
        "hbm_gbs": 3350.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peak table entry for ``device_kind``; an unknown device raises."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind={device_kind!r}; add the "
            "device's data-sheet rates to bench.PEAKS"
        ) from None


def chain_dot_precision() -> str:
    """Precision the flow's float32 dots run at on the GPU.

    XLA's and the coupling kernel's dots follow JAX's default matmul
    precision: TF32 unless ``"highest"`` (or ``"float32"``) is set.
    """
    import jax

    setting = jax.config.jax_default_matmul_precision
    return "f32" if setting in ("highest", "float32") else "tf32"


def device_record() -> dict:
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def build_workload(
    n_particles: int,
    dims: int = 4,
    n_steps: int = 20,
    flow_kwargs: dict | None = None,
    prng_impl: str | None = None,
):
    import jax
    import jax.numpy as jnp

    from aspire_tpu.flows import Flow
    from aspire_tpu.flows.bijectors import standard_normal_log_prob
    from aspire_tpu.models import GaussianMixtureProblem
    from aspire_tpu.samplers import kernels as K

    problem = GaussianMixtureProblem(dims=dims)
    flow = Flow(dims=dims, **(flow_kwargs or BENCH_FLOW_KWARGS))
    arch = flow.architecture
    data_transform = flow.data_transform
    # Perturb away from the zero-init identity so the benchmark exercises
    # a realistic trained flow (identity-flow timings are unrepresentative).
    flow.params = jax.tree.map(
        lambda p: p
        + 0.1 * jax.random.normal(jax.random.key(7), p.shape, p.dtype),
        flow.params,
    )

    class _View:
        __slots__ = ("x",)

    def tempered(params, x, beta):
        x_t, log_j = data_transform.forward(x)
        z, log_det = arch.forward(params, x_t)
        log_q = standard_normal_log_prob(z) + log_det + log_j
        view = _View()
        view.x = x
        log_l = problem.log_likelihood(view)
        log_pi = problem.log_prior(view)
        log_p = (1 - beta) * log_q + beta * (log_l + log_pi)
        return jnp.where(jnp.isnan(log_p), -jnp.inf, log_p)

    @partial(jax.jit, static_argnames=("n_steps",))
    def mutate(params, x, beta, key, n_steps):
        log_prob_fn = lambda z: tempered(params, z, beta)  # noqa: E731
        ref = K.fit_gaussian_reference(x)
        step = partial(K.tpcn_step, log_prob_fn=log_prob_fn, ref=ref)
        state = K.ChainState(
            x=x,
            log_prob=log_prob_fn(x),
            key=key,
            step_size=jnp.asarray(0.5, dtype=x.dtype),
            n_accept=jnp.zeros(x.shape[0], dtype=x.dtype),
        )
        final, _ = K.run_chain(step, state, n_steps)
        return final.x, final.log_prob

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n_particles, dims)), dtype=jnp.float32)
    key = (
        jax.random.key(1)
        if prng_impl is None
        else jax.random.key(1, impl=prng_impl)
    )
    beta = jnp.asarray(0.5, dtype=jnp.float32)
    return mutate, flow.params, x, beta, key, n_steps


def measure_rate(
    n_particles: int,
    n_steps: int = 200,
    reps: int = 5,
    dims: int = 4,
    flow_kwargs: dict | None = None,
    prng_impl: str | None = None,
) -> float:
    """Median mutation throughput in particle-steps/s.

    Each timed call runs an ``n_steps``-step chain inside one jitted
    program and ends in ``block_until_ready``; the first call compiles
    and is not timed.
    """
    import jax

    mutate, params, x, beta, key, n_steps = build_workload(
        n_particles,
        dims=dims,
        n_steps=n_steps,
        flow_kwargs=flow_kwargs,
        prng_impl=prng_impl,
    )
    out = jax.block_until_ready(mutate(params, x, beta, key, n_steps=n_steps))
    times = []
    for i in range(reps):
        key = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            mutate(params, out[0], beta, key, n_steps=n_steps)
        )
        times.append(time.perf_counter() - t0)
    return n_particles * n_steps / float(np.median(times))


def roofline_model(
    n_particles: int, dims: int = 4, flow_kwargs: dict | None = None
) -> dict:
    """Analytic FLOPs and device-memory bytes per particle-step.

    Every flow weight matrix ``(a, b)`` contributes ``2ab`` FLOPs per
    particle per density evaluation, one evaluation per tpCN step, plus
    small-term estimates for the spline search, the proposal and the
    target. Bytes: the chain state (positions, proposal, densities) is
    read and written once per step, and the flow parameters once per
    step, amortised over the batch. Activations are not counted, so the
    byte figure is the fused lower bound.
    """
    import jax

    from aspire_tpu.flows import Flow

    flow = Flow(dims=dims, **(flow_kwargs or BENCH_FLOW_KWARGS))
    matmul_flops = 0
    param_bytes = 0
    for leaf in jax.tree_util.tree_leaves(flow.params):
        param_bytes += leaf.size * leaf.dtype.itemsize
        if leaf.ndim == 2:
            matmul_flops += 2 * leaf.shape[0] * leaf.shape[1]
    spline_flops = dims * (3 * 8 + 30)  # bin search + RQ evaluation
    proposal_flops = 4 * dims * dims + 16 * dims + 60  # tpCN + target
    flops_per_ps = matmul_flops + spline_flops + proposal_flops

    state_bytes = 2 * 4 * (2 * dims + 4)  # r/w: x, proposal, densities
    bytes_per_ps = state_bytes + param_bytes / n_particles
    return {
        "flops_per_particle_step": float(flops_per_ps),
        "bytes_per_particle_step": float(bytes_per_ps),
    }


def roofline_report(rate: float, model: dict, peaks: dict, precision: str):
    """Achieved rates and their share of the peaks of ``precision``."""
    tflops = rate * model["flops_per_particle_step"] / 1e12
    gbs = rate * model["bytes_per_particle_step"] / 1e9
    pct_compute = tflops / peaks["tflops"][precision]
    pct_hbm = gbs / peaks["hbm_gbs"]
    return {
        "achieved_tflops": tflops,
        "achieved_hbm_gbs": gbs,
        "dot_precision": precision,
        "pct_of_compute_peak": pct_compute,
        "pct_of_hbm_peak": pct_hbm,
        "binding_ceiling": "compute" if pct_compute >= pct_hbm else "HBM",
        "model_pct_of_roofline": max(pct_compute, pct_hbm),
        "peaks_source": peaks["source"],
    }


def correctness_anchor(n_samples: int = 131072, repeats: int = 3) -> dict:
    """Fit on the mixture, run SMC on the compiled device ladder, and
    compare logZ with the analytic evidence. Also times the repeat-call
    pipeline (compiled programs are cached across calls)."""
    import jax

    from aspire_tpu import Aspire, Samples
    from aspire_tpu.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=4)
    rng = np.random.default_rng(42)
    init = Samples(p.draw_initial_samples(rng, 4000))
    asp = Aspire(
        log_likelihood=p.log_likelihood,
        log_prior=p.log_prior,
        dims=4,
        parameters=p.parameters,
        flow_backend="nsf",
        architecture="nsf-tpu",
        seed=1,
    )
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    pipeline = dict(
        sampler="smc",
        n_samples=n_samples,
        store_sample_history=False,
        device_ladder=True,
        sampler_kwargs=dict(n_steps=20),
    )
    samples = asp.sample_posterior(**pipeline)  # compile
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(asp.sample_posterior(**pipeline).x)
        walls.append(time.perf_counter() - t0)
    log_z = float(samples.log_evidence)
    log_z_err = float(samples.log_evidence_error)
    truth = p.true_log_evidence
    tol = max(5.0 * log_z_err, 0.02)
    return {
        "log_z": log_z,
        "log_z_err": log_z_err,
        "true_log_z": truth,
        "tol": tol,
        "ok": bool(abs(log_z - truth) < tol),
        "pipeline_s": float(np.median(walls)),
    }


def main():
    import jax

    from aspire_tpu.profiling import card_line
    from aspire_tpu.utils import enable_compilation_cache

    device = device_record()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {jax.devices()}")
    enable_compilation_cache()
    card = card_line()
    peaks = device_peaks(device["kind"])
    _log(f"bench device: {device}; card: {card}")

    n_particles, n_steps = 131072, 500
    rate = measure_rate(n_particles=n_particles, n_steps=n_steps, reps=5)
    _log(f"mutation rate: {rate!r} particle-steps/s @ n={n_particles}")
    rate_rbg = measure_rate(
        n_particles=n_particles, n_steps=n_steps, reps=3, prng_impl="rbg"
    )
    _log(f"rbg opt-in rate: {rate_rbg!r} particle-steps/s")

    from aspire_tpu.ops.fused_coupling import use_kernel
    from aspire_tpu.flows import Flow

    arch = Flow(dims=4, **BENCH_FLOW_KWARGS).architecture
    kernel_used = use_kernel(
        arch, jax.numpy.zeros((n_particles, 4), jax.numpy.float32)
    )
    model = roofline_model(n_particles)
    roofline = roofline_report(
        rate, model, peaks, chain_dot_precision()
    )
    _log(f"roofline: {roofline}")

    anchor = correctness_anchor()
    _log(f"correctness anchor: {anchor}")

    record = {
        "metric": "smc_particle_steps_per_s",
        "value": rate,
        "unit": "particle-steps/s",
        "device": device,
        "card": card,
        "coupling_kernel": kernel_used,
        "model_pct_of_roofline": roofline["model_pct_of_roofline"],
        "roofline_binding_ceiling": roofline["binding_ceiling"],
        "dot_precision": roofline["dot_precision"],
        "flops_per_particle_step": model["flops_per_particle_step"],
        "bytes_per_particle_step": model["bytes_per_particle_step"],
        "pipeline_131072_s": anchor["pipeline_s"],
        "rbg_opt_in_rate": rate_rbg,
        "anchor_ok": anchor["ok"],
    }
    print(json.dumps(record))
    if not anchor["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
