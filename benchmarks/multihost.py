"""Turnkey multi-host harness: weak scaling + sharded-checkpoint drill.

One script, no code changes between environments — the first real
multi-host run should measure, not debug. Every host runs the SAME
command, one process per host driving all of that host's GPUs; the
script initializes ``jax.distributed``, builds the global mesh, runs a
fixed sharded SMC workload (timed), exercises the shard-wise
checkpoint/resume drill across processes, validates logZ against the
analytic evidence, and process 0 emits ONE JSON line.

Real cluster — run on every host (coordinator = host 0's address):

    python benchmarks/multihost.py \
        --coordinator 10.0.0.1:9876 --num-processes 4 --process-id $I \
        --particles-per-device 16384

Cluster managers that ``jax.distributed.initialize()`` recognises (for
example SLURM) can auto-detect everything:

    python benchmarks/multihost.py --auto

``--spawn N`` is a CPU-only rehearsal of the multi-controller structure
on one machine (N controllers x 2 virtual CPU devices; exercised by
tests/test_multihost_harness.py). It never opens a GPU: one process per
card is the rule there, and one process drives all cards of a host.

    python benchmarks/multihost.py --spawn 4 --cpu-devices-per-proc 2
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TRUE_LOG_Z_FMT = "analytic evidence of the harness problem"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args) -> int:
    """Launcher: run N copies of this script as local controllers."""
    port = _free_port()
    cmd_base = [
        sys.executable,
        os.path.abspath(__file__),
        "--coordinator", f"localhost:{port}",
        "--num-processes", str(args.spawn),
        "--cpu-devices-per-proc", str(args.cpu_devices_per_proc or 2),
        "--particles-per-device", str(args.particles_per_device),
        "--n-steps", str(args.n_steps),
        "--dims", str(args.dims),
        "--reps", str(args.reps),
        "--resampling-impl", args.resampling_impl,
    ]
    if args.waste_free:
        cmd_base += ["--waste-free"]
    if args.output:
        cmd_base += ["--output", args.output]
    import tempfile

    cmd_base += ["--workdir", args.workdir or tempfile.mkdtemp()]
    if not args.checkpoint_drill:
        cmd_base += ["--no-checkpoint-drill"]
    if not args.pt_drill:
        cmd_base += ["--no-pt-drill"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            cmd_base + ["--process-id", str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(args.spawn)
    ]
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0 or f"proc {i} OK" not in out:
            ok = False
            print(f"--- process {i} FAILED ---\n{out}", file=sys.stderr)
        elif i == 0:
            # Forward process 0's JSON result line.
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line)
    return 0 if ok else 1


def worker(args) -> int:
    import jax

    if args.cpu_devices_per_proc:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update(
            "jax_num_cpu_devices", args.cpu_devices_per_proc
        )
    else:
        # No persistent cache for the CPU rehearsal: serializing the
        # collective resamplers' CPU executables has crashed jaxlib.
        from aspire_tpu.utils import enable_compilation_cache

        enable_compilation_cache()
    if args.auto:
        jax.distributed.initialize()
    elif args.num_processes and args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import numpy as np

    from aspire_tpu import configure_logger
    from aspire_tpu.flows import Flow
    from aspire_tpu.io import checkpoint_barrier
    from aspire_tpu.models import GaussianMixtureProblem
    from aspire_tpu.parallel.mesh import make_mesh
    from aspire_tpu.samplers import PCNSMC

    configure_logger("WARNING")
    pid = jax.process_index()
    n_proc = jax.process_count()
    mesh = make_mesh()
    n_dev = mesh.devices.size
    n = args.particles_per_device * n_dev
    dims = args.dims

    problem = GaussianMixtureProblem(dims=dims)
    rng = np.random.default_rng(7)  # identical data on every process
    flow = Flow(dims=dims, architecture="nsf", key=0, n_layers=4)
    flow.fit(
        problem.draw_initial_samples(rng, 4096),
        n_epochs=15,
        batch_size=512,
    )

    def make_sampler():
        return PCNSMC(
            log_likelihood=problem.log_likelihood,
            log_prior=problem.log_prior,
            dims=dims,
            prior_flow=flow,
            parameters=problem.parameters,
            rng=jax.random.key(11),
            mesh=mesh,
            resampling_impl=args.resampling_impl,
        )

    if args.waste_free and n % args.n_steps:
        raise SystemExit(
            f"--waste-free needs particles ({n}) divisible by "
            f"--n-steps ({args.n_steps})"
        )

    # -- timed weak-scaling workload (compile once, time the repeat) ---
    sampler = make_sampler()
    mutation_kwargs = {"n_steps": args.n_steps}
    if args.waste_free:
        mutation_kwargs["waste_free"] = True
    run_kwargs = dict(
        sampler_kwargs=mutation_kwargs,
        store_sample_history=False,
        # Auto-select takes the single-dispatch compiled ladder at any
        # controller count (round 4: the multi-controller compiled
        # ladder is proven by tests/workers/mp_ladder_worker.py, and
        # per-iteration checkpoints now chunk with shard-local writes).
        device_ladder=None,
    )
    out = sampler.sample(n, **run_kwargs)
    walls, iters = [], 0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = sampler.sample(n, **run_kwargs)
        walls.append(time.perf_counter() - t0)
        iters = len(sampler.history.beta)
    wall = sorted(walls)[len(walls) // 2]
    # Waste-free runs M = n/k chains for k steps: n chain-steps per
    # rung instead of the standard n * k.
    steps_per_iter = n if args.waste_free else n * args.n_steps
    rate = steps_per_iter * iters / wall
    ess_rate = float(np.sum(sampler.history.ess)) / wall

    # -- sharded checkpoint / resume drill across processes ------------
    drill = "skipped"
    if args.checkpoint_drill:
        path = os.path.join(args.workdir or ".", "multihost_ckpt.h5")
        first = make_sampler()
        first.sample(
            n,
            max_n_steps=2,
            sampler_kwargs={"n_steps": args.n_steps},
            checkpoint_every=1,
            checkpoint_file_path=path,
            device_ladder=False,
        )
        prefix = list(first.history.beta)
        checkpoint_barrier("multihost-after-first-leg")
        fresh = make_sampler()
        resumed = fresh.sample(
            n,
            resume_from=path,
            sampler_kwargs={"n_steps": args.n_steps},
            device_ladder=False,
        )
        assert fresh.history.beta[: len(prefix)] == prefix
        assert fresh.history.beta[-1] == 1.0
        assert np.isfinite(float(resumed.log_evidence))
        checkpoint_barrier("multihost-drill-done")
        drill = "ok"

    # -- sharded parallel-tempering drill ------------------------------
    # Walker axis P(None, 'data') across every process; the evidence
    # estimators run on the process_allgather'ed chain. Small fixed
    # shapes: this validates the multi-controller PT path end-to-end,
    # not its throughput.
    pt_drill = "skipped"
    pt_log_z = None
    if args.pt_drill:
        from aspire_tpu.samplers import ParallelTemperedSampler

        pt = ParallelTemperedSampler(
            log_likelihood=problem.log_likelihood,
            log_prior=problem.log_prior,
            dims=dims,
            prior_flow=flow,
            parameters=problem.parameters,
            rng=jax.random.key(13),
            mesh=mesh,
        )
        pt_post = pt.sample(
            max(8 * n_dev, 16),
            n_steps=12,
            n_temperatures=4,
            swap_every=4,
        )
        pt_log_z, pt_err = pt_post.log_evidence_stepping_stone()
        assert np.isfinite(pt_log_z), "PT stepping-stone logZ not finite"
        assert pt_post.swap_acceptance.shape == (3,)
        checkpoint_barrier("multihost-pt-drill-done")
        pt_drill = "ok"

    def comp(mu, var):
        return (
            -0.5 * dims * np.log(2 * np.pi * (1 + var))
            - 0.5 * mu @ mu / (1 + var)
        )

    true = float(
        np.logaddexp(
            comp(problem.mu1, problem.var1),
            comp(problem.mu2, problem.var2),
        )
        - np.log(2.0)
    )
    result = {
        "processes": n_proc,
        "devices": int(n_dev),
        "particles": int(n),
        "mutation_steps": args.n_steps,
        "waste_free": bool(args.waste_free),
        "resampling_impl": args.resampling_impl,
        "iterations": iters,
        "wall_s": wall,
        "particle_steps_per_s": rate,
        "ess_per_s": ess_rate,
        "log_z": float(out.log_evidence),
        "log_z_err": float(out.log_evidence_error),
        "true_log_z": true,
        "checkpoint_drill": drill,
        "pt_drill": pt_drill,
        "pt_log_z": (
            float(pt_log_z) if pt_log_z is not None else None
        ),
    }
    if pid == 0:
        line = json.dumps(result)
        print(line, flush=True)
        if args.output:
            with open(args.output, "w") as f:
                f.write(line + "\n")
    # logZ sanity: generous bound — this is a scaling harness, the
    # statistical gates live in validate.py.
    assert abs(result["log_z"] - true) < max(
        8 * result["log_z_err"], 0.5
    ), result
    print(f"proc {pid} OK", flush=True)
    return 0


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--spawn", type=int, default=0,
                        help="launcher mode: spawn N local controllers")
    parser.add_argument("--auto", action="store_true",
                        help="jax.distributed.initialize() auto-detect "
                             "(cluster managers JAX recognises)")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--cpu-devices-per-proc", type=int, default=0)
    parser.add_argument("--particles-per-device", type=int, default=4096)
    parser.add_argument("--n-steps", type=int, default=10)
    parser.add_argument("--dims", type=int, default=4)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument(
        "--resampling-impl",
        choices=("auto", "ring", "alltoall"),
        default="auto",
        help="resampling collective schedule (pod runs typically want "
        "'ring' or 'alltoall' for the pinned explicit collectives)",
    )
    parser.add_argument(
        "--waste-free",
        action="store_true",
        help="Dau & Chopin waste-free mutations (requires "
        "particles %% n_steps == 0 and n/n_steps tiling the mesh)",
    )
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--no-checkpoint-drill", dest="checkpoint_drill",
                        action="store_false")
    parser.add_argument("--no-pt-drill", dest="pt_drill",
                        action="store_false",
                        help="skip the sharded parallel-tempering "
                        "validation leg")
    args = parser.parse_args()
    if args.spawn:
        sys.exit(spawn(args))
    sys.exit(worker(args))


if __name__ == "__main__":
    main()
