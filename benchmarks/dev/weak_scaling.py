"""Weak-scaling proxy table: 1/2/4 controllers on the virtual CPU mesh.

Drives ``benchmarks/multihost.py --spawn N`` (real ``jax.distributed``
controller processes over a shared CPU mesh) at fixed
particles-per-device for every resampling collective schedule, and
writes ``chiprun_out/scaling_proxy.json`` + a markdown table.

PROXY CAVEAT (read before quoting numbers): this host has ONE physical
CPU core, so N controllers time-share it and per-process wall clock
grows ~Nx by construction. The honest proxy metric is therefore
**aggregate-throughput retention**: ``sum-of-work / wall`` at N
controllers divided by the 1-controller value. On a shared core,
perfect scaling (zero added communication/synchronization cost) shows
as retention ~1.0; a collective bottleneck shows as retention < 1.
Per-chip particles/s on real ICI pods is what BASELINE.md's >=80%
target refers to; this table makes that run turnkey and pre-measures
the collective overheads the virtual mesh CAN see.

Usage: python benchmarks/dev/weak_scaling.py [--quick]
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(__file__), "..", "..")
MULTIHOST = os.path.join(REPO, "benchmarks", "multihost.py")


def run_one(n_proc: int, impl: str, ppd: int, n_steps: int, reps: int):
    cmd = [
        sys.executable,
        MULTIHOST,
        "--spawn", str(n_proc),
        "--cpu-devices-per-proc", "2",
        "--particles-per-device", str(ppd),
        "--n-steps", str(n_steps),
        "--reps", str(reps),
        "--resampling-impl", impl,
        "--no-checkpoint-drill",
        "--no-pt-drill",
    ]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        cmd, capture_output=True, text=True, timeout=3600, env=env,
        cwd=REPO,
    )
    if out.returncode != 0:
        raise RuntimeError(
            f"spawn={n_proc} impl={impl} failed:\n{out.stdout[-3000:]}"
            f"\n{out.stderr[-2000:]}"
        )
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON from spawn={n_proc} impl={impl}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--ppd", type=int, default=4096)
    parser.add_argument("--n-steps", type=int, default=10)
    parser.add_argument(
        "--output",
        default=os.path.join(REPO, "chiprun_out", "scaling_proxy.json"),
    )
    args = parser.parse_args()
    reps = 1 if args.quick else 3
    procs = [1, 2] if args.quick else [1, 2, 4]
    impls = ["auto"] if args.quick else ["auto", "ring", "alltoall"]

    table = []
    for impl in impls:
        base_rate = None
        for n_proc in procs:
            r = run_one(n_proc, impl, args.ppd, args.n_steps, reps)
            # Aggregate throughput: particle-steps/s over the whole
            # mesh (multihost.py already reports the global rate).
            agg = r["particle_steps_per_s"]
            if n_proc == procs[0]:
                base_rate = agg
            row = {
                "impl": impl,
                "processes": n_proc,
                "devices": r["devices"],
                "particles": r["particles"],
                "iterations": r["iterations"],
                "wall_s": round(r["wall_s"], 3),
                "aggregate_particle_steps_per_s": agg,
                "ess_per_s": r["ess_per_s"],
                "retention_vs_1proc": round(agg / base_rate, 4),
                "log_z": round(r["log_z"], 4),
                "true_log_z": round(r["true_log_z"], 4),
            }
            table.append(row)
            print(json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(
            {
                "proxy": "single-core virtual CPU mesh; metric is "
                "aggregate-throughput retention (1.0 = no added "
                "communication/sync cost). See docstring caveat.",
                "particles_per_device": args.ppd,
                "n_steps": args.n_steps,
                "reps": reps,
                "rows": table,
            },
            f,
            indent=1,
        )
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
