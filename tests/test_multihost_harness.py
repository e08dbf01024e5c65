"""The turnkey multi-host harness runs end-to-end as 4 real
controllers over a shared virtual CPU mesh and produces the scaling
JSON (VERDICT r2 item 7: the first real pod run should measure, not
debug — this validates the launch path, the cross-process SMC, and the
shard-wise checkpoint drill without accelerator hardware)."""

import json
import os
import subprocess
import sys
from pathlib import Path

HARNESS = (
    Path(__file__).parent.parent / "benchmarks" / "multihost.py"
)


def test_four_process_harness(tmp_path):
    out_file = tmp_path / "scaling.json"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable,
            str(HARNESS),
            "--spawn", "4",
            "--cpu-devices-per-proc", "2",
            "--particles-per-device", "512",
            "--n-steps", "4",
            "--reps", "1",
            "--workdir", str(tmp_path),
            "--output", str(out_file),
        ],
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(out_file.read_text())
    assert result["processes"] == 4
    assert result["devices"] == 8
    assert result["particles"] == 4 * 512 * 2
    assert result["particle_steps_per_s"] > 0
    assert result["ess_per_s"] > 0
    assert result["checkpoint_drill"] == "ok"
    assert abs(result["log_z"] - result["true_log_z"]) < 1.0


def test_four_process_composed_config(tmp_path):
    """The pod configuration a real run would use — waste-free
    mutations + the explicit ring collective — launches through the
    same harness with flags only (no code changes)."""
    out_file = tmp_path / "scaling.json"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable,
            str(HARNESS),
            "--spawn", "4",
            "--cpu-devices-per-proc", "2",
            "--particles-per-device", "512",
            "--n-steps", "4",
            "--reps", "1",
            "--waste-free",
            "--resampling-impl", "ring",
            "--no-checkpoint-drill",
            "--workdir", str(tmp_path),
            "--output", str(out_file),
        ],
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(out_file.read_text())
    assert result["waste_free"] is True
    assert result["resampling_impl"] == "ring"
    assert result["processes"] == 4
    assert abs(result["log_z"] - result["true_log_z"]) < 1.0
