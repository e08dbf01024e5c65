"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-chip sharding paths are
exercised without accelerator hardware (mirrors how the reference
parametrizes one suite over backends; SURVEY.md §4). x64 is enabled for
tight statistical parity checks (the reference relies on float64 for logZ
parity). Tests marked ``gpu`` run their GPU work in a child process that
sees the card; they skip where JAX finds no GPU.
"""

import os
import subprocess
import sys

import jax

# Force CPU with 8 virtual devices. jax may already be imported by the
# time this runs, so the config API is used instead of env vars.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# NO persistent compilation cache. Two distinct jaxlib crashes were
# observed with one enabled on this stack: (a) XLA:CPU AOT
# executables are machine-feature-specialized, so a cache written by a
# different host SIGSEGVs in get_executable_and_time on load; (b) the
# explicit-collective resamplers' 8-device executables intermittently
# SIGSEGV in put_executable_and_time while SERIALIZING — and the cache
# cannot be disabled per-module once initialized (jax latches it at
# first use). Determinism beats repeat-run compile savings here.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.key(42)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_on_gpu(code: str, timeout: float = 900) -> str:
    """Run ``code`` in a child Python that may use the GPU; its stdout."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=REPO,
    )
    if out.returncode:
        raise RuntimeError(f"GPU child failed:\n{out.stderr[-4000:]}")
    return out.stdout


@pytest.fixture(scope="session")
def gpu():
    """Skip unless a child process finds a GPU (this process is CPU-only).

    Decided here, at fixture time, never at import or collection, so every
    test worker collects the same tests.
    """
    try:
        platform = run_on_gpu(
            "import jax; print(jax.devices()[0].platform)", timeout=300
        ).strip().splitlines()[-1]
    except (RuntimeError, subprocess.SubprocessError, IndexError) as err:
        pytest.skip(f"no GPU: {err}")
    if platform != "gpu":
        pytest.skip(f"no GPU: JAX's default platform is {platform}")
    return run_on_gpu


@pytest.fixture(params=["float32", "float64", None])
def dtype(request):
    return request.param
