"""Entry points and installation: chip_smoke.py's phases at tiny sizes,
bench.py's device rules, the compile-cache helper, and the main path
without h5py.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _python(code, env_extra=None, cwd=REPO, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=env,
        cwd=cwd,
        timeout=timeout,
    )


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

TINY_MIXTURE = dict(n_train=500, n_epochs=2, n_samples=512, n_steps=4)


@pytest.mark.parametrize(
    "phase,kwargs",
    [
        ("anchor", dict(TINY_MIXTURE, repeats=1)),
        ("precision", dict(TINY_MIXTURE, repeats=1)),
        (
            "realistic",
            dict(dims=6, n_samples=512, n_steps=4, n_epochs=2, n_train=512,
                 flow_kwargs=dict(n_layers=2, n_hidden=(16, 16))),
        ),
        ("four_cards", TINY_MIXTURE),
    ],
)
def test_smoke_phase_runs_at_tiny_size(phase, kwargs):
    result = getattr(chip_smoke, phase)(**kwargs)
    assert result["ok"], result
    json.dumps(result)  # every phase result prints as one JSON-able line


def test_smoke_kernel_parity_in_interpret_mode():
    result = chip_smoke.kernel_parity(
        n=256, n_train=500, n_epochs=2, interpret=True
    )
    assert result["ok"], result
    # Same arithmetic as XLA up to float32 rounding.
    assert result["kernel_vs_f64"]["max_rel_dz"] < 1e-4


@pytest.mark.parametrize(
    "flow", chip_smoke.SWEEP_FLOWS, ids=lambda f: str(sorted(f.items()))
)
def test_smoke_kernel_sweep_in_interpret_mode(flow):
    result = chip_smoke.kernel_sweep(n=128, flows=(flow,), interpret=True)
    assert result["ok"], result


def test_smoke_sweep_covers_the_kernel_domain():
    """Every value of every axis the kernel is chosen for is in the
    sweep, so a compiled run of the sweep checks the whole domain."""
    from aspire_tpu.flows.architectures import Coupling
    from aspire_tpu.ops import fused_coupling as FC

    flows = [Coupling(**f) for f in chip_smoke.SWEEP_FLOWS]
    assert all(FC.supported(a) for a in flows)
    assert {(a.dims, a.transformer) for a in flows} == {
        (d, t)
        for d in range(FC._MIN_DIMS, FC._MAX_DIMS + 1)
        for t in ("affine", "rqs")
    }
    assert {a.n_layers for a in flows} >= {1, FC._MAX_LAYERS}
    assert {len(a.n_hidden) for a in flows} == set(
        range(1, FC._MAX_HIDDEN_LAYERS + 1)
    )
    assert {h for a in flows for h in a.n_hidden} == set(FC._HIDDEN_WIDTHS)
    assert {a.num_bins for a in flows if a.transformer == "rqs"} == set(
        FC._NUM_BINS
    )


def test_smoke_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


def test_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Copied out of the repository it must fail, not report success."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True,
        text=True,
        cwd=tmp_path,
        env=env,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# bench.py
# ---------------------------------------------------------------------------


def test_bench_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)


def test_peak_table_raises_on_unknown_device():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("NVIDIA A100-SXM4-80GB")


def test_peak_table_holds_the_h100_data_sheet():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["tflops"] == {"bf16": 989.0, "tf32": 495.0, "f32": 67.0}
    assert peaks["hbm_gbs"] == 3350.0


@pytest.mark.parametrize("setting,expected", [(None, "tf32"),
                                              ("highest", "f32")])
def test_roofline_uses_the_peak_of_the_chain_precision(setting, expected):
    import jax

    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    model = {"flops_per_particle_step": 1e4, "bytes_per_particle_step": 64.0}
    with jax.default_matmul_precision(setting):
        precision = bench.chain_dot_precision()
    assert precision == expected
    report = bench.roofline_report(1e9, model, peaks, precision)
    assert report["pct_of_compute_peak"] == pytest.approx(
        10.0 / peaks["tflops"][expected]
    )
    assert report["pct_of_hbm_peak"] == pytest.approx(64.0 / 3350.0)


# ---------------------------------------------------------------------------
# Compile cache and installation
# ---------------------------------------------------------------------------

_CACHE_PROBE = (
    "import jax; from aspire_tpu.utils import enable_compilation_cache; "
    "print(enable_compilation_cache()); "
    "print(jax.config.jax_compilation_cache_dir)"
)


def test_compilation_cache_honours_the_environment(tmp_path):
    out = _python(
        _CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    )
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    assert returned == configured == str(tmp_path)


def test_compilation_cache_defaults_to_the_checkout():
    out = _python(_CACHE_PROBE)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    assert returned == configured == os.path.join(REPO, ".jax_cache")


def test_main_path_runs_without_h5py():
    code = """
import sys

class Hide:
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "h5py":
            raise ImportError("h5py hidden")

sys.meta_path.insert(0, Hide())
from aspire_tpu import Aspire, Samples
from aspire_tpu.models import GaussianMixtureProblem
import numpy as np

p = GaussianMixtureProblem(dims=2)
asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
             dims=2, flow_backend="nsf", seed=0)
asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 256)),
        n_epochs=2)
post = asp.sample_posterior(sampler="smc", n_samples=256,
                            sampler_kwargs=dict(n_steps=2))
assert np.isfinite(float(post.log_evidence))
assert "h5py" not in sys.modules
try:
    from aspire_tpu.io import AspireFile
    AspireFile("never-written.h5", "w")
except ImportError as err:
    print("checkpoint:", err)
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert "checkpoint: HDF5 files" in out.stdout
    assert not os.path.exists(os.path.join(REPO, "never-written.h5"))


def test_true_log_evidence_of_the_mixture():
    """Closed form against quadrature of prior x likelihood (d=2)."""
    from aspire_tpu.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=2)
    g = np.linspace(-12, 12, 1201)
    X, Y = np.meshgrid(g, g, indexing="ij")

    class _View:
        x = np.stack([X.ravel(), Y.ravel()], axis=1)

    log_f = np.asarray(p.log_likelihood(_View)) + np.asarray(
        p.log_prior(_View)
    )
    dx = g[1] - g[0]
    quad = np.log(np.sum(np.exp(log_f)) * dx * dx)
    assert p.true_log_evidence == pytest.approx(quad, abs=1e-6)
