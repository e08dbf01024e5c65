"""Flow tests: invertibility, exact Jacobians, training, persistence."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aspire_tpu.flows import Flow, FlowMatching, get_flow_class
from aspire_tpu.flows.architectures import get_architecture
from aspire_tpu.flows.bijectors import (
    rational_quadratic_spline,
    standard_normal_log_prob,
)
from aspire_tpu.transforms import FlowTransform

ARCHS = ["maf", "nsf", "realnvp", "maf-rqs"]


@pytest.fixture(scope="module")
def key():
    return jax.random.key(7)


class TestBijectors:
    def test_rqs_roundtrip(self, key):
        d = 5
        x = jax.random.normal(key, (64, d)) * 2.0
        raw = jax.random.normal(jax.random.fold_in(key, 1), (64, d, 23)) * 0.5
        y, ld = rational_quadratic_spline(x, raw, num_bins=8, inverse=False)
        x2, ld_inv = rational_quadratic_spline(
            y, raw, num_bins=8, inverse=True
        )
        np.testing.assert_allclose(
            np.asarray(x2), np.asarray(x), atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(ld + ld_inv), 0.0, atol=1e-8
        )

    def test_rqs_jacobian_matches_autodiff(self, key):
        raw = jax.random.normal(key, (23,)) * 0.5

        def f(xi):
            y, _ = rational_quadratic_spline(
                xi[None], raw[None], num_bins=8, inverse=False
            )
            return y[0]

        for val in [-4.0, -0.5, 0.0, 1.3, 4.9]:
            xi = jnp.asarray(val)
            _, ld = rational_quadratic_spline(
                xi[None], raw[None], num_bins=8, inverse=False
            )
            deriv = jax.grad(f)(xi)
            assert float(ld[0]) == pytest.approx(
                float(jnp.log(jnp.abs(deriv))), abs=1e-6
            )

    def test_rqs_identity_outside_tails(self, key):
        x = jnp.asarray([[-10.0, 10.0, 7.5]])
        raw = jax.random.normal(key, (1, 3, 23))
        y, ld = rational_quadratic_spline(x, raw, num_bins=8, inverse=False)
        np.testing.assert_allclose(np.asarray(y), np.asarray(x))
        np.testing.assert_allclose(np.asarray(ld), 0.0)


class TestArchitectures:
    @pytest.mark.parametrize("arch_name", ARCHS)
    def test_roundtrip(self, key, arch_name):
        d = 4
        arch = get_architecture(
            arch_name, d, n_layers=2, n_hidden=(16,), dtype="float64"
        )
        params = arch.init(key)
        x = jax.random.normal(jax.random.fold_in(key, 2), (32, d)).astype(
            jnp.float64
        )
        z, ld_fwd = arch.forward(params, x)
        x2, ld_inv = arch.inverse(params, z)
        np.testing.assert_allclose(
            np.asarray(x2), np.asarray(x), atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(ld_fwd + ld_inv), 0.0, atol=1e-8
        )

    @pytest.mark.parametrize("arch_name", ARCHS)
    def test_log_det_matches_autodiff(self, key, arch_name):
        d = 3
        arch = get_architecture(
            arch_name, d, n_layers=2, n_hidden=(8,), dtype="float64"
        )
        # Perturb params away from identity init for a non-trivial check.
        params = arch.init(key)
        params = jax.tree_util.tree_map(
            lambda p: p
            + 0.1
            * jax.random.normal(key, p.shape).astype(p.dtype),
            params,
        )
        x = jax.random.normal(jax.random.fold_in(key, 3), (4, d)).astype(
            jnp.float64
        )

        def fwd_single(xi):
            z, _ = arch.forward(params, xi[None])
            return z[0]

        _, ld = arch.forward(params, x)
        for i in range(x.shape[0]):
            jac = jax.jacfwd(fwd_single)(x[i])
            _, expected = np.linalg.slogdet(np.asarray(jac))
            assert float(ld[i]) == pytest.approx(float(expected), abs=1e-7)

    def test_nsf_tpu_preset(self, key):
        """The compact NSF preset: 3 x (64,64) x 8 bins RQS coupling,
        overridable per kwarg, exact forward/inverse roundtrip."""
        arch = get_architecture("nsf-tpu", 4)
        assert (arch.n_layers, arch.n_hidden, arch.num_bins) == (
            3, (64, 64), 8,
        )
        assert arch.transformer == "rqs"
        # Explicit kwargs override the preset defaults.
        assert get_architecture("nsf-tpu", 4, n_layers=5).n_layers == 5
        params = arch.init(key)
        x = jax.random.normal(jax.random.fold_in(key, 9), (16, 4))
        z, ld = arch.forward(params, x)
        x2, ld_inv = arch.inverse(params, z)
        np.testing.assert_allclose(
            np.asarray(x2), np.asarray(x), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(ld + ld_inv), 0.0, atol=1e-5
        )

    def test_identity_at_init(self, key):
        """Zero-initialized output layers make the flow start near id."""
        d = 4
        arch = get_architecture("maf", d, n_layers=2, n_hidden=(8,))
        params = arch.init(key)
        x = jax.random.normal(jax.random.fold_in(key, 4), (8, d))
        z, ld = arch.forward(params, x)
        # Forward applies reverse permutations only.
        np.testing.assert_allclose(
            np.asarray(z), np.asarray(x), atol=1e-6
        )
        np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-6)


class TestFlow:
    def test_log_prob_shapes(self, key):
        flow = Flow(dims=3, architecture="maf", key=0)
        x = jax.random.normal(key, (10, 3))
        lp = flow.log_prob(x)
        assert lp.shape == (10,)

    def test_sample_and_log_prob_consistent(self, key):
        flow = Flow(dims=3, architecture="nsf", key=0, dtype="float64")
        x, log_q = flow.sample_and_log_prob(50, key=key)
        lp = flow.log_prob(x)
        np.testing.assert_allclose(
            np.asarray(lp), np.asarray(log_q), atol=1e-6
        )

    def test_fit_reduces_loss(self, key):
        rng = np.random.default_rng(0)
        data = rng.normal(2.0, 0.5, size=(1000, 2))
        flow = Flow(dims=2, architecture="maf", key=1, n_layers=2)
        history = flow.fit(
            data, n_epochs=20, batch_size=256, learning_rate=5e-3
        )
        assert history.training_loss[-1] < history.training_loss[0]

    def test_fit_accepts_reference_kwarg_spellings(self, key, caplog):
        """The reference trainer's knobs (lr, clip_grad, lr_annealing,
        patience=None; flows/torch/flows.py:170-180) stay live instead
        of being dropped with an 'unknown kwargs' warning."""
        import logging

        rng = np.random.default_rng(0)
        data = rng.normal(2.0, 0.5, size=(600, 2))
        flow = Flow(dims=2, architecture="maf", key=1, n_layers=2)
        with caplog.at_level(logging.WARNING, logger="aspire_tpu"):
            history = flow.fit(
                data,
                n_epochs=5,
                batch_size=256,
                lr=5e-3,
                clip_grad=2.0,
                lr_annealing=True,
                patience=None,
            )
        assert not any(
            "Ignoring unknown fit kwargs" in r.message for r in caplog.records
        )
        assert history.training_loss[-1] < history.training_loss[0]
        # clip_grad=None means "no clipping" in the reference — it must
        # not crash nor be forwarded as an invalid None norm.
        flow.fit(data, n_epochs=2, batch_size=256, clip_grad=None)
        with pytest.raises(ValueError, match="Conflicting fit kwargs"):
            flow.fit(data, n_epochs=2, lr=1e-3, learning_rate=2e-3)

    def test_fit_learns_gaussian(self, key):
        rng = np.random.default_rng(0)
        data = rng.normal(1.0, 0.5, size=(4000, 2))
        flow = Flow(dims=2, architecture="maf", key=1)
        flow.fit(data, n_epochs=60, batch_size=512, learning_rate=5e-3)
        samples = np.asarray(flow.sample(4000, key=key))
        assert np.mean(samples) == pytest.approx(1.0, abs=0.15)
        assert np.std(samples) == pytest.approx(0.5, abs=0.15)

    def test_fit_with_data_transform(self, key):
        rng = np.random.default_rng(0)
        data = rng.uniform(0, 1, size=(800, 2))
        transform = FlowTransform(
            parameters=["a", "b"],
            prior_bounds={"a": [0, 1], "b": [0, 1]},
            bounded_transform="logit",
        )
        flow = Flow(dims=2, architecture="maf", data_transform=transform)
        flow.fit(data, n_epochs=10)
        samples = np.asarray(flow.sample(100, key=key))
        assert np.all(samples >= 0) and np.all(samples <= 1)
        lp = flow.log_prob(data[:10])
        assert np.all(np.isfinite(np.asarray(lp)))

    def test_nan_data_raises(self):
        data = np.full((100, 2), np.nan)
        flow = Flow(dims=2)
        with pytest.raises(ValueError, match="NaN"):
            flow.fit(data, n_epochs=1)

    def test_save_load_roundtrip(self, key, tmp_path):
        rng = np.random.default_rng(0)
        data = rng.normal(size=(500, 2))
        flow = Flow(dims=2, architecture="nsf", key=3, n_layers=2)
        flow.fit(data, n_epochs=3)
        x = rng.normal(size=(20, 2))
        lp_before = np.asarray(flow.log_prob(x))
        with h5py.File(tmp_path / "flow.h5", "w") as f:
            flow.save(f, "flow")
        with h5py.File(tmp_path / "flow.h5", "r") as f:
            flow2 = Flow.load(f, "flow")
        lp_after = np.asarray(flow2.log_prob(x))
        np.testing.assert_allclose(lp_after, lp_before, rtol=1e-6)


class TestFactory:
    def test_known_backends(self):
        assert get_flow_class("maf") is Flow
        assert get_flow_class("flowjax") is Flow
        assert get_flow_class("cnf") is FlowMatching
        assert get_flow_class("maf", flow_matching=True) is FlowMatching

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="Unknown flow backend"):
            get_flow_class("not-a-backend")


class TestFlowMatching:
    def test_sample_log_prob_consistency(self, key):
        fm = FlowMatching(dims=2, key=0, n_hidden=(32,), n_steps=16)
        x, log_q = fm.sample_and_log_prob(20, key=key)
        lp = fm.log_prob(x)
        # ODE integration error dominates; loose tolerance.
        np.testing.assert_allclose(
            np.asarray(lp), np.asarray(log_q), atol=1e-2
        )

    def test_fit_runs(self):
        rng = np.random.default_rng(0)
        data = rng.normal(1.0, 0.5, size=(500, 2))
        fm = FlowMatching(dims=2, key=0, n_hidden=(32,), n_steps=8)
        history = fm.fit(data, n_epochs=5, batch_size=128)
        assert len(history.training_loss) == 5

    def test_identity_init_log_prob_is_normal(self, key):
        """At init the velocity is 0, so q == N(0, I)."""
        fm = FlowMatching(dims=2, key=0, n_hidden=(16,), n_steps=8)
        x = jax.random.normal(key, (10, 2))
        lp = fm.log_prob(x)
        expected = standard_normal_log_prob(x)
        np.testing.assert_allclose(
            np.asarray(lp), np.asarray(expected), atol=1e-5
        )

    def test_save_load_roundtrip(self, key, tmp_path):
        import h5py
        import jax.numpy as jnp

        fm = FlowMatching(dims=2, key=1, n_hidden=(16,), n_steps=8)
        x = jax.random.normal(key, (64, 2), jnp.float32)
        lp = fm.log_prob(x)
        path = tmp_path / "fm.h5"
        with h5py.File(path, "w") as f:
            fm.save(f)
        with h5py.File(path, "r") as f:
            fm2 = FlowMatching.load(f)
        np.testing.assert_allclose(
            np.asarray(fm2.log_prob(x)), np.asarray(lp), rtol=1e-5
        )
