"""MCMC kernel correctness: invariance of the target distribution.

Each kernel is run on a known Gaussian target; the chain's stationary
moments must match. These are the internalized equivalents of the
reference's external kernels (minipcn/emcee/blackjax; SURVEY.md §2.3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from functools import partial

from aspire_tpu.samplers import kernels as K

TARGET_MEAN = jnp.asarray([1.0, -0.5])
TARGET_STD = jnp.asarray([1.0, 2.0])


def log_prob_fn(x):
    return jnp.sum(
        -0.5 * ((x - TARGET_MEAN) / TARGET_STD) ** 2, axis=-1
    )


def lp_and_grad(x):
    def total(x):
        lp = log_prob_fn(x)
        return jnp.sum(lp), lp

    (_, lp), g = jax.value_and_grad(total, has_aux=True)(x)
    return lp, g


def init_state(key, n=512, d=2, step=0.5, with_grad=False):
    x = jax.random.normal(key, (n, d))
    lp = log_prob_fn(x)
    grad = lp_and_grad(x)[1] if with_grad else None
    return K.ChainState(
        x=x,
        log_prob=lp,
        key=jax.random.fold_in(key, 1),
        step_size=jnp.asarray(step),
        n_accept=jnp.zeros(n),
        grad=grad,
    )


def run(step_fn, state, n_steps=400):
    final, _ = jax.jit(
        lambda s: K.run_chain(step_fn, s, n_steps)
    )(state)
    return final


def check_moments(final, mean_tol=0.25, std_tol=0.3):
    x = np.asarray(final.x)
    np.testing.assert_allclose(
        x.mean(0), np.asarray(TARGET_MEAN), atol=mean_tol
    )
    np.testing.assert_allclose(
        x.std(0), np.asarray(TARGET_STD), atol=std_tol
    )


@pytest.fixture
def key():
    return jax.random.key(3)


@pytest.fixture
def ref(key):
    # Deliberately offset reference so the kernel must rely on MH
    # correction, not just the reference measure.
    x = jax.random.normal(key, (512, 2)) * TARGET_STD + TARGET_MEAN
    return K.fit_gaussian_reference(x)


class TestKernelInvariance:
    def test_pcn(self, key, ref):
        step = partial(K.pcn_step, log_prob_fn=log_prob_fn, ref=ref)
        final = run(step, init_state(key))
        check_moments(final)
        acc = float(jnp.mean(final.n_accept)) / 400
        # Reference fitted to the target: near-independence sampler, so
        # acceptance is high.
        assert 0.1 < acc <= 1.0

    def test_tpcn(self, key, ref):
        step = partial(K.tpcn_step, log_prob_fn=log_prob_fn, ref=ref)
        final = run(step, init_state(key))
        check_moments(final)

    def test_rwmh(self, key, ref):
        step = partial(K.rwmh_step, log_prob_fn=log_prob_fn, ref=ref)
        final = run(step, init_state(key, step=0.5))
        check_moments(final)

    def test_mala(self, key):
        step = partial(K.mala_step, log_prob_and_grad_fn=lp_and_grad)
        final = run(step, init_state(key, step=0.4, with_grad=True))
        check_moments(final)

    def test_hmc(self, key):
        step = partial(
            K.hmc_step, log_prob_and_grad_fn=lp_and_grad, n_leapfrog=5
        )
        final = run(step, init_state(key, step=0.3, with_grad=True), 200)
        check_moments(final)

    def test_hmc_jittered(self, key):
        step = partial(
            K.hmc_step,
            log_prob_and_grad_fn=lp_and_grad,
            n_leapfrog=8,
            jitter_trajectory=True,
        )
        final = run(step, init_state(key, step=0.3, with_grad=True), 200)
        check_moments(final)

    def test_nuts(self, key):
        step = partial(K.nuts_step, log_prob_fn=log_prob_fn, max_depth=6)
        final = run(step, init_state(key, step=0.3, with_grad=True), 150)
        check_moments(final)
        # The dual-averaging statistic should sit near its 0.8 target
        # once the step size has adapted.
        acc = float(jnp.mean(final.n_accept)) / 150
        assert acc == pytest.approx(0.8, abs=0.2)

    def test_nuts_variable_trajectories(self, key):
        """NUTS trees are data-dependent: particles in different parts
        of the target stop at different depths (the property the old
        jittered-HMC surrogate lacked)."""

        def lp_single(z):
            return jnp.reshape(log_prob_fn(z[None]), ())

        vg = jax.value_and_grad(lp_single)
        n = 256
        x = jax.random.normal(key, (n, 2)) * TARGET_STD + TARGET_MEAN
        lp = log_prob_fn(x)
        grad = lp_and_grad(x)[1]
        keys = jax.random.split(jax.random.key(7), n)
        _, _, _, _, n_leaf, depth = jax.vmap(
            lambda k, z, l, g: K.nuts_trajectory(
                k, z, l, g, vg, jnp.asarray(0.3), max_depth=6
            )
        )(keys, x, lp, grad)
        n_leaf = np.asarray(n_leaf)
        depth = np.asarray(depth)
        assert len(np.unique(n_leaf)) > 3
        assert len(np.unique(depth)) > 1
        assert n_leaf.max() <= 2**6

    def test_stretch(self, key):
        step = partial(K.stretch_step, log_prob_fn=log_prob_fn)
        final = run(step, init_state(key), 600)
        check_moments(final)

    def test_stretch_odd_n(self, key):
        step = partial(K.stretch_step, log_prob_fn=log_prob_fn)
        final = run(step, init_state(key, n=511), 100)
        assert final.x.shape == (511, 2)

    def test_adaptation_targets_acceptance(self, key):
        # Mismatched (much wider) reference: large steps are mostly
        # rejected, so the adaptation must shrink the step size toward
        # the target acceptance.
        x_wide = jax.random.normal(key, (512, 2)) * 8.0
        ref = K.fit_gaussian_reference(x_wide)
        step = partial(
            K.pcn_step,
            log_prob_fn=log_prob_fn,
            ref=ref,
            target_acceptance=0.234,
            adaptation_rate=0.2,
        )
        state = init_state(key, step=0.99)
        final = run(step, state, 500)
        assert float(final.step_size) < 0.9
        # Run further with the adapted step; acceptance near target.
        probe = final._replace(n_accept=jnp.zeros_like(final.n_accept))
        probe = run(step, probe, 200)
        acc = float(jnp.mean(probe.n_accept)) / 200
        assert acc == pytest.approx(0.234, abs=0.15)

    def test_nan_target_rejected(self, key, ref):
        def nan_log_prob(x):
            lp = log_prob_fn(x)
            return jnp.where(x[:, 0] > 100.0, jnp.nan, lp)

        step = partial(K.pcn_step, log_prob_fn=nan_log_prob, ref=ref)
        final = run(step, init_state(key), 50)
        assert np.all(np.isfinite(np.asarray(final.log_prob)))


@pytest.mark.parametrize("kernel", ["tpcn", "pcn", "rwmh"])
def test_chain_started_at_target_keeps_its_moments(kernel):
    """Invariance of the XLA chains the SMC mutation runs: walkers drawn
    exactly from a correlated float32 Gaussian target, moved 40 steps
    under a deliberately misfit reference, are still target draws.

    Bounds: 5 standard errors of the population estimates over n
    independent walkers -- sigma_i / sqrt(n) for the means, and
    var_i * sqrt(2 / n) for the variances.
    """
    n, d = 8192, 4
    mean = jnp.asarray([1.0, -2.0, 0.5, 3.0], jnp.float32)
    chol = jnp.asarray(
        [[1.0, 0, 0, 0], [0.6, 0.8, 0, 0], [0.0, -1.2, 1.6, 0],
         [0.3, 0.0, 0.4, 0.5]],
        jnp.float32,
    )
    inv_cov = jnp.linalg.inv(chol @ chol.T)

    def log_p(x):
        r = x - mean
        return -0.5 * jnp.einsum("ni,ij,nj->n", r, inv_cov, r)

    key = jax.random.key(21)
    x0 = mean + jax.random.normal(key, (n, d), jnp.float32) @ chol.T
    # Reference too wide and shifted: only the MH correction keeps the
    # target invariant.
    ref = K.fit_gaussian_reference(1.5 * x0 + 0.5)
    step = partial(getattr(K, f"{kernel}_step"), log_prob_fn=log_p, ref=ref)
    state = K.ChainState(
        x=x0,
        log_prob=log_p(x0),
        key=jax.random.fold_in(key, 1),
        step_size=jnp.asarray(0.3, jnp.float32),
        n_accept=jnp.zeros(n, jnp.float32),
    )
    final = run(step, state, n_steps=40)
    x = np.asarray(final.x, np.float64)
    var = np.diag(np.asarray(chol @ chol.T, np.float64))
    assert x.dtype == np.float64 and np.isfinite(x).all()
    np.testing.assert_array_less(
        np.abs(x.mean(0) - np.asarray(mean)), 5 * np.sqrt(var / n)
    )
    np.testing.assert_array_less(
        np.abs(x.var(0) - var), 5 * var * np.sqrt(2.0 / n)
    )
    assert float(jnp.mean(final.n_accept)) > 0


class TestAutocorrTracking:
    def test_ar1_recovers_tau(self, key):
        """Feed run_chain an exact AR(1) update; the online lag-1 IAT
        must match (1 + rho) / (1 - rho)."""
        rho = 0.8

        def ar1_step(state):
            k, sub = jax.random.split(state.key)
            noise = jax.random.normal(sub, state.x.shape)
            x = rho * state.x + jnp.sqrt(1 - rho**2) * noise
            return state._replace(x=x, key=k)

        n_steps = 2000
        state = init_state(key, n=256)
        _, _, stats = jax.jit(
            lambda s: K.run_chain(
                ar1_step, s, n_steps, track_autocorr=True
            )
        )(state)
        expected = (1 + rho) / (1 - rho)  # = 9.0
        assert float(stats.tau) == pytest.approx(expected, rel=0.15)
        # Independent AR(1) walkers all traverse the same stationary
        # distribution, so within/pooled variance is ~1.
        assert float(stats.mixing) == pytest.approx(1.0, abs=0.1)

    def test_frozen_chain_saturates(self, key):
        """A chain that never moves reports a huge IAT (the rho clip),
        far beyond the chain length — conservative, not 'mixed'."""
        identity = lambda s: s  # noqa: E731
        n_steps = 50
        _, _, stats = jax.jit(
            lambda s: K.run_chain(
                identity, s, n_steps, track_autocorr=True
            )
        )(init_state(key, n=64))
        assert float(stats.tau) > 100 * n_steps
        # Frozen walkers have zero within-chain variance.
        assert float(stats.mixing) == pytest.approx(0.0, abs=1e-6)

    def test_independence_sampler_tau_one(self, key):
        def fresh_step(state):
            k, sub = jax.random.split(state.key)
            return state._replace(
                x=jax.random.normal(sub, state.x.shape), key=k
            )

        _, _, stats = jax.jit(
            lambda s: K.run_chain(
                fresh_step, s, 500, track_autocorr=True
            )
        )(init_state(key, n=128))
        assert float(stats.tau) == pytest.approx(1.0, abs=0.15)
        assert float(stats.mixing) == pytest.approx(1.0, abs=0.1)


    def test_far_from_origin_walkers_keep_accurate_stats(self, key):
        """Uncentered f32 moments cancel catastrophically for walkers
        far from the origin; the deviation-based accumulation must
        report the same diagnostics regardless of a large offset."""
        rho = 0.6
        offset = 4096.0  # mean/std ~ 4e3: uncentered f32 var is garbage

        def ar1_step(state):
            k, sub = jax.random.split(state.key)
            noise = jax.random.normal(sub, state.x.shape)
            x = offset + rho * (state.x - offset) + jnp.sqrt(
                1 - rho**2
            ) * noise
            return state._replace(x=x, key=k)

        state = init_state(key, n=256)
        state = state._replace(x=state.x + offset)
        _, _, stats = jax.jit(
            lambda s: K.run_chain(ar1_step, s, 1500, track_autocorr=True)
        )(state)
        expected = (1 + rho) / (1 - rho)  # = 4.0
        assert float(stats.tau) == pytest.approx(expected, rel=0.2)
        assert float(stats.mixing) == pytest.approx(1.0, abs=0.1)


class TestGaussianReference:
    def test_fit(self, key):
        x = (
            jax.random.normal(key, (20000, 2)) @ jnp.asarray(
                [[1.0, 0.0], [0.5, 0.8]]
            )
            + jnp.asarray([3.0, -1.0])
        )
        ref = K.fit_gaussian_reference(x)
        np.testing.assert_allclose(
            np.asarray(ref.mean), [3.0, -1.0], atol=0.05
        )
        cov = np.asarray(ref.chol @ ref.chol.T)
        # x = z @ A + mu with A = [[1, 0], [0.5, 0.8]] -> cov = A^T A.
        a = np.array([[1.0, 0.0], [0.5, 0.8]])
        np.testing.assert_allclose(cov, a.T @ a, atol=0.06)

    def test_mahalanobis_whitens(self, key):
        x = jax.random.normal(key, (5000, 3)) * 2.0 + 1.0
        ref = K.fit_gaussian_reference(x)
        r2 = np.asarray(K._mahalanobis_sq(ref, x))
        # Mean Mahalanobis^2 of own samples ~ d.
        assert r2.mean() == pytest.approx(3.0, rel=0.1)


def test_gamma_fixed_shape_moments():
    """Closed-form chi2 construction matches Gamma(alpha, 1) moments."""
    import jax
    import jax.numpy as jnp

    from aspire_tpu.samplers.kernels import gamma_fixed_shape

    n = 200_000
    for alpha in [4.5, 3.0, 0.5]:
        w = gamma_fixed_shape(jax.random.key(0), alpha, n, jnp.float32)
        assert w.shape == (n,)
        assert float(jnp.min(w)) > 0
        mean = float(jnp.mean(w))
        var = float(jnp.var(w))
        # MC error ~ alpha/sqrt(n); generous 5-sigma bounds.
        assert abs(mean - alpha) < 5 * (alpha**0.5) / n**0.5 + 0.01
        assert abs(var - alpha) < 0.1 * alpha + 0.05


def test_gamma_fixed_shape_fallback_non_half_integer():
    import jax
    import jax.numpy as jnp

    from aspire_tpu.samplers.kernels import gamma_fixed_shape

    w = gamma_fixed_shape(jax.random.key(1), 2.75, 50_000, jnp.float32)
    mean = float(jnp.mean(w))
    assert abs(mean - 2.75) < 0.05


class TestSplitEvalCounter:
    """The (lo, hi) split eval counter stays exact past int32 range."""

    def test_total_past_int32(self):
        import jax.numpy as jnp

        from aspire_tpu.samplers import kernels as K

        c = K.eval_counter_init()
        amount = 2**30
        for _ in range(5):  # 5 * 2**30 > 2**31 - 1
            c = K.eval_counter_add(c, amount)
        assert K.eval_counter_total(c) == 5 * amount
        # components stay within int32
        assert int(jnp.max(jnp.abs(c))) < 2**31 - 1

    def test_accepts_legacy_scalar(self):
        import numpy as np

        from aspire_tpu.samplers import kernels as K

        assert K.eval_counter_total(np.int32(123)) == 123


class TestSokalWindowedTau:
    """Windowed (Sokal) IAT from stored chains vs the AR(1) surrogate."""

    def _lag1_from_chain(self, chain, x0):
        import jax.numpy as jnp

        from aspire_tpu.samplers import kernels as K

        dev = jnp.concatenate(
            [jnp.zeros_like(x0[None]), chain - x0[None]], axis=0
        )
        s1 = dev.sum(0)
        s2 = (dev**2).sum(0)
        c1 = (dev[1:] * dev[:-1]).sum(0)
        return float(K.lag1_autocorr_time(s1, s2, c1, chain.shape[0]))

    def _make_chain(self, a1, a2, n_steps=400, n_walkers=64, seed=0):
        import numpy as np

        rng = np.random.default_rng(seed)
        x = np.zeros((n_steps + 2, n_walkers, 1))
        eps = rng.normal(size=(n_steps + 2, n_walkers, 1))
        for t in range(2, n_steps + 2):
            x[t] = a1 * x[t - 1] + a2 * x[t - 2] + eps[t]
        import jax.numpy as jnp

        return jnp.asarray(x[2:], jnp.float32), jnp.asarray(
            x[1], jnp.float32
        )

    def test_matches_ar1_on_ar1_chain(self):
        from aspire_tpu.samplers import kernels as K

        chain, x0 = self._make_chain(a1=0.6, a2=0.0)
        sokal = float(K.sokal_tau_from_chain(chain, x0))
        # Analytic IAT of AR(1) with rho=0.6: (1+rho)/(1-rho) = 4.
        assert sokal == pytest.approx(4.0, rel=0.35)

    def test_sees_multi_timescale_where_lag1_cannot(self):
        """AR(2) with negligible lag-1 but strong lag-2 correlation:
        the AR(1) surrogate reports tau ~= 1 while the true IAT is
        large — the windowed estimate must catch it."""
        from aspire_tpu.samplers import kernels as K

        chain, x0 = self._make_chain(a1=0.0, a2=0.9)
        lag1 = self._lag1_from_chain(chain, x0)
        sokal = float(K.sokal_tau_from_chain(chain, x0))
        assert lag1 < 2.0  # the surrogate is blind to the lag-2 decay
        assert sokal > 4.0 * lag1

    def test_frozen_chain_saturates(self):
        import jax.numpy as jnp

        from aspire_tpu.samplers import kernels as K

        x0 = jnp.ones((8, 2), jnp.float32)
        chain = jnp.broadcast_to(x0, (20, 8, 2))
        assert float(K.sokal_tau_from_chain(chain, x0)) == K._FROZEN_TAU

    def test_run_chain_windowed_requires_store(self):
        from aspire_tpu.samplers import kernels as K

        with pytest.raises(ValueError, match="store_chain"):
            K.run_chain(
                lambda s: s, None, 4, store_chain=False,
                track_autocorr=True, windowed_tau=True,
            )

    def test_run_chain_subset_windowed_tau(self):
        """windowed_tau without store_chain: tau from the strided
        tau_walkers subset tracks the full-chain estimate while no
        full chain is materialized or returned."""
        rho = 0.85

        def ar1_step(state):
            k, sub = jax.random.split(state.key)
            noise = jax.random.normal(sub, state.x.shape)
            x = rho * state.x + jnp.sqrt(1 - rho**2) * noise
            return state._replace(x=x, key=k)

        state = init_state(jax.random.PRNGKey(3), n=2048)
        _, chain, full = jax.jit(
            lambda s: K.run_chain(
                ar1_step, s, 600, store_chain=True,
                track_autocorr=True, windowed_tau=True,
            )
        )(state)
        _, chain_sub, sub = jax.jit(
            lambda s: K.run_chain(
                ar1_step, s, 600, track_autocorr=True,
                windowed_tau=True, tau_walkers=128,
            )
        )(state)
        assert chain.shape == (600, 2048, 2)
        assert chain_sub is None
        # Analytic AR(1) IAT: (1 + rho) / (1 - rho) ~= 12.3. 128
        # walkers estimate the walker-averaged tau as well as 2048.
        assert float(sub.tau) == pytest.approx(float(full.tau), rel=0.25)
        assert float(sub.tau) == pytest.approx(
            (1 + rho) / (1 - rho), rel=0.35
        )

    def test_subset_covering_population_is_bit_exact(self):
        """tau_walkers >= n: the strided subset IS the population, so
        the subset and stored-chain paths must agree bit-for-bit."""

        def step(state):
            k, sub = jax.random.split(state.key)
            x = state.x + 0.3 * jax.random.normal(sub, state.x.shape)
            return state._replace(x=x, key=k)

        state = init_state(jax.random.PRNGKey(5), n=64)
        _, _, full = jax.jit(
            lambda s: K.run_chain(
                step, s, 50, store_chain=True,
                track_autocorr=True, windowed_tau=True,
            )
        )(state)
        _, _, sub = jax.jit(
            lambda s: K.run_chain(
                step, s, 50, track_autocorr=True,
                windowed_tau=True, tau_walkers=1024,
            )
        )(state)
        assert float(sub.tau) == float(full.tau)
