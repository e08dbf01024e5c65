"""First-class PRNG-implementation selection (``prng_impl="rbg"``).

The PRNG opt-in is a per-run constructor kwarg rather than a
process-global env var. Covers: key creation, end-to-end SMC, SMC
checkpoint/resume stream continuity, and the PT state round-trip
extended to the kwarg path.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aspire_tpu import Aspire, Samples
from aspire_tpu.samplers.base import _as_key

DIMS = 2
TRUE_LOG_Z = -DIMS * math.log(20)


def log_likelihood(samples):
    return jnp.sum(
        -0.5 * (samples.x - 1.0) ** 2 - 0.5 * jnp.log(2 * jnp.pi), axis=-1
    )


def log_prior(samples):
    x = samples.x
    inside = jnp.all((x >= -10) & (x <= 10), axis=-1)
    return jnp.where(inside, -DIMS * jnp.log(20.0), -jnp.inf)


def make_aspire(**kwargs):
    return Aspire(
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        dims=DIMS,
        parameters=[f"x_{i}" for i in range(DIMS)],
        prior_bounds={f"x_{i}": [-10, 10] for i in range(DIMS)},
        seed=0,
        **kwargs,
    )


@pytest.fixture(scope="module")
def initial_samples():
    rng = np.random.default_rng(3)
    return Samples(rng.normal(1.0, 1.1, size=(1000, DIMS)))


def test_as_key_impl():
    k = _as_key(7, impl="rbg")
    assert str(jax.random.key_impl(k)) == "rbg"
    # An rng that is already a key keeps its own impl.
    pre = jax.random.key(3)
    assert _as_key(pre, impl="rbg") is pre


def test_aspire_prng_impl_end_to_end(initial_samples):
    asp = make_aspire(prng_impl="rbg")
    asp.fit(initial_samples, n_epochs=8, batch_size=256)
    samples = asp.sample_posterior(
        n_samples=300, sampler="smc", sampler_kwargs={"n_steps": 5}
    )
    assert asp.sampler.key_impl_name() == "rbg"
    assert float(samples.log_evidence) == pytest.approx(TRUE_LOG_Z, abs=0.7)
    # Reused-sampler re-seed keeps the impl (aspire.py fresh-sampler
    # semantics path).
    asp.sample_posterior(
        n_samples=300, sampler="smc", sampler_kwargs={"n_steps": 5}
    )
    assert asp.sampler.key_impl_name() == "rbg"


def test_smc_checkpoint_restores_rbg_stream(tmp_path, initial_samples):
    """A checkpoint written under rbg restores the rbg key stream."""
    path = tmp_path / "rbg_ckpt.h5"
    asp = make_aspire(prng_impl="rbg")
    asp.fit(initial_samples, n_epochs=8, batch_size=256)
    asp.sample_posterior(
        n_samples=200,
        sampler="smc",
        sampler_kwargs={"n_steps": 5},
        checkpoint_path=str(path),
        checkpoint_every=1,
    )
    sampler = asp.init_sampler("smc", prng_impl="rbg")
    state = sampler.load_checkpoint_from_file(str(path))
    assert state["prng_impl"] == "rbg"
    sampler.restore_from_checkpoint(state)
    assert sampler.key_impl_name() == "rbg"
    # resume_from_file round-trips the impl through the stored config.
    asp2 = Aspire.resume_from_file(
        str(path), log_likelihood=log_likelihood, log_prior=log_prior
    )
    assert asp2.prng_impl == "rbg"
    out = asp2.sample_posterior(n_final_samples=300)
    assert len(out) == 300
    assert asp2.sampler.key_impl_name() == "rbg"


def test_pt_state_roundtrip_kwarg_path(tmp_path, initial_samples):
    """PT mid-run state: the kwarg-selected impl is recorded, replayed
    bit-identically on resume, and a mismatched resume fails loudly."""
    import h5py

    asp = make_aspire(prng_impl="rbg")
    asp.fit(initial_samples, n_epochs=8, batch_size=256)
    common = dict(n_steps=24, n_temperatures=4, swap_every=4)

    ref = asp.init_sampler("ptmcmc", preconditioning="none").sample(
        16, **common
    )
    path = tmp_path / "pt_rbg.h5"
    s2 = asp.init_sampler("ptmcmc", preconditioning="none")
    assert s2.key_impl_name() == "rbg"
    full = s2.sample(
        16, **common,
        checkpoint_file_path=str(path), state_checkpoint_every=2,
    )
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(ref.x))
    with h5py.File(path, "r") as f:
        assert f["checkpoint/pt_state"].attrs["prng_impl"] == "rbg"

    # Resume with the matching impl: identical completed samples.
    s3 = asp.init_sampler("ptmcmc", preconditioning="none")
    again = s3.sample(16, **common, resume_from=str(path))
    np.testing.assert_array_equal(np.asarray(again.x), np.asarray(ref.x))

    # Mismatched impl refuses to mix bit streams.
    asp_t = make_aspire()  # default threefry
    asp_t.flow = asp.flow
    s4 = asp_t.init_sampler("ptmcmc", preconditioning="none")
    with pytest.raises(ValueError, match="prng_impl"):
        s4.sample(16, **common, resume_from=str(path))
