"""MCMC mutation kernels as pure, jittable functions over particle batches.

Internalizes the kernels the reference imports (SURVEY.md §2.3):

- ``pcn`` / ``tpcn``: (t-)preconditioned Crank-Nicolson with acceptance-rate
  adaptation toward 0.234 (minipcn parity; reference mcmc.py:285-302,
  smc/minipcn.py:45-49). The tpCN uses the Gaussian-scale-mixture
  augmentation of the multivariate-t reference: w ~ Gamma((nu+d)/2,
  (nu+r^2)/2) then a pCN step under N(mu, Sigma/w), with the exact
  marginal acceptance correction.
- ``rwmh`` / ``mala`` / ``hmc``: random-walk, Langevin, and Hamiltonian
  kernels (blackjax parity; reference smc/blackjax.py:146-321).
- ``stretch``: affine-invariant ensemble move (emcee parity; reference
  mcmc.py:203-264) with the red-black two-half update so the whole
  ensemble advances in two batched steps.

Every kernel advances the *entire* ``(n, d)`` particle array per step —
no per-particle Python — and chains run under ``lax.scan``, so one SMC
mutation is a single fused XLA computation. All kernels take and return a
:class:`ChainState` and are stateless w.r.t. Python.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class ChainState(NamedTuple):
    """State threaded through a `lax.scan` chain."""

    x: jax.Array  # (n, d) positions
    log_prob: jax.Array  # (n,) target log-density
    key: jax.Array  # PRNG key
    step_size: jax.Array  # scalar (adapted)
    n_accept: jax.Array  # (n,) running acceptance counts
    grad: jax.Array | None = None  # (n, d) cached gradients (MALA/HMC)
    #: running count of target-density evaluations as a (2,) int32
    #: split counter ``[lo, hi]`` with value ``lo + hi * EVAL_BASE`` —
    #: kernels with data-dependent work (NUTS trees, HMC leapfrogs) add
    #: their true cost; fixed-cost kernels add n per step. The split
    #: keeps the count exact past 2**31 (a 1M-particle NUTS mutation
    #: can exceed int32 in a single call); per-STEP amounts must stay
    #: below ~2**31 (n * max_tree_leaves). None = untracked.
    n_evals: jax.Array | None = None


EVAL_BASE = 1 << 24


def eval_counter_init() -> jax.Array:
    """Fresh (2,) split eval counter."""
    return jnp.zeros((2,), jnp.int32)


def eval_counter_total(counter) -> int:
    """Host-side exact total of a (2,) split counter (Python int)."""
    c = np.asarray(counter)
    if c.ndim == 0:  # pre-split checkpoints / scalar counters
        return int(c)
    return int(c[0]) + int(c[1]) * EVAL_BASE


def eval_counter_add(counter: jax.Array, amount) -> jax.Array:
    """Add ``amount`` (< ~2**31) to a (2,) split counter, normalized."""
    lo = counter[0] + jnp.asarray(amount).astype(jnp.int32)
    hi = counter[1] + lo // EVAL_BASE
    return jnp.stack([lo % EVAL_BASE, hi])


def _count_evals(state: ChainState, amount) -> jax.Array | None:
    """Accumulate into the split eval counter when tracking is on."""
    if state.n_evals is None:
        return None
    return eval_counter_add(state.n_evals, amount)


class GaussianReference(NamedTuple):
    """Fitted ensemble moments used by pCN/tpCN/RWMH proposals."""

    mean: jax.Array  # (d,)
    chol: jax.Array  # (d, d) lower Cholesky of covariance
    inv_chol: jax.Array  # (d, d)


@functools.partial(jax.jit, static_argnames=("jitter",))
def fit_gaussian_reference(
    x: jax.Array, jitter: float = 1e-6
) -> GaussianReference:
    """Fit mean/covariance of the particle ensemble (minipcn parity)."""
    mean = jnp.mean(x, axis=0)
    xc = x - mean
    cov = (xc.T @ xc) / x.shape[0]
    cov = cov + jitter * jnp.eye(x.shape[1], dtype=x.dtype)
    chol = jnp.linalg.cholesky(cov)
    inv_chol = jax.scipy.linalg.solve_triangular(
        chol, jnp.eye(x.shape[1], dtype=x.dtype), lower=True
    )
    return GaussianReference(mean=mean, chol=chol, inv_chol=inv_chol)


def _mahalanobis_sq(ref: GaussianReference, x: jax.Array) -> jax.Array:
    z = (x - ref.mean) @ ref.inv_chol.T
    return jnp.sum(z**2, axis=-1)


def monotone_beta_bisect(ok, beta_prev, tol, dtype):
    """Largest ``beta`` in ``[beta_prev, 1]`` whose predicate holds.

    Shared scaffold of the SMC ESS bisection (``smc._bisect_beta``) and
    the PT CESS bisection (``mcmc._bisect_pt_beta``): ``ok(beta)`` must
    be monotone-decreasing in beta near ``beta_prev``. Jumps straight
    to 1 when ``ok(1.0)`` holds, otherwise runs a FIXED 54-halving
    bisection (2^-54 is below any practical tolerance; extra trips are
    no-ops once the interval hits the dtype resolution — a
    tolerance-conditioned ``while_loop`` would never terminate in
    float32, where 1e-8 is below the resolution near 1.0). Trace-safe:
    call under jit with ``ok`` closing over device arrays.
    """
    lo0 = jnp.where(ok(1.0), jnp.asarray(1.0, dtype=dtype), beta_prev)
    hi0 = jnp.asarray(1.0, dtype=dtype)

    def body(_, carry):
        lo, hi = carry
        done = hi - lo <= tol
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        new_lo = jnp.where(good, mid, lo)
        new_hi = jnp.where(good, hi, mid)
        return (
            jnp.where(done, lo, new_lo),
            jnp.where(done, hi, new_hi),
        )

    lo, _ = jax.lax.fori_loop(0, 54, body, (lo0, hi0))
    return lo


def gamma_fixed_shape(key, alpha: float, n: int, dtype) -> jax.Array:
    """Sample Gamma(alpha, 1) for a *static* shape parameter.

    ``jax.random.gamma`` runs a data-dependent rejection loop. When
    ``2*alpha`` is an integer, Gamma(alpha, 1) = chi2_{2 alpha}/2 has
    the exact closed construction ``sum of floor(alpha) exponentials
    (+ half a squared normal when 2 alpha is odd)``, which is pure
    vectorized RNG and elementwise work. Falls back to ``jax.random.gamma`` otherwise.
    """
    two_alpha = 2.0 * alpha
    k = int(round(two_alpha))
    if abs(two_alpha - k) > 1e-9 or k <= 0:
        return jax.random.gamma(key, alpha, (n,), dtype=dtype)
    m, odd = divmod(k, 2)
    u_key, n_key = jax.random.split(key)
    out = jnp.zeros((n,), dtype=dtype)
    if m > 0:
        u = jax.random.uniform(u_key, (n, m), dtype=dtype)
        # log(1-u) with u in [0,1): strictly negative, never -inf.
        out = -jnp.sum(jnp.log1p(-u), axis=-1)
    if odd:
        out = out + 0.5 * jax.random.normal(n_key, (n,), dtype=dtype) ** 2
    return out


def _adapt_step_size(
    step_size,
    accept_prob_mean,
    target_acceptance,
    adaptation_rate,
    max_log_step: float = 0.0,
):
    """Robbins-Monro step-size adaptation in log space.

    ``max_log_step=0`` (step <= 1) is the pCN constraint (s in (0, 1]);
    unconstrained kernels (RWMH/MALA/HMC) pass a larger bound so the
    adaptation can actually reach the target acceptance on wide targets.
    """
    log_s = jnp.log(step_size) + adaptation_rate * (
        accept_prob_mean - target_acceptance
    )
    return jnp.exp(jnp.clip(log_s, -10.0, max_log_step)).astype(
        step_size.dtype
    )


def _mh_update(
    state: ChainState,
    key,
    accept_key,
    x_prop,
    lp_prop,
    log_alpha,
    *,
    target_acceptance: float,
    adaptation_rate: float,
    max_log_step: float = 0.0,
    grad_prop=None,
    eval_amount=None,
) -> ChainState:
    """Shared Metropolis finish: NaN guard, accept/select, Robbins-Monro
    step adaptation, state rebuild. One definition for every MH kernel
    so the guard/accounting discipline cannot drift between them."""
    n = state.x.shape[0]
    log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
    accept = jnp.log(jax.random.uniform(accept_key, (n,))) < log_alpha
    x_new = jnp.where(accept[:, None], x_prop, state.x)
    lp_new = jnp.where(accept, lp_prop, state.log_prob)
    acc_prob = jnp.mean(jnp.exp(jnp.minimum(log_alpha, 0.0)))
    s_new = _adapt_step_size(
        state.step_size,
        acc_prob,
        target_acceptance,
        adaptation_rate,
        max_log_step=max_log_step,
    )
    grad_new = state.grad
    if grad_prop is not None:
        grad_new = jnp.where(accept[:, None], grad_prop, state.grad)
    return ChainState(
        x=x_new,
        log_prob=lp_new,
        key=key,
        step_size=s_new,
        n_accept=state.n_accept + accept,
        grad=grad_new,
        n_evals=_count_evals(
            state, n if eval_amount is None else eval_amount
        ),
    )


# ---------------------------------------------------------------------------
# pCN / tpCN
# ---------------------------------------------------------------------------


def pcn_step(
    state: ChainState,
    log_prob_fn: Callable,
    ref: GaussianReference,
    target_acceptance: float = 0.234,
    adaptation_rate: float = 0.1,
) -> ChainState:
    """Preconditioned Crank-Nicolson step under N(mean, chol chol^T).

    Proposal: x' = mu + sqrt(1-s^2)(x-mu) + s L xi, reversible w.r.t. the
    Gaussian reference, so  log alpha = dlog p + (r'^2 - r^2)/2.
    """
    key, prop_key, accept_key = jax.random.split(state.key, 3)
    n, d = state.x.shape
    # The pCN rotation needs s <= 1; a user-supplied initial step above
    # that would otherwise NaN the whole first sweep.
    s = jnp.minimum(state.step_size, 1.0)
    xi = jax.random.normal(prop_key, (n, d), dtype=state.x.dtype)
    x_prop = (
        ref.mean
        + jnp.sqrt(jnp.maximum(1 - s**2, 0.0)) * (state.x - ref.mean)
        + s * xi @ ref.chol.T
    )
    lp_prop = log_prob_fn(x_prop)
    r2_old = _mahalanobis_sq(ref, state.x)
    r2_new = _mahalanobis_sq(ref, x_prop)
    log_alpha = lp_prop - state.log_prob + 0.5 * (r2_new - r2_old)
    return _mh_update(
        state,
        key,
        accept_key,
        x_prop,
        lp_prop,
        log_alpha,
        target_acceptance=target_acceptance,
        adaptation_rate=adaptation_rate,
    )


def tpcn_step(
    state: ChainState,
    log_prob_fn: Callable,
    ref: GaussianReference,
    nu: float = 5.0,
    target_acceptance: float = 0.234,
    adaptation_rate: float = 0.1,
) -> ChainState:
    """t-preconditioned Crank-Nicolson step (minipcn's default ``tpcn``).

    Scale-mixture construction: w | x ~ Gamma((nu+d)/2, (nu+r^2)/2); pCN
    under N(mu, Sigma/w); the z-dependent part of the auxiliary density
    gives  log alpha = dlog p + (nu+d)/2 [log(nu+r'^2) - log(nu+r^2)],
    leaving the multivariate-t_nu(mu, Sigma) as the effective reference —
    heavier tails than pCN, hence robust to over-dispersed particles.
    """
    key, w_key, prop_key, accept_key = jax.random.split(state.key, 4)
    n, d = state.x.shape
    s = jnp.minimum(state.step_size, 1.0)  # rotation needs s <= 1
    r2_old = _mahalanobis_sq(ref, state.x)
    alpha_gamma = 0.5 * (nu + d)
    w = gamma_fixed_shape(w_key, alpha_gamma, n, state.x.dtype)
    w = w / (0.5 * (nu + r2_old))
    xi = jax.random.normal(prop_key, (n, d), dtype=state.x.dtype)
    x_prop = (
        ref.mean
        + jnp.sqrt(jnp.maximum(1 - s**2, 0.0)) * (state.x - ref.mean)
        + (s / jnp.sqrt(w))[:, None] * (xi @ ref.chol.T)
    )
    lp_prop = log_prob_fn(x_prop)
    r2_new = _mahalanobis_sq(ref, x_prop)
    log_alpha = (
        lp_prop
        - state.log_prob
        + alpha_gamma * (jnp.log(nu + r2_new) - jnp.log(nu + r2_old))
    )
    return _mh_update(
        state,
        key,
        accept_key,
        x_prop,
        lp_prop,
        log_alpha,
        target_acceptance=target_acceptance,
        adaptation_rate=adaptation_rate,
    )


# ---------------------------------------------------------------------------
# Random-walk Metropolis-Hastings
# ---------------------------------------------------------------------------


def rwmh_step(
    state: ChainState,
    log_prob_fn: Callable,
    ref: GaussianReference,
    target_acceptance: float = 0.234,
    adaptation_rate: float = 0.1,
) -> ChainState:
    """Gaussian random walk with ensemble-covariance proposal."""
    key, prop_key, accept_key = jax.random.split(state.key, 3)
    n, d = state.x.shape
    s = state.step_size
    xi = jax.random.normal(prop_key, (n, d), dtype=state.x.dtype)
    x_prop = state.x + s * xi @ ref.chol.T
    lp_prop = log_prob_fn(x_prop)
    log_alpha = lp_prop - state.log_prob
    return _mh_update(
        state,
        key,
        accept_key,
        x_prop,
        lp_prop,
        log_alpha,
        target_acceptance=target_acceptance,
        adaptation_rate=adaptation_rate,
        max_log_step=2.3,
    )


# ---------------------------------------------------------------------------
# MALA
# ---------------------------------------------------------------------------


def mala_step(
    state: ChainState,
    log_prob_and_grad_fn: Callable,
    target_acceptance: float = 0.574,
    adaptation_rate: float = 0.1,
) -> ChainState:
    """Metropolis-adjusted Langevin; caches gradients in the state."""
    key, prop_key, accept_key = jax.random.split(state.key, 3)
    n, d = state.x.shape
    eps = state.step_size
    grad = state.grad
    xi = jax.random.normal(prop_key, (n, d), dtype=state.x.dtype)
    mean_fwd = state.x + 0.5 * eps**2 * grad
    x_prop = mean_fwd + eps * xi
    lp_prop, grad_prop = log_prob_and_grad_fn(x_prop)
    mean_rev = x_prop + 0.5 * eps**2 * grad_prop
    log_q_fwd = -jnp.sum((x_prop - mean_fwd) ** 2, axis=-1) / (2 * eps**2)
    log_q_rev = -jnp.sum((state.x - mean_rev) ** 2, axis=-1) / (2 * eps**2)
    log_alpha = lp_prop - state.log_prob + log_q_rev - log_q_fwd
    return _mh_update(
        state,
        key,
        accept_key,
        x_prop,
        lp_prop,
        log_alpha,
        target_acceptance=target_acceptance,
        adaptation_rate=adaptation_rate,
        max_log_step=2.3,
        grad_prop=grad_prop,
    )


# ---------------------------------------------------------------------------
# HMC (fixed-length leapfrog; jittered length approximates NUTS behaviour)
# ---------------------------------------------------------------------------


def hmc_step(
    state: ChainState,
    log_prob_and_grad_fn: Callable,
    n_leapfrog: int = 10,
    target_acceptance: float = 0.651,
    adaptation_rate: float = 0.05,
    jitter_trajectory: bool = False,
) -> ChainState:
    """Hamiltonian step: ``n_leapfrog`` leapfrog integrations per proposal.

    With ``jitter_trajectory=True`` the trajectory length is randomized
    uniformly in [1, n_leapfrog] per step (shared across particles),
    the standard static-shape surrogate for NUTS-style path exploration
    on an accelerator (no data-dependent recursion; SURVEY.md §7).
    """
    key, mom_key, len_key, accept_key = jax.random.split(state.key, 4)
    n, d = state.x.shape
    eps = state.step_size
    p0 = jax.random.normal(mom_key, (n, d), dtype=state.x.dtype)

    if jitter_trajectory:
        n_steps = jax.random.randint(len_key, (), 1, n_leapfrog + 1)
    else:
        n_steps = n_leapfrog

    def leapfrog_body(i, carry):
        x, p, grad, _ = carry
        p_half = p + 0.5 * eps * grad
        x_new = x + eps * p_half
        lp_new, grad_new = log_prob_and_grad_fn(x_new)
        p_new = p_half + 0.5 * eps * grad_new
        return (x_new, p_new, grad_new, lp_new)

    # The final iteration's density/gradient evaluation IS the
    # proposal's: carry the value instead of re-evaluating at x_prop
    # (one of n_leapfrog + 1 target evaluations saved per step).
    x_prop, p_prop, grad_prop, lp_prop = jax.lax.fori_loop(
        0,
        n_steps,
        leapfrog_body,
        (state.x, p0, state.grad, state.log_prob),
    )
    ke0 = 0.5 * jnp.sum(p0**2, axis=-1)
    ke1 = 0.5 * jnp.sum(p_prop**2, axis=-1)
    log_alpha = (lp_prop - ke1) - (state.log_prob - ke0)
    return _mh_update(
        state,
        key,
        accept_key,
        x_prop,
        lp_prop,
        log_alpha,
        target_acceptance=target_acceptance,
        adaptation_rate=adaptation_rate,
        max_log_step=2.3,
        grad_prop=grad_prop,
        eval_amount=n_steps * n,
    )


# ---------------------------------------------------------------------------
# NUTS (iterative, bounded depth, static shapes)
# ---------------------------------------------------------------------------
#
# A real No-U-Turn sampler with static shapes: per-particle tree doubling
# under ``vmap`` (so every global step still evaluates the whole particle
# batch at once, with finished particles masked), multinomial
# progressive sampling over the trajectory, and the memory-efficient
# within-subtree U-turn checks done iteratively with a checkpoint stack
# of ``max_depth`` states instead of recursion. Matches the capability
# of the reference's blackjax NUTS (reference smc/blackjax.py:206-251)
# without data-dependent Python recursion: every shape is static and the
# doubling loops are ``lax.while_loop``s with bounded trip counts.
#
# Stack discipline (derived from the balanced-tree structure): scanning
# subtree leaves left to right, an even leaf is pushed (it starts a
# size-2 subtree); an odd leaf ``i`` with ``t`` trailing one-bits closes
# ``t`` nested subtrees, so it U-turn-checks against the top ``t`` stack
# entries and pops ``t - 1`` of them (the deepest start survives as the
# start of the next-size-up subtree).


def _trailing_ones(i, n_bits: int):
    """Number of contiguous low-order 1-bits of ``i`` (static unroll)."""
    count = jnp.zeros((), jnp.int32)
    running = jnp.ones((), bool)
    for b in range(n_bits):
        running = running & (((i >> b) & 1) == 1)
        count = count + jnp.where(running, 1, 0)
    return count


def _is_uturn(z_a, p_a, z_b, p_b):
    """Momenta at both ends point back across the segment a -> b."""
    dz = z_b - z_a
    return (jnp.dot(dz, p_a) < 0) | (jnp.dot(dz, p_b) < 0)


def nuts_trajectory(
    key,
    z0,
    lp0,
    grad0,
    value_and_grad_fn: Callable,
    step_size,
    max_depth: int = 8,
    max_delta_energy: float = 1000.0,
):
    """One NUTS trajectory for a single particle (vmap over particles).

    Returns ``(z, lp, grad, accept_stat, n_leapfrog, depth)`` where
    ``accept_stat`` is the mean Metropolis ratio over all visited
    leaves (the dual-averaging statistic) and ``n_leapfrog`` / ``depth``
    expose the data-dependent trajectory size for diagnostics.
    """
    d = z0.shape[0]
    dtype = z0.dtype
    key, mom_key = jax.random.split(key)
    p0 = jax.random.normal(mom_key, (d,), dtype=dtype)
    h0 = 0.5 * jnp.dot(p0, p0) - lp0
    eps = step_size.astype(dtype)

    def leapfrog(z, p, grad):
        p_half = p + 0.5 * eps * grad
        z_new = z + eps * p_half
        lp_new, grad_new = value_and_grad_fn(z_new)
        p_new = p_half + 0.5 * eps * grad_new
        return z_new, p_new, grad_new, lp_new

    # Carry layout: edges are kept in the "true" integration frame
    # (left momentum points left-to-right), subtrees are built in a
    # mirrored frame where integration always runs forward.
    tree = {
        "key": key,
        "zl": z0, "pl": p0, "gl": grad0,
        "zr": z0, "pr": p0, "gr": grad0,
        "zc": z0, "lpc": lp0, "gc": grad0,
        "logw": jnp.zeros((), dtype),  # weight of the initial point
        "depth": jnp.zeros((), jnp.int32),
        "turning": jnp.zeros((), bool),
        "diverging": jnp.zeros((), bool),
        "acc_sum": jnp.zeros((), dtype),
        "n_leaf": jnp.zeros((), jnp.int32),
    }

    n_slots = max_depth + 1

    def doubling_body(tree):
        key, dir_key, inner_key = jax.random.split(tree["key"], 3)
        forward = jax.random.bernoulli(dir_key)
        # Mirrored-frame start: extending left integrates the
        # negated-momentum system forward (U-turn dot products are
        # invariant under the joint flip of dz and p).
        z_e = jnp.where(forward, tree["zr"], tree["zl"])
        p_e = jnp.where(forward, tree["pr"], -tree["pl"])
        g_e = jnp.where(forward, tree["gr"], tree["gl"])
        n_leaves = jnp.left_shift(
            jnp.ones((), jnp.int32), tree["depth"]
        )

        sub = {
            "key": inner_key,
            "i": jnp.zeros((), jnp.int32),
            "z": z_e, "p": p_e, "g": g_e,
            "zc": z_e, "lpc": jnp.zeros((), dtype), "gc": g_e,
            "logw": jnp.full((), -jnp.inf, dtype),
            "z_stack": jnp.zeros((n_slots, d), dtype),
            "p_stack": jnp.zeros((n_slots, d), dtype),
            "sp": jnp.zeros((), jnp.int32),
            "turning": jnp.zeros((), bool),
            "diverging": jnp.zeros((), bool),
            "acc_sum": tree["acc_sum"],
            "n_leaf": tree["n_leaf"],
        }

        def leaf_cond(s):
            return (
                (s["i"] < n_leaves) & ~s["turning"] & ~s["diverging"]
            )

        def leaf_body(s):
            key, pick_key = jax.random.split(s["key"])
            z_n, p_n, g_n, lp_n = leapfrog(s["z"], s["p"], s["g"])
            h = 0.5 * jnp.dot(p_n, p_n) - lp_n
            lw = h0 - h
            lw = jnp.where(jnp.isnan(lw), -jnp.inf, lw)
            diverging = lw < -max_delta_energy
            # Progressive multinomial sampling within the subtree.
            logw_new = jnp.logaddexp(s["logw"], lw)
            take = (
                jnp.log(jax.random.uniform(pick_key, dtype=dtype))
                < lw - logw_new
            )
            # Checkpoint-stack U-turn checks (see module comment).
            i = s["i"]
            even = (i % 2) == 0
            z_stack = jnp.where(
                even, s["z_stack"].at[s["sp"]].set(z_n), s["z_stack"]
            )
            p_stack = jnp.where(
                even, s["p_stack"].at[s["sp"]].set(p_n), s["p_stack"]
            )
            t_ones = _trailing_ones(i, max_depth + 1)
            turning = s["turning"]
            for k in range(1, max_depth + 1):
                applies = (~even) & (k <= t_ones)
                slot = s["sp"] - k
                turn_k = _is_uturn(
                    s["z_stack"][slot], s["p_stack"][slot], z_n, p_n
                )
                turning = turning | (applies & turn_k)
            sp = jnp.where(
                even, s["sp"] + 1, s["sp"] - (t_ones - 1)
            )
            return {
                "key": key,
                "i": i + 1,
                "z": z_n, "p": p_n, "g": g_n,
                "zc": jnp.where(take, z_n, s["zc"]),
                "lpc": jnp.where(take, lp_n, s["lpc"]),
                "gc": jnp.where(take, g_n, s["gc"]),
                "logw": logw_new,
                "z_stack": z_stack,
                "p_stack": p_stack,
                "sp": sp,
                "turning": turning,
                "diverging": diverging,
                "acc_sum": s["acc_sum"]
                + jnp.exp(jnp.minimum(lw, 0.0)),
                "n_leaf": s["n_leaf"] + 1,
            }

        sub = jax.lax.while_loop(leaf_cond, leaf_body, sub)

        ok = ~sub["turning"] & ~sub["diverging"]
        key, swap_key = jax.random.split(key)
        # Biased progressive sampling across the doubling: favor the
        # new half proportionally to its total weight.
        swap = ok & (
            jnp.log(jax.random.uniform(swap_key, dtype=dtype))
            < sub["logw"] - tree["logw"]
        )
        grew_right = ok & forward
        grew_left = ok & ~forward
        zl = jnp.where(grew_left, sub["z"], tree["zl"])
        pl = jnp.where(grew_left, -sub["p"], tree["pl"])
        gl = jnp.where(grew_left, sub["g"], tree["gl"])
        zr = jnp.where(grew_right, sub["z"], tree["zr"])
        pr = jnp.where(grew_right, sub["p"], tree["pr"])
        gr = jnp.where(grew_right, sub["g"], tree["gr"])
        return {
            "key": key,
            "zl": zl, "pl": pl, "gl": gl,
            "zr": zr, "pr": pr, "gr": gr,
            "zc": jnp.where(swap, sub["zc"], tree["zc"]),
            "lpc": jnp.where(swap, sub["lpc"], tree["lpc"]),
            "gc": jnp.where(swap, sub["gc"], tree["gc"]),
            "logw": jnp.where(
                ok, jnp.logaddexp(tree["logw"], sub["logw"]), tree["logw"]
            ),
            "depth": tree["depth"] + 1,
            "turning": sub["turning"] | (ok & _is_uturn(zl, pl, zr, pr)),
            "diverging": sub["diverging"],
            "acc_sum": sub["acc_sum"],
            "n_leaf": sub["n_leaf"],
        }

    def doubling_cond(tree):
        return (
            ~tree["turning"]
            & ~tree["diverging"]
            & (tree["depth"] < max_depth)
        )

    tree = jax.lax.while_loop(doubling_cond, doubling_body, tree)
    accept_stat = tree["acc_sum"] / jnp.maximum(tree["n_leaf"], 1)
    return (
        tree["zc"],
        tree["lpc"],
        tree["gc"],
        accept_stat.astype(dtype),
        tree["n_leaf"],
        tree["depth"],
    )


def nuts_step(
    state: ChainState,
    log_prob_fn: Callable,
    max_depth: int = 8,
    max_delta_energy: float = 1000.0,
    target_acceptance: float = 0.8,
    adaptation_rate: float = 0.05,
) -> ChainState:
    """One NUTS transition for the whole particle batch.

    ``vmap`` over :func:`nuts_trajectory`: each particle doubles its own
    trajectory, all particles advance in lockstep on device (finished
    lanes are masked by the batched while_loop). ``n_accept``
    accumulates the per-particle mean Metropolis ratio so the recorded
    SMC acceptance stays comparable with the other kernels.
    """

    def lp_single(z_i):
        return jnp.reshape(log_prob_fn(z_i[None, :]), ())

    value_and_grad_fn = jax.value_and_grad(lp_single)
    key, traj_key = jax.random.split(state.key)
    n = state.x.shape[0]
    keys = jax.random.split(traj_key, n)
    x, lp, grad, accept_stat, n_leaf, _ = jax.vmap(
        lambda k, z, l, g: nuts_trajectory(
            k, z, l, g, value_and_grad_fn, state.step_size,
            max_depth=max_depth, max_delta_energy=max_delta_energy,
        )
    )(keys, state.x, state.log_prob, state.grad)
    eps_new = _adapt_step_size(
        state.step_size,
        jnp.mean(accept_stat),
        target_acceptance,
        adaptation_rate,
        max_log_step=2.3,
    )
    return ChainState(
        x=x,
        log_prob=lp,
        key=key,
        step_size=eps_new,
        n_accept=state.n_accept + accept_stat,
        grad=grad,
        n_evals=_count_evals(state, jnp.sum(n_leaf)),
    )


# ---------------------------------------------------------------------------
# Affine-invariant ensemble (emcee stretch move)
# ---------------------------------------------------------------------------


def stretch_step(
    state: ChainState,
    log_prob_fn: Callable,
    a: float = 2.0,
) -> ChainState:
    """Goodman-Weare stretch move with red-black half updates.

    Each half of the ensemble proposes against a partner drawn from the
    *other* half, so both halves update as fully batched operations
    (emcee's parallel scheme; reference mcmc.py:217-234 wraps the serial
    library version).
    """
    n, d = state.x.shape
    half = n // 2
    key = state.key
    x = state.x
    lp = state.log_prob
    n_accept = state.n_accept

    # (move slice, partner slice); handles odd n via the uneven split.
    blocks = (
        ((0, half), (half, n)),
        ((half, n), (0, half)),
    )
    for (m0, m1), (o0, o1) in blocks:
        n_move = m1 - m0
        n_other = o1 - o0
        key, z_key, pick_key, accept_key = jax.random.split(key, 4)
        pick = jax.random.randint(pick_key, (n_move,), 0, n_other)
        partners = x[o0 + pick]
        # z ~ g(z) prop 1/sqrt(z) on [1/a, a]: inverse-CDF sampling.
        u = jax.random.uniform(z_key, (n_move,), dtype=x.dtype)
        z = (u * (jnp.sqrt(a) - jnp.sqrt(1 / a)) + jnp.sqrt(1 / a)) ** 2
        # The half being moved is a contiguous block: static slices
        # (not index gathers) so XLA fuses instead of scattering.
        x_move = x[m0:m1]
        x_prop = partners + z[:, None] * (x_move - partners)
        lp_prop = log_prob_fn(x_prop)
        log_alpha = (d - 1) * jnp.log(z) + lp_prop - lp[m0:m1]
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        accept = (
            jnp.log(jax.random.uniform(accept_key, (n_move,))) < log_alpha
        )
        x = x.at[m0:m1].set(jnp.where(accept[:, None], x_prop, x_move))
        lp = lp.at[m0:m1].set(jnp.where(accept, lp_prop, lp[m0:m1]))
        n_accept = n_accept.at[m0:m1].add(accept)

    return ChainState(
        x=x,
        log_prob=lp,
        key=key,
        step_size=state.step_size,
        n_accept=n_accept,
        grad=state.grad,
        n_evals=_count_evals(state, n),
    )


# ---------------------------------------------------------------------------
# Chain runner
# ---------------------------------------------------------------------------


class ChainStats(NamedTuple):
    """Online mixing diagnostics for one mutation sweep.

    ``tau``: scalar lag-1 (AR(1)) integrated autocorrelation time.
    ``mixing``: worst-dimension ratio of mean within-chain variance to
    pooled population variance, in [0, 1] — the R-hat-style
    between/within statistic. A kernel that mixes well INSIDE a mode
    but never crosses modes has small ``mixing`` even when ``tau`` is
    small, which is exactly the failure mode lag-1 autocorrelation
    cannot see (each walker's variance is within-mode only).
    """

    tau: jax.Array
    mixing: jax.Array


def run_chain(
    step_fn: Callable[[ChainState], ChainState],
    state: ChainState,
    n_steps: int,
    store_chain: bool = False,
    track_autocorr: bool = False,
    windowed_tau: bool = False,
    tau_walkers: int | None = None,
):
    """Run ``n_steps`` of ``step_fn`` under ``lax.scan``.

    Returns ``(final_state, chain)`` where ``chain`` is the stacked
    positions ``(n_steps, n, d)`` if ``store_chain`` else None. With
    ``track_autocorr=True`` a third value is returned: a
    :class:`ChainStats` computed online from O(n d) running sums so
    the chain itself never needs to be materialized. With
    ``windowed_tau=True`` the reported tau is the windowed Sokal
    estimate (:func:`sokal_tau_from_chain`) instead of the AR(1)
    surrogate; it needs chain history, taken from the stored chain
    when ``store_chain=True``, otherwise from an in-scan strided
    subset of ``tau_walkers`` walkers — the walker-averaged tau
    concentrates fast in the number of walkers, so ~1k walkers
    estimate it as well as 1M while the stored history stays
    ``(n_steps, tau_walkers, d)`` instead of the full population.
    """
    if windowed_tau and not (
        track_autocorr and (store_chain or tau_walkers)
    ):
        raise ValueError(
            "windowed_tau requires track_autocorr=True and either "
            "store_chain=True or tau_walkers=<n>"
        )
    # Strided subset spreads across the (resampled, hence roughly
    # ancestor-sorted) population instead of taking a contiguous
    # prefix that could sit inside one mode. The (i * n) // w formula
    # keeps full coverage for every (n, w): a plain n // w stride
    # degenerates to a contiguous prefix when w <= n < 2w.
    sub_idx = None
    if windowed_tau and not store_chain:
        n_walkers = state.x.shape[0]
        w = max(1, min(int(tau_walkers), n_walkers))
        sub_idx = (jnp.arange(w) * n_walkers) // w
    if not track_autocorr:

        def body(carry, _):
            new = step_fn(carry)
            out = new.x if store_chain else None
            return new, out

        final, chain = jax.lax.scan(body, state, None, length=n_steps)
        return final, chain

    # Moments are accumulated on per-walker DEVIATIONS from the start
    # position: uncentered f32 sums (E[x^2] - mean^2) cancel
    # catastrophically when |mean| >> std (e.g. a coordinate near 30
    # with sigma 0.01), which would corrupt tau/mixing and with them
    # the lineage-based evidence-error inflation. Deviations stay
    # O(step * n_steps), which f32 handles.
    x0 = state.x
    zeros = jnp.zeros_like(x0)
    init = (state, zeros, zeros, zeros, zeros)

    def body(carry, _):
        st, prev_d, s1, s2, c1 = carry
        new = step_fn(st)
        out = (
            new.x if store_chain else None,
            new.x[sub_idx] if sub_idx is not None else None,
        )
        delta = new.x - x0
        carry = (
            new,
            delta,
            s1 + delta,
            s2 + jnp.square(delta),
            c1 + delta * prev_d,
        )
        return carry, out

    (final, _, s1, s2, c1), (chain, sub_chain) = jax.lax.scan(
        body, init, None, length=n_steps
    )
    if windowed_tau:
        if store_chain:
            tau = sokal_tau_from_chain(chain, x0)
        else:
            tau = sokal_tau_from_chain(sub_chain, x0[sub_idx])
    else:
        tau = lag1_autocorr_time(s1, s2, c1, n_steps)
    stats = ChainStats(
        tau=tau,
        mixing=chain_mixing_ratio(x0, s1, s2, n_steps),
    )
    return final, chain, stats


def chain_mixing_ratio(x0, s1, s2, n_steps: int):
    """Worst-dimension within/pooled variance ratio, in [0, 1].

    ``x0`` are the chain start positions; ``s1``/``s2`` are per-walker
    sums of the deviations ``x_t - x_0`` and their squares over the
    ``n_steps + 1`` points, shaped ``(n_walkers, d)``. For a kernel
    whose chains traverse the whole target, each walker's variance
    matches the population's (ratio ~ 1); for one trapped in a subset
    (a mode), within-chain variance misses the between-mode spread and
    the ratio drops toward within/(within + between). Between-walker
    variance is computed center-then-square (no uncentered-moment
    cancellation).
    """
    m = n_steps + 1
    dev_mean = s1 / m  # (n, d) per-walker deviation means
    within = jnp.mean(
        s2 / m - jnp.square(dev_mean), axis=0
    )  # (d,)
    walker_means = x0 + dev_mean
    grand = jnp.mean(walker_means, axis=0)
    between = jnp.mean(
        jnp.square(walker_means - grand), axis=0
    )
    pooled = within + between
    ratio = jnp.where(
        pooled > 1e-12, within / jnp.maximum(pooled, 1e-12), 1.0
    )
    return jnp.clip(jnp.min(ratio), 0.0, 1.0)


def lag1_autocorr_time(s1, s2, c1, n_steps: int):
    """IAT from per-walker lag-1 autocorrelation (AR(1) formula).

    ``s1``/``s2`` are sums of the per-walker deviations ``x_t - x_0``
    and their squares over the ``n_steps + 1`` chain points (the start
    contributes zeros), ``c1`` the sum of the ``n_steps`` lag-1
    deviation products, all shaped ``(n_walkers, d)`` — variances and
    covariances are shift-invariant, and deviations keep the f32 sums
    catastrophe-free for far-from-origin walkers. The per-dimension
    walker-averaged lag-1 correlation ``rho`` gives
    ``tau = (1 + rho) / (1 - rho)`` — exact for an AR(1) chain, a
    cheap online surrogate for the windowed Sokal estimate used on
    stored chains (:meth:`MCMCSamples.compute_autocorrelation_time`).
    Walkers with zero variance (no accepted move) count as perfectly
    correlated. Deliberately NOT clipped to the chain length: a tau far
    beyond ``n_steps`` cannot be resolved, but reporting the raw AR(1)
    extrapolation keeps downstream error inflation conservative (a
    frozen chain saturates at ~2e4 from the rho <= 0.9999 clip rather
    than masquerading as mixed).
    """
    m = n_steps + 1
    mean = s1 / m
    var = s2 / m - jnp.square(mean)
    cov1 = c1 / n_steps - jnp.square(mean)
    rho = jnp.where(var > 1e-12, cov1 / jnp.maximum(var, 1e-12), 1.0)
    rho_dim = jnp.clip(jnp.mean(rho, axis=0), -0.9999, 0.9999)
    tau_dim = (1 + rho_dim) / (1 - rho_dim)
    return jnp.mean(jnp.maximum(tau_dim, 1.0))


#: tau reported for a chain with no variance at all (frozen walkers);
#: matches the AR(1) estimator's rho <= 0.9999 saturation value.
_FROZEN_TAU = 2e4


def sokal_tau_from_chain(chain, x0, c: float = 5.0):
    """Windowed (Sokal) integrated autocorrelation time from a stored
    chain, on device.

    ``chain`` is ``(n_steps, n_walkers, d)`` positions, ``x0`` the
    ``(n_walkers, d)`` start points (prepended as step 0). Per-walker
    autocovariances come from an FFT over the time axis (the standard
    estimator the reference gets from ``emcee.autocorr``; reference
    smc/emcee.py:66-84); walker-averaged per-dim correlations are
    summed with Geyer/Sokal's adaptive window — the smallest ``W`` with
    ``W >= c * tau(W)`` — and the worst (largest) dimension is
    reported. Unlike the online AR(1) surrogate
    (:func:`lag1_autocorr_time`), this sees multi-timescale chains
    whose lag-1 correlation is small but whose tail decays slowly —
    exactly the hard-target case where the lineage-based evidence-error
    inflation needs an honest tau.
    """
    dev = chain - x0[None]  # deviations: f32-safe far from the origin
    dev = jnp.concatenate([jnp.zeros_like(dev[:1]), dev], axis=0)
    m = dev.shape[0]
    y = dev - jnp.mean(dev, axis=0, keepdims=True)
    nfft = 1
    while nfft < 2 * m:
        nfft *= 2
    f = jnp.fft.rfft(y, n=nfft, axis=0)
    acov = jnp.fft.irfft(
        (f * jnp.conj(f)).real.astype(jnp.complex64), n=nfft, axis=0
    )[:m].real
    g = jnp.mean(acov, axis=1)  # walker-averaged, (m, d)
    g0 = jnp.maximum(g[0], 1e-30)
    rho = g[1:] / g0  # (m - 1, d)
    taus = 1.0 + 2.0 * jnp.cumsum(rho, axis=0)
    lags = jnp.arange(1, m, dtype=taus.dtype)[:, None]
    ok = lags >= c * taus
    idx = jnp.where(
        jnp.any(ok, axis=0), jnp.argmax(ok, axis=0), m - 2
    )
    tau_dim = jnp.take_along_axis(taus, idx[None, :], axis=0)[0]
    # Frozen dimensions (no variance anywhere) cannot be resolved:
    # report the same saturation value as the AR(1) path instead of a
    # spuriously perfect tau = 1.
    tau_dim = jnp.where(g[0] > 1e-30, tau_dim, _FROZEN_TAU)
    return jnp.clip(jnp.max(tau_dim), 1.0, _FROZEN_TAU)
