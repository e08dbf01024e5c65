"""Adaptive-tempered Sequential Monte Carlo.

Device-resident re-design of the reference SMC stack (``samplers/smc/base.py``,
``smc/minipcn.py``, ``smc/emcee.py``, ``smc/blackjax.py``):

- the temperature ladder is orchestrated on host, but every heavy step is
  a jitted, device-resident computation over the full ``(n, d)`` particle
  array: beta bisection (``lax.while_loop`` on scalars derived from one
  ``(n,)`` delta vector), evidence-ratio + variance, resampling
  (systematic, on-device), and mutation (``lax.scan`` chains of batched
  kernel steps);
- mutation kernels come from :mod:`.kernels` (tpcn/pcn default —
  minipcn parity; stretch — emcee parity; rwmh/mala/hmc — blackjax
  parity);
- non-jittable user targets degrade gracefully to host evaluation per
  mutation step (reference behaviour), keeping everything else on device.

Algorithm parity is with reference smc/base.py:123-213 (bisection with
target-efficiency ramp, min/max beta steps, ``BetaScheduleError``),
215-488 (main loop), 507-519 (tempered log-density with NaN guard),
521-562 (checkpoint state incl. history + RNG).
"""

from __future__ import annotations

import copy
import logging
import math
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..history import SMCHistory
from ..ops.resampling import get_resampler
from ..ops.special import effective_sample_size
from ..samples import Samples, SMCSamples, incremental_log_weights
from ..utils import track_calls
from .base import Sampler
from . import kernels as K

logger = logging.getLogger("aspire_tpu")

DEFAULT_BETA_TOLERANCE = 1e-8


class BetaScheduleError(RuntimeError):
    """Raised when the adaptive beta ladder stalls (reference smc/base.py:26)."""


# ---------------------------------------------------------------------------
# Jitted numerical cores
# ---------------------------------------------------------------------------


@jax.jit
def _nan_flags(log_q, log_prior, log_likelihood):
    """One dispatch for the three init NaN guards (a remote backend
    pays a round-trip per eager fetch; three separate ``.any()`` calls
    cost ~120 ms of the 131k-particle pipeline)."""
    return (
        jnp.isnan(log_q).any(),
        jnp.isnan(log_prior).any(),
        jnp.isnan(log_likelihood).any(),
    )


@jax.jit
def _bisect_beta(delta, beta_prev, target_eff, tol):
    """On-device bisection for the next inverse temperature.

    ``delta = logL + logPi - log_q``; the incremental log-weights at trial
    beta are ``(beta - beta_prev) * delta`` (constant shifts cancel in the
    ESS). Parity: reference smc/base.py:160-186, but the entire bisection
    runs on device in one compiled loop — no host round-trip per probe.

    Bisection scaffold shared with the PT ladder
    (:func:`aspire_tpu.samplers.kernels.monotone_beta_bisect`) — see
    there for the fixed-54-trip rationale.
    """
    n = delta.shape[0]

    def ok(beta):
        lw = (beta - beta_prev) * delta
        return effective_sample_size(lw) / n >= target_eff

    return K.monotone_beta_bisect(ok, beta_prev, tol, delta.dtype)


def _check_beta_progress(
    beta, beta_star, beta_prev, target_eff, beta_tolerance, min_beta_step,
    adaptive,
):
    """Shared warn/raise semantics for the adaptive ladder
    (reference smc/base.py:160-213)."""
    if (
        adaptive
        and beta_star <= beta_prev + beta_tolerance
        and beta_prev < 1.0
    ):
        logger.warning(
            "Adaptive beta search could not find a beta above %.6g that "
            "satisfies the target efficiency %.3f within tolerance %.1e; "
            "beta may remain unchanged.",
            beta_prev,
            target_eff,
            beta_tolerance,
        )
    if beta == beta_prev:
        raise BetaScheduleError(
            f"Beta did not increase from previous value {beta:.6g}. "
            "Adaptive beta search may have failed to find a suitable "
            f"beta. Consider adjusting beta_tolerance ({beta_tolerance}), "
            f"min_beta_step ({min_beta_step}) or target_efficiency "
            f"({target_eff})."
        )


@partial(jax.jit, static_argnames=("adaptive", "adaptive_min_step"))
def _iteration_stats(
    log_l,
    log_pi,
    log_q,
    beta_prev,
    beta_fixed,
    target_eff,
    tol,
    min_beta_step,
    max_beta_step,
    *,
    adaptive,
    adaptive_min_step,
):
    """Everything the SMC host loop needs per temperature, in ONE call.

    Bundles the incremental-weight construction, the adaptive-beta
    bisection with its step clamps, both ESS evaluations, and the
    per-step evidence ratio + variance, returning seven scalars fetched
    with a single device round-trip (the previous eager chain cost ~5
    round-trips per iteration on remote backends).
    """
    delta = log_l + log_pi - log_q
    if adaptive:
        beta_star = _bisect_beta(delta, beta_prev, target_eff, tol)
        if adaptive_min_step:
            min_step = jnp.where(
                beta_star < 1.0,
                min_beta_step * (1 - beta_prev) / (1 - beta_star),
                min_beta_step,
            )
        else:
            min_step = jnp.asarray(min_beta_step, dtype=delta.dtype)
        beta = jnp.maximum(beta_star, beta_prev + min_step)
        beta = jnp.minimum(
            jnp.minimum(beta, beta_prev + max_beta_step), 1.0
        )
    else:
        beta_star = beta = jnp.asarray(beta_fixed, dtype=delta.dtype)
        min_step = jnp.asarray(min_beta_step, dtype=delta.dtype)

    ess = effective_sample_size((beta - beta_prev) * delta)
    ess_at_one = effective_sample_size((1.0 - beta_prev) * delta)
    log_w = (beta - beta_prev) * delta
    n = log_w.shape[0]
    m = jnp.max(log_w)
    u = jnp.exp(jnp.minimum(log_w - m, 0.0))
    mean_u = jnp.mean(u)
    ratio = m + jnp.log(mean_u)
    var = jnp.var(u) / (n * mean_u**2)
    return beta, min_step, beta_star, ess, ess_at_one, ratio, var


# ---------------------------------------------------------------------------
# SMC driver
# ---------------------------------------------------------------------------


class SMCSampler(Sampler):
    """Base adaptive-tempered SMC sampler; subclasses provide ``mutate``."""

    default_sampler_kwargs: dict = {}

    def __init__(
        self,
        *args,
        resampling_method: str = "systematic",
        resampling_impl: str = "auto",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.resampling_method = resampling_method
        #: "auto" = GSPMD lowers the resampling gather; "ring" = the
        #: hand-rolled shard_map collective (weight all-gather +
        #: ppermute ring, ops/resampling.py) on mesh-sharded runs.
        self.resampling_impl = resampling_impl
        self.history = SMCHistory()
        self.sampler_kwargs: dict = {}
        self._adaptive_target_efficiency = False
        self._mutate_cache: dict = {}
        self._step_size_carry = None
        from ..profiling import Profiler

        self.profiler = Profiler()

    # -- target efficiency schedule (reference smc/base.py:80-121) ---------

    @property
    def target_efficiency(self):
        return self._target_efficiency

    @target_efficiency.setter
    def target_efficiency(self, value):
        if isinstance(value, float):
            if not (0 < value < 1):
                raise ValueError("target_efficiency must be in (0, 1)")
            self._target_efficiency = value
            self._adaptive_target_efficiency = False
        elif len(value) != 2:
            raise ValueError(
                "target_efficiency must be a float or tuple of two floats"
            )
        else:
            value = tuple(map(float, value))
            if not (0 < value[0] < value[1] < 1):
                raise ValueError(
                    "target_efficiency tuple must be in (0, 1) and "
                    "increasing"
                )
            self._target_efficiency = value
            self._adaptive_target_efficiency = True

    def current_target_efficiency(self, beta: float) -> float:
        if self._adaptive_target_efficiency:
            lo, hi = self._target_efficiency
            return lo + (hi - lo) * (beta**self.target_efficiency_rate)
        return self._target_efficiency

    # -- beta schedule ------------------------------------------------------

    def determine_beta(
        self,
        delta: jax.Array,
        beta: float,
        beta_step: float,
        min_beta_step: float,
        max_beta_step: float = 1.0,
        beta_tolerance: float = DEFAULT_BETA_TOLERANCE,
    ) -> tuple[float, float]:
        """Next beta; parity with reference smc/base.py:123-213.

        Thin wrapper over :func:`_iteration_stats` (which the sampling
        loop uses directly so the whole per-iteration scalar bundle is
        one device call).
        """
        delta = jnp.asarray(delta)
        beta_prev = beta
        target_eff = float(self.current_target_efficiency(beta_prev))
        zeros = jnp.zeros_like(delta)
        stats = _iteration_stats(
            delta,
            zeros,
            zeros,
            beta_prev,
            min(beta + beta_step, 1.0),
            target_eff,
            beta_tolerance,
            min_beta_step,
            max_beta_step,
            adaptive=self.adaptive,
            adaptive_min_step=self.adaptive_min_beta_step,
        )
        beta_new, min_step, beta_star = map(
            float, jax.device_get(stats[:3])
        )
        _check_beta_progress(
            beta_new,
            beta_star,
            beta_prev,
            target_eff,
            beta_tolerance,
            min_step,
            self.adaptive,
        )
        return beta_new, min_step

    # -- tempered target ----------------------------------------------------

    def flow_state(self):
        """Traced flow state: (params, fitted data transform).

        Both change across `fit()` calls, so they ride through jit
        boundaries as ARGUMENTS — never closure constants — which lets
        one compiled sampler program serve many fit/sample rounds.
        """
        return (self.prior_flow.params, self.prior_flow.data_transform)

    def flow_log_prob_params(self):
        """(pure_fn, state) for the flow density, jit-stable identity."""
        flow = self.prior_flow
        arch = flow.architecture

        def flow_log_prob(flow_state, x):
            from ..flows.bijectors import standard_normal_log_prob

            params, data_transform = flow_state
            x_t, log_j = data_transform.forward(x)
            z, log_det = arch.forward(params, x_t)
            return standard_normal_log_prob(z) + log_det + log_j

        return flow_log_prob, self.flow_state()


    def _make_flow_imh_step(
        self,
        local_step,
        log_prob_fn,
        flow_state,
        beta,
        flow_move_every: int,
        needs_grad: bool,
    ):
        """Mix an independence-MH move from the FLOW into a local kernel.

        Each chain step is, with probability ``1/flow_move_every``, a
        Metropolis move whose proposal is a fresh draw from the flow
        proposal itself. For the tempered target
        ``p_t ∝ q^(1-beta) (L pi)^beta`` and proposal ``q``, the
        acceptance log-ratio collapses to ``beta * (w' - w)`` with
        ``w = logL + logPi - log q`` — the importance log-weight. The
        move teleports particles between modes the LOCAL kernel cannot
        cross, fixing the mode-weight relaxation bias of short
        Langevin/pCN chains on multimodal targets. Both component
        kernels leave ``p_t`` invariant, so the mixture does too.
        """
        flow_sample = self.flow_draw_fn()
        flow_log_prob, _ = self.flow_log_prob_params()
        log_likelihood = self.log_likelihood
        log_prior = self.log_prior
        make_view = self._make_view
        p_move = 1.0 / float(flow_move_every)

        def imh_step(state):
            n = state.x.shape[0]
            key, k_prop, k_acc = jax.random.split(state.key, 3)
            x_prop, lq_prop = flow_sample(flow_state, k_prop, n)
            # The chain may carry a wider dtype than the flow (x64
            # parity tests); keep the cond branches type-identical.
            x_prop = x_prop.astype(state.x.dtype)
            lq_prop = lq_prop.astype(state.x.dtype)
            view = make_view(x_prop)
            llpi_prop = (
                jnp.asarray(log_prior(view)).reshape(-1)
                + jnp.asarray(log_likelihood(view)).reshape(-1)
            ).astype(state.x.dtype)
            llpi_prop = jnp.where(
                jnp.isnan(llpi_prop), -jnp.inf, llpi_prop
            )
            lq_cur = flow_log_prob(flow_state, state.x).astype(
                state.x.dtype
            )
            # w' - w in one line: beta*w' - (log_p_t(x) - lq(x)) since
            # log_p_t - lq = beta * w.
            log_alpha = beta * (llpi_prop - lq_prop) - (
                state.log_prob - lq_cur
            )
            accept = (
                jnp.log(jax.random.uniform(k_acc, (n,), state.x.dtype))
                < log_alpha
            )
            new_x = jnp.where(accept[:, None], x_prop, state.x)
            lp_prop = (
                (1 - beta) * lq_prop + beta * llpi_prop
            ).astype(state.log_prob.dtype)
            new_lp = jnp.where(accept, lp_prop, state.log_prob)
            extra = n  # the proposal's target evaluation
            if needs_grad:
                # Gradient-carrying kernels (MALA/HMC) need the grad at
                # the post-move positions; refresh for the whole batch.
                new_lp, new_grad = _value_and_grad_batch(
                    log_prob_fn, new_x
                )
                extra += n
            else:
                new_grad = state.grad
            return state._replace(
                x=new_x,
                log_prob=new_lp,
                key=key,
                n_accept=state.n_accept + accept.astype(state.x.dtype),
                grad=new_grad,
                n_evals=(
                    None
                    if state.n_evals is None
                    else K.eval_counter_add(state.n_evals, extra)
                ),
            )

        def mixed_step(state):
            key, k_sel = jax.random.split(state.key)
            do_move = jax.random.bernoulli(k_sel, p_move)
            return jax.lax.cond(
                do_move, imh_step, local_step, state._replace(key=key)
            )

        return mixed_step

    def make_tempered_log_prob(self) -> Callable:
        """Tempered log-density in the preconditioned space.

        ``log_prob(flow_state, precond, z, beta)`` with NaN -> -inf
        (reference smc/base.py:507-519). Jittable when the user target is.
        """
        flow_log_prob, _ = self.flow_log_prob_params()
        log_likelihood = self.log_likelihood
        log_prior = self.log_prior
        make_view = self._make_view

        def tempered_log_prob(flow_state, precond, z, beta):
            if precond is None:
                x = z
                log_j = jnp.zeros(z.shape[0], dtype=z.dtype)
            else:
                x, log_j = precond.inverse(z)
            log_q = flow_log_prob(flow_state, x)
            view = make_view(x)
            log_pi = jnp.asarray(log_prior(view)).reshape(-1)
            log_l = jnp.asarray(log_likelihood(view)).reshape(-1)
            log_p = (1 - beta) * log_q + beta * (log_l + log_pi) + log_j
            log_p = jnp.where(jnp.isnan(log_p), -jnp.inf, log_p)
            return log_p.astype(z.dtype)

        return tempered_log_prob

    # -- mutation plumbing ---------------------------------------------------

    def _kernel_step_builder(self, log_prob_fn, ref):
        """Return (step_fn, init_step_size, needs_grad). Overridden."""
        raise NotImplementedError

    def mutate(
        self,
        samples: SMCSamples,
        beta: float,
        n_steps: int | None = None,
        waste_free: bool | None = None,
        windowed_tau: bool | None = None,
    ) -> SMCSamples:
        """Run the mutation kernel; re-evaluate densities at the end.

        Parity: reference smc/minipcn.py:69-135 (fit preconditioning to
        particles -> run chain in transformed space -> invert -> refresh
        log_q / log_prior / log_likelihood).

        ``windowed_tau=True`` records the windowed Sokal
        autocorrelation time instead of the online AR(1) surrogate
        (reference smc/emcee.py:66-84 parity). Waste-free mutations
        compute it from the chain they store anyway; otherwise only a
        strided subset of ``sampler_kwargs['tau_walkers']`` (default
        1024) walkers is stored for it, so the option is affordable at
        any population size.
        """
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        n_steps = int(n_steps or kwargs.get("n_steps") or 5 * self.dims)
        if waste_free is None:
            waste_free = bool(kwargs.get("waste_free", False))
        if windowed_tau is None:
            windowed_tau = (
                bool(kwargs.get("windowed_tau", False)) or waste_free
            )
        if kwargs.get("flow_moves"):
            if self.preconditioning_transform is not None:
                raise ValueError(
                    "flow_moves independence steps propose in the "
                    "flow's own space; run with preconditioning=None."
                )
            if not self.target_is_jittable():
                raise ValueError(
                    "flow_moves requires a jit-traceable target."
                )

        with self.profiler.phase("mutate/fit_precond"):
            z = self.fit_preconditioning_transform(samples.x)
        jittable = self.target_is_jittable()
        flow_state = self.flow_state()
        precond = self.preconditioning_transform
        beta_arr = jnp.asarray(beta, dtype=z.dtype)

        key = self.next_key()

        if jittable:
            # Chain + density refresh + diagnostics are ONE jitted
            # computation with ONE host fetch. The adapted step size
            # carries across temperatures so Robbins-Monro adaptation
            # converges instead of restarting every mutation.
            with self.profiler.phase("mutate/chain"):
                (
                    x,
                    log_q,
                    log_pi,
                    log_l,
                    acc_arr,
                    tau_arr,
                    mix_arr,
                    evals_arr,
                    any_nan_q,
                    any_nan_target,
                    step_carry,
                ) = self._mutate_on_device(
                    flow_state,
                    precond,
                    z,
                    beta_arr,
                    key,
                    n_steps,
                    kwargs,
                    self._step_size_carry,
                    waste_free=waste_free,
                    windowed_tau=windowed_tau,
                )
            self._step_size_carry = step_carry
            with self.profiler.phase("mutate/sync"):
                acceptance, tau, mixing, evals, nan_q, nan_target = (
                    jax.device_get(
                        (acc_arr, tau_arr, mix_arr, evals_arr,
                         any_nan_q, any_nan_target)
                    )
                )
            self.n_likelihood_evaluations += K.eval_counter_total(evals)
            self.history.mcmc_acceptance.append(float(acceptance))
            self.history.mcmc_autocorr.append(float(tau))
            self._last_chain_stats = (float(tau), float(mixing))
            self._last_waste_free = waste_free
            new = SMCSamples(
                x=x,
                beta=beta,
                dtype=self.dtype,
                parameters=self.parameters,
            )
            new.log_q = log_q
            new.log_prior = log_pi
            new.log_likelihood = log_l
            if bool(nan_q):
                raise ValueError("Log proposal contains NaN values")
            if bool(nan_target):
                raise ValueError(
                    "log_prior/log_likelihood returned NaN for mutated "
                    "particles (return -inf for invalid points instead)"
                )
            return new

        if waste_free:
            raise ValueError(
                "waste_free mutation requires a jit-traceable target."
            )
        if windowed_tau:
            logger.warning(
                "windowed_tau requires a jit-traceable target to store "
                "the mutation chains; recording the AR(1) surrogate "
                "tau instead."
            )
        with self.profiler.phase("mutate/fit_reference"):
            ref = K.fit_gaussian_reference(z)
        with self.profiler.phase("mutate/chain"):
            final_state, chain_stats = self._mutate_host(
                flow_state,
                precond,
                z,
                beta_arr,
                key,
                n_steps,
                kwargs,
                ref,
            )
        # Chain evaluations + the seeding log_prob_fn(z) call (the
        # post-chain refresh is auto-counted by evaluate_*), matching
        # the jitted path's (n_steps + 2) * n for fixed-cost kernels.
        self.n_likelihood_evaluations += (n_steps + 1) * z.shape[0]

        with self.profiler.phase("mutate/sync"):
            acceptance = float(
                jnp.mean(final_state.n_accept / max(n_steps, 1))
            )
        self.history.mcmc_acceptance.append(acceptance)
        self.history.mcmc_autocorr.append(float(chain_stats.tau))
        self._last_chain_stats = (
            float(chain_stats.tau), float(chain_stats.mixing)
        )
        self._last_waste_free = False

        x, _ = self.invert_preconditioning(final_state.x)
        new = SMCSamples(
            x=x,
            beta=beta,
            dtype=self.dtype,
            parameters=self.parameters,
        )
        new.log_q = self.prior_flow.log_prob(new.x)
        new.log_prior = self.evaluate_log_prior(new.x)
        new.log_likelihood = self.evaluate_log_likelihood(new.x)
        if bool(jnp.isnan(new.log_q).any()):
            raise ValueError("Log proposal contains NaN values")
        if bool(
            jnp.isnan(new.log_prior).any()
            | jnp.isnan(new.log_likelihood).any()
        ):
            # Same contract as the jitted path: a NaN would silently
            # poison every subsequent ESS/evidence reduction.
            raise ValueError(
                "log_prior/log_likelihood returned NaN for mutated "
                "particles (return -inf for invalid points instead)"
            )
        return new

    def _mutate_on_device(
        self, flow_state, precond, z, beta, key, n_steps, kwargs,
        step_size_carry=None, waste_free: bool = False,
        windowed_tau: bool = False,
    ):
        """Fully jitted mutation: one XLA computation for the whole chain.

        ``waste_free=True`` implements Dau & Chopin (2020) waste-free
        SMC: the caller resamples only M = n/k ancestors and EVERY
        state of each k-step chain joins the next population, so the
        mutation costs k-fold fewer target evaluations for the same
        output population size (the pooled states are within-chain
        correlated — the lineage tracker accounts for that).
        """
        use_carry = step_size_carry is not None
        cache_key = (
            n_steps,
            tuple(sorted(kwargs.items())),
            precond is None,
            use_carry,
            waste_free,
            windowed_tau,
        )
        if cache_key not in self._mutate_cache:
            tempered = self.make_tempered_log_prob()
            builder = self._kernel_step_builder
            flow_log_prob, _ = self.flow_log_prob_params()
            log_likelihood = self.log_likelihood
            log_prior = self.log_prior
            make_view = self._make_view
            make_imh = self._make_flow_imh_step
            flow_move_every = int(kwargs.get("flow_moves") or 0)
            tau_walkers = int(kwargs.get("tau_walkers") or 1024)
            if self.mesh is not None:
                from ..parallel.mesh import particle_sharding

                constraint = particle_sharding(self.mesh)
            else:
                constraint = None

            @partial(
                jax.jit,
                static_argnames=(
                    "n_steps", "use_carry", "waste_free", "windowed_tau"
                ),
            )
            def mutate_fn(
                flow_state, precond, z, beta, key, step0, n_steps,
                use_carry, waste_free, windowed_tau,
            ):
                log_prob_fn = lambda zz: tempered(  # noqa: E731
                    flow_state, precond, zz, beta
                )
                ref = K.fit_gaussian_reference(z)
                step_fn, init_step, needs_grad = builder(log_prob_fn, ref)
                if flow_move_every:
                    step_fn = make_imh(
                        step_fn,
                        log_prob_fn,
                        flow_state,
                        beta,
                        flow_move_every,
                        needs_grad,
                    )
                if not use_carry:
                    step0 = jnp.asarray(init_step, dtype=z.dtype)
                if needs_grad:
                    lp, grad = _value_and_grad_batch(log_prob_fn, z)
                else:
                    lp, grad = log_prob_fn(z), None
                state = K.ChainState(
                    x=z,
                    log_prob=lp,
                    key=key,
                    step_size=step0.astype(z.dtype),
                    n_accept=jnp.zeros(z.shape[0], dtype=z.dtype),
                    grad=grad,
                    n_evals=K.eval_counter_init(),
                )
                final, chain, stats = K.run_chain(
                    step_fn, state, n_steps,
                    # Waste-free pooling needs the full chain; a
                    # windowed tau alone only stores the strided
                    # tau_walkers subset (memory stays O(k * 1024 * d)
                    # at any population size).
                    store_chain=waste_free,
                    track_autocorr=True,
                    windowed_tau=windowed_tau,
                    tau_walkers=tau_walkers,
                )
                if waste_free:
                    # Pool every chain state, ancestor-major:
                    # (k, M, d) -> (M, k, d) -> (M*k, d). Ancestor-major
                    # keeps each mesh shard's pooled rows contiguous, so
                    # a sharded population re-tiles without any
                    # cross-device data movement.
                    z_out = jnp.swapaxes(chain, 0, 1).reshape(
                        -1, z.shape[1]
                    )
                    if constraint is not None:
                        z_out = jax.lax.with_sharding_constraint(
                            z_out, constraint
                        )
                else:
                    z_out = final.x
                # Post-chain density refresh fused into the same program
                # (one dispatch per mutation, not two).
                if precond is None:
                    x = z_out
                else:
                    x, _ = precond.inverse(z_out)
                log_q = flow_log_prob(flow_state, x)
                view = make_view(x)
                log_pi = jnp.asarray(log_prior(view)).reshape(-1)
                log_l = jnp.asarray(log_likelihood(view)).reshape(-1)
                acceptance = jnp.mean(final.n_accept / max(n_steps, 1))
                any_nan_q = jnp.isnan(log_q).any()
                any_nan_target = (
                    jnp.isnan(log_pi).any() | jnp.isnan(log_l).any()
                )
                # Initial density eval + chain evals (exact, even for
                # data-dependent NUTS trees) + post-chain refresh over
                # the output population. Split (2,) counter: exact past
                # 2**31 (large-n NUTS mutations overflow an int32).
                total_evals = K.eval_counter_add(
                    final.n_evals, z.shape[0] + x.shape[0]
                )
                return (
                    x,
                    log_q,
                    log_pi,
                    log_l,
                    acceptance,
                    stats.tau,
                    stats.mixing,
                    total_evals,
                    any_nan_q,
                    any_nan_target,
                    final.step_size,
                )

            self._mutate_cache[cache_key] = mutate_fn
        step0 = (
            step_size_carry
            if use_carry
            else jnp.asarray(0.0, dtype=z.dtype)
        )
        return self._mutate_cache[cache_key](
            flow_state,
            precond,
            z,
            beta,
            key,
            step0,
            n_steps=n_steps,
            use_carry=use_carry,
            waste_free=waste_free,
            windowed_tau=windowed_tau,
        )

    # -- fully on-device ladder ----------------------------------------------

    def _run_device_ladder(
        self,
        samples: SMCSamples,
        *,
        min_beta_step: float,
        max_beta_step: float,
        beta_tolerance: float,
        max_iters: int,
        checkpoint_callback=None,
        checkpoint_every: int | None = 1,
        store_history: bool = False,
    ) -> tuple[SMCSamples, int]:
        """Run the whole adaptive ladder as ONE compiled while_loop.

        Validations narrow this fast path to the cases it supports; the
        host ladder remains the general (and default) driver.
        ``store_history=True`` posts a per-rung population snapshot to
        ``history.sample_history`` through the same in-loop
        ``io_callback`` the checkpoints use (single-controller only).
        """
        if not self.adaptive:
            raise ValueError("device_ladder requires adaptive=True")
        if self.preconditioning_transform is not None:
            raise ValueError(
                "device_ladder does not support preconditioning "
                "transforms; use preconditioning=None"
            )
        if not self.target_is_jittable():
            raise ValueError(
                "device_ladder requires a jit-traceable "
                "log_likelihood/log_prior"
            )
        n_steps = int(
            self.sampler_kwargs.get("n_steps") or 5 * self.dims
        )
        waste_free = bool(self.sampler_kwargs.get("waste_free", False))
        if self._adaptive_target_efficiency:
            eff_lo, eff_hi = self._target_efficiency
        else:
            eff_lo = eff_hi = float(self._target_efficiency)

        # Per-iteration checkpointing from INSIDE the compiled
        # while_loop: an io_callback posts the mutated population +
        # history buffers to the host each temperature step. The sink
        # is read at call time so the compiled ladder stays cached
        # across runs with and without checkpointing enabled.
        if (
            checkpoint_callback is not None or store_history
        ) and jax.process_count() > 1:
            # io_callback would gather the globally-sharded population
            # to one device, which a multi-controller mesh cannot do
            # (and this stack's runtime rejects host send/recv under
            # shard_map outright). Instead: run the compiled ladder in
            # checkpoint_every-sized chunks and write shard-LOCAL
            # checkpoints between dispatches with the proven per-process
            # writer — per-iteration fault tolerance at pod scale.
            # Sample history needs one dispatch PER RUNG (the chunked
            # path only sees populations at chunk boundaries).
            return self._run_device_ladder_chunked(
                samples,
                n_steps=n_steps,
                waste_free=waste_free,
                min_beta_step=min_beta_step,
                max_beta_step=max_beta_step,
                beta_tolerance=beta_tolerance,
                max_iters=max_iters,
                chunk=(
                    1
                    if store_history
                    else max(int(checkpoint_every or 1), 1)
                ),
                checkpoint_callback=checkpoint_callback,
                eff_lo=eff_lo,
                eff_hi=eff_hi,
                store_history=store_history,
            )
        self._ladder_checkpoint_sink = checkpoint_callback
        self._ladder_store_history = store_history
        self._ladder_checkpoint_every = checkpoint_every
        self._ladder_history_base = copy.deepcopy(self.history)
        self._ladder_base_iteration = len(self.history.beta)
        self._ladder_base_evals = self.n_likelihood_evaluations
        self._ladder_n_steps = n_steps

        ladder = self._build_device_ladder(
            n_steps,
            max_iters,
            with_checkpoint=(checkpoint_callback is not None or store_history),
            waste_free=waste_free,
        )
        ladder_phase = self.profiler.phase("ladder")
        ladder_phase.__enter__()

        out = ladder(
            self.flow_state(),
            samples.x,
            samples.log_likelihood,
            samples.log_prior,
            samples.log_q,
            jnp.asarray(samples.beta or 0.0, dtype=samples.x.dtype),
            jnp.asarray(
                getattr(self, "_lineage_fraction", 1.0),
                dtype=samples.x.dtype,
            ),
            self.next_key(),
            jnp.asarray(min_beta_step, dtype=samples.x.dtype),
            jnp.asarray(max_beta_step, dtype=samples.x.dtype),
            jnp.asarray(beta_tolerance, dtype=samples.x.dtype),
            jnp.asarray(eff_lo, dtype=samples.x.dtype),
            jnp.asarray(eff_hi, dtype=samples.x.dtype),
            jnp.asarray(
                self.target_efficiency_rate, dtype=samples.x.dtype
            ),
            jnp.asarray(max_iters, jnp.int32),
            jnp.asarray(-1.0, dtype=samples.x.dtype),
        )
        # One host fetch for every scalar + history buffer.
        scalars = jax.device_get(
            (
                out["beta"],
                out["it"],
                out["stalled"],
                out["beta_h"],
                out["ess_h"],
                out["ess1_h"],
                out["ratio_h"],
                out["var_h"],
                out["acc_h"],
                out["tau_h"],
                out["lin_h"],
                out["f_lin"],
                out["ev_h"],
            )
        )
        (
            beta,
            it,
            stalled,
            beta_h,
            ess_h,
            ess1_h,
            ratio_h,
            var_h,
            acc_h,
            tau_h,
            lin_h,
            f_lin,
            ev_h,
        ) = scalars
        ladder_phase.__exit__(None, None, None)
        self._lineage_fraction = float(f_lin)
        it = int(it)
        n = len(samples)
        # Replay completed rungs into the history and eval counter
        # BEFORE any stall error: the diagnostics of the rungs that DID
        # run are exactly what the error message tells the user to
        # study.
        self._replay_ladder_history(
            self.history,
            it,
            beta_h, ess_h, ess1_h, ratio_h, var_h, acc_h, tau_h, lin_h,
        )
        for i in range(it):
            logger.info(
                "it %d - beta: %.6g  ESS: %.1f (%.2f eff)  "
                "logZ ratio: %.3f",
                i + 1,
                float(beta_h[i]),
                float(ess_h[i]),
                float(ess_h[i]) / n,
                float(ratio_h[i]),
            )
        self.n_likelihood_evaluations += int(
            sum(K.eval_counter_total(v) for v in ev_h[:it])
        )
        if bool(stalled):
            raise BetaScheduleError(
                "Device ladder stalled: beta did not increase. Consider "
                f"adjusting beta_tolerance ({beta_tolerance}), "
                f"min_beta_step ({min_beta_step}) or the target "
                "efficiency."
            )
        n_chains = n // n_steps if waste_free else n
        self.profiler.add("particle_steps", it * n_steps * n_chains)

        new = SMCSamples(
            x=out["x"],
            beta=float(beta),
            dtype=self.dtype,
            parameters=self.parameters,
        )
        new.log_q = out["lq"]
        new.log_prior = out["lpi"]
        new.log_likelihood = out["ll"]
        self._ladder_checkpoint_sink = None
        self._ladder_store_history = False
        return new, it

    def _run_device_ladder_chunked(
        self,
        samples: SMCSamples,
        *,
        n_steps: int,
        waste_free: bool,
        min_beta_step: float,
        max_beta_step: float,
        beta_tolerance: float,
        max_iters: int,
        chunk: int,
        checkpoint_callback,
        eff_lo: float,
        eff_hi: float,
        store_history: bool = False,
    ) -> tuple[SMCSamples, int]:
        """Compiled ladder with shard-local checkpoints on a pod.

        Runs the same compiled while_loop program in ``chunk``-sized
        dispatches; between dispatches every process writes ITS OWN
        population shard through ``checkpoint_callback`` (the
        ``save_checkpoint_to_hdf`` per-process contract) — no global
        gather ever happens, so per-iteration fault tolerance survives
        multi-controller meshes. One program is compiled (buffer =
        ``chunk``): the final partial chunk re-uses it via the traced
        ``iter_cap`` operand, and kernel step-size adaptation carries
        across chunks via the traced ``step0`` operand.
        """
        chunk = min(chunk, max_iters)
        ladder = self._build_device_ladder(
            n_steps,
            chunk,
            with_checkpoint=False,
            waste_free=waste_free,
        )
        dtype = samples.x.dtype
        n = len(samples)
        x, ll, lpi, lq = (
            samples.x,
            samples.log_likelihood,
            samples.log_prior,
            samples.log_q,
        )
        beta = jnp.asarray(samples.beta or 0.0, dtype=dtype)
        f_lin = jnp.asarray(
            getattr(self, "_lineage_fraction", 1.0), dtype=dtype
        )
        key = self.next_key()
        min_step = jnp.asarray(min_beta_step, dtype=dtype)
        step = jnp.asarray(-1.0, dtype=dtype)
        total_it = 0
        beta_host = float(samples.beta or 0.0)
        with self.profiler.phase("ladder"):
            while True:
                cap = min(chunk, max_iters - total_it)
                out = ladder(
                    self.flow_state(),
                    x,
                    ll,
                    lpi,
                    lq,
                    beta,
                    f_lin,
                    key,
                    min_step,
                    jnp.asarray(max_beta_step, dtype=dtype),
                    jnp.asarray(beta_tolerance, dtype=dtype),
                    jnp.asarray(eff_lo, dtype=dtype),
                    jnp.asarray(eff_hi, dtype=dtype),
                    jnp.asarray(
                        self.target_efficiency_rate, dtype=dtype
                    ),
                    jnp.asarray(cap, jnp.int32),
                    step,
                )
                (
                    beta_host,
                    it,
                    stalled,
                    beta_h,
                    ess_h,
                    ess1_h,
                    ratio_h,
                    var_h,
                    acc_h,
                    tau_h,
                    lin_h,
                    f_lin_host,
                    ev_h,
                ) = jax.device_get(
                    (
                        out["beta"],
                        out["it"],
                        out["stalled"],
                        out["beta_h"],
                        out["ess_h"],
                        out["ess1_h"],
                        out["ratio_h"],
                        out["var_h"],
                        out["acc_h"],
                        out["tau_h"],
                        out["lin_h"],
                        out["f_lin"],
                        out["ev_h"],
                    )
                )
                it = int(it)
                beta_host = float(beta_host)
                # Replay BEFORE any stall error (same discipline as the
                # single-dispatch path) and before the checkpoint, so
                # the written history matches the written population.
                self._replay_ladder_history(
                    self.history,
                    it,
                    beta_h, ess_h, ess1_h, ratio_h, var_h, acc_h,
                    tau_h, lin_h,
                )
                for i in range(it):
                    logger.info(
                        "it %d - beta: %.6g  ESS: %.1f (%.2f eff)  "
                        "logZ ratio: %.3f",
                        total_it + i + 1,
                        float(beta_h[i]),
                        float(ess_h[i]),
                        float(ess_h[i]) / n,
                        float(ratio_h[i]),
                    )
                self.n_likelihood_evaluations += int(
                    sum(K.eval_counter_total(v) for v in ev_h[:it])
                )
                self._lineage_fraction = float(f_lin_host)
                total_it += it
                x, ll, lpi, lq = (
                    out["x"], out["ll"], out["lpi"], out["lq"],
                )
                beta, f_lin = out["beta"], out["f_lin"]
                key, min_step, step = (
                    out["key"], out["min_step"], out["step"],
                )
                # Shard-local checkpoint between dispatches: the live
                # (sharded) arrays go into the state; serialization
                # writes per-process shards. Written BEFORE any stall
                # error so the completed rungs of a stalling chunk are
                # persisted (parity with the in-loop io_callback path,
                # which posts every completed rung).
                snap = SMCSamples(
                    x=x,
                    beta=beta_host,
                    dtype=self.dtype,
                    parameters=self.parameters,
                )
                snap.log_likelihood = ll
                snap.log_prior = lpi
                snap.log_q = lq
                if store_history:
                    # chunk == 1 in this mode: one dispatch per rung,
                    # so this IS the per-rung shard-local snapshot.
                    self.history.sample_history.append(
                        self._history_snapshot(snap)
                    )
                if checkpoint_callback is not None:
                    state = self.build_checkpoint_state(
                        snap,
                        len(self.history.beta),
                        meta={"beta": beta_host},
                    )
                    # Resume must continue from the ladder's own key
                    # stream, not the sampler-level key.
                    state["key"] = np.asarray(jax.random.key_data(key))
                    checkpoint_callback(state)
                if bool(stalled):
                    raise BetaScheduleError(
                        "Device ladder stalled: beta did not increase. "
                        "Consider adjusting beta_tolerance "
                        f"({beta_tolerance}), min_beta_step "
                        f"({min_beta_step}) or the target efficiency."
                    )
                if beta_host >= 1.0 or total_it >= max_iters or it == 0:
                    break
        n_chains = n // n_steps if waste_free else n
        self.profiler.add("particle_steps", total_it * n_steps * n_chains)
        new = SMCSamples(
            x=x,
            beta=beta_host,
            dtype=self.dtype,
            parameters=self.parameters,
        )
        new.log_q = lq
        new.log_prior = lpi
        new.log_likelihood = ll
        return new, total_it

    def _history_snapshot(self, samples: SMCSamples):
        """Host-resident population snapshot for ``sample_history``.

        Single-process: the full population as numpy (reference parity
        — history.py:244-346's sample-history diagnostics consume it).
        Multi-process: a global gather is impossible on a
        multi-controller mesh, so each process snapshots its OWN rows
        (the locally addressable shards) tagged with their global
        offsets; ``save_checkpoint_to_hdf`` writes them in the
        shard-dataset format and ``load_checkpoint_from_file``
        reassembles the full per-rung populations (round-5: shard-local
        sample history replaces the old hard error at pod scale).
        """
        if jax.process_count() == 1:
            return samples.to_numpy()

        def local_blocks(arr):
            if not isinstance(arr, jax.Array):
                a = np.asarray(arr)
                return a, [0], [a.shape[0]]
            seen = set()
            blocks = []
            for s in sorted(
                arr.addressable_shards,
                key=lambda s: s.index[0].start or 0,
            ):
                start = int(s.index[0].start or 0)
                if start in seen:
                    continue  # replicated copy of the same region
                seen.add(start)
                blocks.append((start, np.asarray(s.data)))
            return (
                np.concatenate([b for _, b in blocks], axis=0),
                [s for s, _ in blocks],
                [b.shape[0] for _, b in blocks],
            )

        x_local, starts, sizes = local_blocks(samples.x)
        snap = SMCSamples(
            x=x_local,
            beta=float(samples.beta or 0.0),
            dtype=self.dtype,
            parameters=self.parameters,
        )
        snap.x = x_local  # keep host-resident (skip __post_init__ put)
        for name in ("log_likelihood", "log_prior", "log_q"):
            value = getattr(samples, name, None)
            if value is not None:
                setattr(snap, name, local_blocks(value)[0])
        snap.shard_starts = starts
        snap.shard_sizes = sizes
        snap.global_n = int(samples.x.shape[0])
        return snap

    def _replay_ladder_history(
        self,
        history,
        it: int,
        beta_h, ess_h, ess1_h, ratio_h, var_h, acc_h, tau_h, lin_h,
    ) -> None:
        """Append ``it`` rungs of device-ladder buffers to a history.

        The single definition shared by the end-of-ladder replay and
        the in-loop checkpoint reconstruction, so a new history field
        cannot desynchronize the two."""
        for i in range(it):
            history.beta.append(float(beta_h[i]))
            history.eff_target.append(
                float(self.current_target_efficiency(float(beta_h[i])))
            )
            history.ess.append(float(ess_h[i]))
            history.ess_target.append(float(ess1_h[i]))
            history.log_norm_ratio.append(float(ratio_h[i]))
            history.log_norm_ratio_var.append(float(var_h[i]))
            history.mcmc_acceptance.append(float(acc_h[i]))
            history.mcmc_autocorr.append(float(tau_h[i]))
            history.lineage_fraction.append(float(lin_h[i]))

    def _ladder_checkpoint_host(
        self, x, ll, lpi, lq, beta, it, key_data, f_lin,
        beta_h, ess_h, ess1_h, ratio_h, var_h, acc_h, tau_h, lin_h,
        ev_h,
    ) -> None:
        """Host side of the device ladder's per-iteration checkpoint.

        Runs via ``io_callback`` from inside the compiled while_loop.
        Reconstructs the history recorded so far (pre-ladder prefix +
        the ladder's buffers) and hands a full checkpoint state to the
        sink registered for the current run.
        """
        sink = getattr(self, "_ladder_checkpoint_sink", None)
        store = getattr(self, "_ladder_store_history", False)
        if sink is None and not store:
            return
        it = int(it)
        if store:
            # Per-rung population snapshot (every iteration, no
            # cadence filter — matching the host ladder's appends).
            # io_callback already delivered HOST numpy arrays; keep
            # them host-resident by overwriting the constructor's
            # device-promoted fields (no device round-trips per rung).
            snap = SMCSamples(
                x=np.asarray(x),
                beta=float(beta),
                dtype=self.dtype,
                parameters=self.parameters,
            )
            snap.x = np.asarray(x, dtype=snap.dtype)
            snap.log_likelihood = np.asarray(ll, dtype=snap.dtype)
            snap.log_prior = np.asarray(lpi, dtype=snap.dtype)
            snap.log_q = np.asarray(lq, dtype=snap.dtype)
            self.history.sample_history.append(snap)
        if sink is None:
            return
        every = getattr(self, "_ladder_checkpoint_every", 1) or 1
        if (self._ladder_base_iteration + it) % every != 0:
            return  # honor checkpoint_every (host-side cadence filter)
        history = copy.deepcopy(self._ladder_history_base)
        self._replay_ladder_history(
            history,
            it,
            beta_h, ess_h, ess1_h, ratio_h, var_h, acc_h, tau_h, lin_h,
        )
        samples = SMCSamples(
            x=np.asarray(x),
            beta=float(beta),
            dtype=self.dtype,
            parameters=self.parameters,
        )
        samples.log_likelihood = np.asarray(ll)
        samples.log_prior = np.asarray(lpi)
        samples.log_q = np.asarray(lq)
        n = x.shape[0]
        state = {
            "sampler_class": type(self).__name__,
            "iteration": self._ladder_base_iteration + it,
            "samples": samples,
            "config": self.config_dict(),
            "parameters": self.parameters,
            "meta": {"beta": float(beta)},
            "key": np.asarray(key_data),
            "n_likelihood_evaluations": self._ladder_base_evals
            + int(
                sum(
                    K.eval_counter_total(v)
                    for v in np.asarray(ev_h)[:it]
                )
            ),
            "history": history,
            "sampler_kwargs": self.sampler_kwargs,
            "lineage_fraction": float(f_lin),
        }
        sink(state)

    def _build_device_ladder(
        self,
        n_steps: int,
        max_iters: int,
        with_checkpoint: bool = False,
        waste_free: bool = False,
    ):
        """Build (and cache) the compiled whole-ladder program."""
        cache_key = ("ladder", n_steps, max_iters, with_checkpoint,
                     waste_free,
                     # baked into the closure below — a second sample()
                     # call with a different min-step mode must not
                     # reuse a ladder compiled with the other one
                     self.adaptive_min_beta_step,
                     tuple(sorted(self.sampler_kwargs.items())))
        if cache_key in self._mutate_cache:
            return self._mutate_cache[cache_key]

        tempered = self.make_tempered_log_prob()
        builder = self._kernel_step_builder
        flow_log_prob, _ = self.flow_log_prob_params()
        log_likelihood = self.log_likelihood
        log_prior = self.log_prior
        make_view = self._make_view
        resampler = get_resampler(self.resampling_method)
        adaptive_min_step = self.adaptive_min_beta_step
        make_imh = self._make_flow_imh_step
        flow_move_every = int(self.sampler_kwargs.get("flow_moves") or 0)
        windowed_tau = waste_free or bool(
            self.sampler_kwargs.get("windowed_tau", False)
        )
        tau_walkers = int(self.sampler_kwargs.get("tau_walkers") or 1024)
        collective_impl = (
            self.resampling_impl
            if self.resampling_impl != "auto" and self.mesh is not None
            else None
        )
        mesh = self.mesh
        resampling_method = self.resampling_method
        if self.mesh is not None:
            from ..parallel.mesh import particle_sharding

            from ..parallel.mesh import replicated_sharding

            constraint = particle_sharding(self.mesh)
            replicated = replicated_sharding(self.mesh)
        else:
            constraint = None

        checkpoint_host_cb = self._ladder_checkpoint_host

        @jax.jit
        def ladder(
            flow_state,
            x,
            ll,
            lpi,
            lq,
            beta0,
            f_lin0,
            key,
            min_beta_step,
            max_beta_step,
            tol,
            eff_lo,
            eff_hi,
            eff_rate,
            # Runtime iteration cap (<= max_iters buffer) and incoming
            # adapted step size: traced so the chunked multi-process
            # driver re-dispatches ONE compiled program for partial
            # chunks and carries kernel adaptation across chunks.
            iter_cap,
            step0,
        ):
            n = x.shape[0]
            dtype = x.dtype
            step_init = step0.astype(dtype)
            zeros_h = jnp.zeros((max_iters,), dtype)
            state = {
                "x": x,
                "ll": ll,
                "lpi": lpi,
                "lq": lq,
                "beta": beta0.astype(dtype),
                "step": step_init,  # <0: use kernel default
                "key": key,
                "min_step": min_beta_step,
                "it": jnp.asarray(0, jnp.int32),
                "done": jnp.asarray(False),
                "stalled": jnp.asarray(False),
                "beta_h": zeros_h,
                "ess_h": zeros_h,
                "ess1_h": zeros_h,
                "ratio_h": zeros_h,
                "var_h": zeros_h,
                "acc_h": zeros_h,
                "tau_h": zeros_h,
                "lin_h": zeros_h,
                # effective independent-lineage fraction (see the host
                # ladder's _update_lineage_* for the recursion);
                # resumes carry the checkpointed value in.
                "f_lin": f_lin0.astype(dtype),
                # per-iteration exact eval counts as (lo, hi) split
                # int32 pairs (see kernels.EVAL_BASE); summed on host in
                # python ints so totals never lose integer exactness
                "ev_h": jnp.zeros((max_iters, 2), jnp.int32),
            }

            def cond(s):
                return (
                    (~s["done"]) & (~s["stalled"]) & (s["it"] < iter_cap)
                )

            def body(s):
                beta_prev = s["beta"]
                target_eff = eff_lo + (eff_hi - eff_lo) * (
                    beta_prev**eff_rate
                )
                (
                    beta,
                    min_step,
                    _beta_star,
                    ess,
                    ess1,
                    ratio,
                    var,
                ) = _iteration_stats(
                    s["ll"],
                    s["lpi"],
                    s["lq"],
                    beta_prev,
                    jnp.asarray(1.0, dtype),
                    target_eff,
                    tol,
                    s["min_step"],
                    max_beta_step,
                    adaptive=True,
                    adaptive_min_step=adaptive_min_step,
                )
                stalled = beta <= beta_prev

                key, rs_key, mut_key = jax.random.split(s["key"], 3)
                log_w = incremental_log_weights(
                    s["lq"], s["ll"], s["lpi"], beta_prev, beta
                )
                # Waste-free (Dau & Chopin 2020): resample only
                # M = n/k ancestors; the k-step chains are pooled back
                # to n rows below.
                n_chains = n // n_steps if waste_free else n
                if collective_impl is not None:
                    # Hand-rolled explicit-collective resample (ring or
                    # bucketed all_to_all); bit-identical to the GSPMD
                    # gather for the same key.
                    from ..ops.resampling import (
                        alltoall_resample_matrix,
                        ring_resample_matrix,
                    )

                    matrix_resample = (
                        ring_resample_matrix
                        if collective_impl == "ring"
                        else alltoall_resample_matrix
                    )
                    x_r = matrix_resample(
                        rs_key,
                        log_w.astype(dtype),
                        s["x"],
                        mesh,
                        method=resampling_method,
                        # Waste-free resamples only the M = n/k
                        # ancestors; the collectives emit n_out/S rows
                        # per shard.
                        n_out=n_chains,
                    )
                else:
                    if constraint is not None:
                        # Indices from one replicated weight vector, as
                        # the collective resamplers draw them (see
                        # SMCSamples.resample).
                        log_w = jax.lax.with_sharding_constraint(
                            log_w, replicated
                        )
                    idx = resampler(rs_key, log_w, n_chains)
                    x_r = s["x"][idx]
                    if constraint is not None:
                        # Keep the ladder's particle arrays sharded
                        # through the all-to-all resampling gather
                        # (GSPMD would otherwise replicate everything
                        # downstream).
                        x_r = jax.lax.with_sharding_constraint(
                            x_r, constraint
                        )

                lp_fn = lambda zz: tempered(  # noqa: E731
                    flow_state, None, zz, beta
                )
                ref = K.fit_gaussian_reference(x_r)
                step_fn, init_step, needs_grad = builder(
                    lp_fn, ref
                )
                if flow_move_every:
                    step_fn = make_imh(
                        step_fn,
                        lp_fn,
                        flow_state,
                        beta,
                        flow_move_every,
                        needs_grad,
                    )
                if needs_grad:
                    lp0, grad0 = _value_and_grad_batch(lp_fn, x_r)
                else:
                    lp0, grad0 = lp_fn(x_r), None
                step0 = jnp.where(
                    s["step"] > 0,
                    s["step"],
                    jnp.asarray(init_step, dtype=dtype),
                )
                chain0 = K.ChainState(
                    x=x_r,
                    log_prob=lp0,
                    key=mut_key,
                    step_size=step0,
                    n_accept=jnp.zeros(n_chains, dtype=dtype),
                    grad=grad0,
                    n_evals=K.eval_counter_init(),
                )
                final, chain, cstats = K.run_chain(
                    step_fn,
                    chain0,
                    n_steps,
                    # Waste-free pools the full chain; windowed_tau
                    # alone stores only the strided tau_walkers
                    # subset, so opting in costs O(k * 1024 * d)
                    # memory inside the while_loop at any n.
                    store_chain=waste_free,
                    track_autocorr=True,
                    windowed_tau=windowed_tau,
                    tau_walkers=tau_walkers,
                )
                tau = cstats.tau
                mixing = cstats.mixing
                if waste_free:
                    # Pool every chain state, ancestor-major (each
                    # mesh shard's pooled rows stay contiguous).
                    x_m = jnp.swapaxes(chain, 0, 1).reshape(
                        n, x.shape[1]
                    )
                    if constraint is not None:
                        x_m = jax.lax.with_sharding_constraint(
                            x_m, constraint
                        )
                else:
                    x_m = final.x
                lq_m = flow_log_prob(flow_state, x_m).astype(dtype)
                view = make_view(x_m)
                lpi_m = (
                    jnp.asarray(log_prior(view))
                    .reshape(-1)
                    .astype(dtype)
                )
                ll_m = (
                    jnp.asarray(log_likelihood(view))
                    .reshape(-1)
                    .astype(dtype)
                )
                acc = jnp.mean(final.n_accept / max(n_steps, 1))
                step_next = final.step_size.astype(dtype)
                ev_step = K.eval_counter_add(
                    final.n_evals, n_chains + n
                )

                # Lineage-degeneracy recursion (matches the host ladder,
                # including the one-particle floor).
                f_lin = jnp.maximum(
                    s["f_lin"] * jnp.maximum(ess, 1.0) / n, 1.0 / n
                )
                rho = jnp.maximum((tau - 1.0) / (tau + 1.0), 0.0)
                f_lin = f_lin + (1.0 - f_lin) * (
                    1.0 - rho ** (2 * n_steps)
                ) * mixing
                if waste_free:
                    # Pooled chain states hold at most ~k/tau effective
                    # draws per ancestor (host-parity division, see
                    # _update_lineage_after_mutation).
                    f_lin = f_lin / jnp.maximum(
                        jnp.minimum(
                            tau.astype(dtype), float(n_steps)
                        ),
                        1.0,
                    )

                i = s["it"]
                new_state = {
                    "x": x_m,
                    "ll": ll_m,
                    "lpi": lpi_m,
                    "lq": lq_m,
                    "beta": beta,
                    "step": step_next,
                    "key": key,
                    "min_step": min_step,
                    "it": i + 1,
                    "done": beta >= 1.0,
                    "stalled": stalled,
                    "beta_h": s["beta_h"].at[i].set(beta),
                    "ess_h": s["ess_h"].at[i].set(ess),
                    "ess1_h": s["ess1_h"].at[i].set(ess1),
                    "ratio_h": s["ratio_h"].at[i].set(ratio),
                    "var_h": s["var_h"].at[i].set(var / s["f_lin"]),
                    "acc_h": s["acc_h"].at[i].set(acc),
                    "tau_h": s["tau_h"].at[i].set(tau.astype(dtype)),
                    "lin_h": s["lin_h"].at[i].set(s["f_lin"]),
                    "f_lin": f_lin.astype(dtype),
                    "ev_h": s["ev_h"].at[i].set(ev_step),
                }
                if with_checkpoint:
                    # Post the mutated population + history buffers to
                    # the host each temperature step; the compiled
                    # program never leaves the device otherwise.
                    jax.experimental.io_callback(
                        checkpoint_host_cb,
                        None,
                        new_state["x"],
                        new_state["ll"],
                        new_state["lpi"],
                        new_state["lq"],
                        beta,
                        new_state["it"],
                        jax.random.key_data(key),
                        new_state["f_lin"],
                        new_state["beta_h"],
                        new_state["ess_h"],
                        new_state["ess1_h"],
                        new_state["ratio_h"],
                        new_state["var_h"],
                        new_state["acc_h"],
                        new_state["tau_h"],
                        new_state["lin_h"],
                        new_state["ev_h"],
                        ordered=True,
                    )
                return new_state

            return jax.lax.while_loop(cond, body, state)

        self._mutate_cache[cache_key] = ladder
        return ladder

    def _mutate_host(
        self, flow_state, precond, z, beta, key, n_steps, kwargs, ref
    ):
        """Host-loop mutation for non-jittable user targets."""
        tempered = self.make_tempered_log_prob()
        log_prob_fn = lambda zz: tempered(  # noqa: E731
            flow_state, precond, zz, beta
        )
        step_fn, init_step, needs_grad = self._kernel_step_builder(
            log_prob_fn, ref
        )
        if needs_grad:
            raise ValueError(
                "Gradient-based mutation kernels require a jit-traceable "
                "(differentiable) log-likelihood/log-prior."
            )
        state = K.ChainState(
            x=z,
            log_prob=log_prob_fn(z),
            key=key,
            step_size=jnp.asarray(init_step, dtype=z.dtype),
            n_accept=jnp.zeros(z.shape[0], dtype=z.dtype),
            grad=None,
        )
        # Same online deviation-based stats the jitted path tracks
        # in-scan (see run_chain: uncentered f32 moments cancel).
        zeros = jnp.zeros_like(z)
        prev_d, s1, s2, c1 = zeros, zeros, zeros, zeros
        for _ in range(n_steps):
            state = step_fn(state)
            delta = state.x - z
            s1 = s1 + delta
            s2 = s2 + jnp.square(delta)
            c1 = c1 + delta * prev_d
            prev_d = delta
        stats = K.ChainStats(
            tau=K.lag1_autocorr_time(s1, s2, c1, n_steps),
            mixing=K.chain_mixing_ratio(z, s1, s2, n_steps),
        )
        return state, stats

    # -- main loop (reference smc/base.py:215-488) --------------------------

    @track_calls
    def sample(
        self,
        n_samples: int,
        n_steps: int | None = None,
        adaptive: bool = True,
        min_beta_step: float | None = None,
        max_beta_step: float | None = None,
        max_n_steps: int | None = None,
        target_efficiency: float | tuple = 0.5,
        target_efficiency_rate: float = 1.0,
        n_final_samples: int | None = None,
        sampler_kwargs: dict | None = None,
        checkpoint_callback: Callable[[dict], None] | None = None,
        checkpoint_every: int | None = None,
        checkpoint_file_path: str | None = None,
        resume_from: str | bytes | dict | None = None,
        store_sample_history: bool | None = None,
        beta_tolerance: float = DEFAULT_BETA_TOLERANCE,
        device_ladder: bool | None = None,
        device_ladder_max_iters: int = 256,
        n_replicates: int | None = None,
    ) -> Samples:
        """Run adaptive-tempered SMC; returns weighted posterior Samples.

        ``device_ladder=True`` compiles the ENTIRE temperature ladder
        (bisection, resampling, mutation, evidence accumulation, history
        capture) into one ``lax.while_loop`` program — a single device
        dispatch for the whole run (~1.8x the host ladder on the bench
        problem). Requires a jittable target, adaptive scheduling, and
        no preconditioning transform; per-iteration checkpoints are
        written from inside the loop via ``io_callback``. The default
        (``None``) AUTO-SELECTS it whenever those conditions hold and
        per-iteration sample history is not requested; pass ``False``
        to force the host ladder. ``device_ladder_max_iters`` sizes the
        compiled ladder's history buffers (a run needing more rungs
        falls back to the host ladder with a warning); it composes with
        ``waste_free=True`` (in-loop ancestor pooling) and
        ``resampling_impl='ring'`` (explicit-collective resampling on a
        mesh).
        """
        if n_replicates is not None and n_replicates > 1:
            # Multi-run evidence error: k independent replicates (same
            # compiled programs — everything is cached by shape — fresh
            # PRNG stream each) whose between-run logZ spread covers
            # seed-dependent bias (e.g. mode collapse) that no
            # single-run delta-method bar can see.
            if resume_from is not None or checkpoint_callback is not None \
                    or checkpoint_file_path is not None:
                raise ValueError(
                    "n_replicates runs independent replicates; combine "
                    "it with checkpointing/resume per replicate "
                    "manually instead."
                )
            return self._sample_replicated(
                n_replicates,
                n_samples,
                dict(
                    n_steps=n_steps,
                    adaptive=adaptive,
                    min_beta_step=min_beta_step,
                    max_beta_step=max_beta_step,
                    max_n_steps=max_n_steps,
                    target_efficiency=target_efficiency,
                    target_efficiency_rate=target_efficiency_rate,
                    n_final_samples=n_final_samples,
                    sampler_kwargs=sampler_kwargs,
                    store_sample_history=store_sample_history,
                    beta_tolerance=beta_tolerance,
                    device_ladder=device_ladder,
                    device_ladder_max_iters=device_ladder_max_iters,
                ),
            )

        self.sampler_kwargs = dict(self.default_sampler_kwargs)
        self.sampler_kwargs.update(sampler_kwargs or {})
        n_final_steps = self.sampler_kwargs.pop("n_final_steps", None)
        self._step_size_carry = None  # re-adapt from defaults per run
        self._lineage_fraction = 1.0  # fresh population: all independent

        resumed = resume_from is not None
        if resumed:
            printable = (
                resume_from
                if isinstance(resume_from, str)
                else "checkpoint data"
            )
            logger.info("Resuming SMC sampling from checkpoint: %s", printable)
            samples, beta, iterations = self.restore_smc_checkpoint(
                resume_from
            )
            logger.info(
                "Resumed SMC sampling at iteration %d with beta=%.4f",
                iterations,
                beta,
            )
        else:
            init = self.draw_initial_samples(n_samples)
            samples = SMCSamples.from_samples(init, beta=0.0, dtype=self.dtype)
            beta = 0.0
            iterations = 0
            self.history = SMCHistory()

        if self.mesh is not None:
            samples.x = self.shard_array(samples.x)
            samples.log_q = self.shard_array(samples.log_q)
            samples.log_prior = self.shard_array(samples.log_prior)
            samples.log_likelihood = self.shard_array(samples.log_likelihood)

        if self.resampling_impl != "auto" and self.mesh is None:
            raise ValueError(
                f"resampling_impl={self.resampling_impl!r} needs a "
                "mesh-sharded population (pass mesh=... to the "
                "sampler); use 'auto' for single-device runs."
            )
        waste_free = bool(self.sampler_kwargs.get("waste_free", False))
        if waste_free:
            if not self.target_is_jittable():
                raise ValueError(
                    "waste_free SMC requires a jit-traceable target "
                    "(the pooled chain states are gathered in-program)."
                )
            k = int(self.sampler_kwargs.get("n_steps") or 5 * self.dims)
            n_now = len(samples)
            if n_now % k != 0:
                raise ValueError(
                    f"waste_free SMC pools k * (n/k) states back into "
                    f"the population: n_samples ({n_now}) must be "
                    f"divisible by the mutation n_steps ({k}); got "
                    f"remainder {n_now % k}. Adjust n_samples or "
                    "sampler_kwargs['n_steps']."
                )
            if self.mesh is not None and (n_now // k) % self.mesh.devices.size:
                raise ValueError(
                    f"waste_free SMC on a mesh shards the M = n/k "
                    f"ancestor population: M ({n_now // k}) must be "
                    f"divisible by the mesh size "
                    f"({self.mesh.devices.size})."
                )

        multiprocess = jax.process_count() > 1
        if store_sample_history is None:
            # Per-iteration sample snapshots are a device->host transfer
            # of the full particle array; record them by default only
            # for plot-sized runs (the reference always records, but its
            # workloads are O(500) particles). On a multi-controller
            # mesh the global array is not host-addressable at all.
            # The compiled ladder posts its per-rung snapshots through
            # the same in-loop io_callback the checkpoints use.
            store_sample_history = (
                n_samples <= 10_000 and not multiprocess
            )
        if store_sample_history:
            # On a multi-process mesh each process records its own
            # population shard per rung (_history_snapshot); checkpoint
            # files reassemble them to the full per-rung populations.
            self.history.sample_history.append(
                self._history_snapshot(samples)
            )

        nan_q, nan_pi, nan_l = jax.device_get(
            _nan_flags(
                samples.log_q, samples.log_prior, samples.log_likelihood
            )
        )
        for name, flag in (
            ("log_q", nan_q),
            ("log_prior", nan_pi),
            ("log_likelihood", nan_l),
        ):
            if bool(flag):
                raise ValueError(
                    f"{name.replace('_', ' ').capitalize()} contains NaN "
                    "values"
                )

        self.target_efficiency = target_efficiency
        self.target_efficiency_rate = target_efficiency_rate

        if n_steps is not None:
            beta_step = 1 / n_steps
        elif not adaptive:
            raise ValueError("Either n_steps or adaptive=True must be set")
        else:
            beta_step = math.nan
        self.adaptive = adaptive

        if min_beta_step is None:
            if max_n_steps is None:
                min_beta_step = 0.0
                self.adaptive_min_beta_step = False
            else:
                min_beta_step = 1 / max_n_steps
                self.adaptive_min_beta_step = True
        else:
            self.adaptive_min_beta_step = False

        if max_beta_step is not None:
            if max_beta_step <= 0 or max_beta_step >= 1:
                raise ValueError("max_beta_step must be in (0, 1)")
        else:
            max_beta_step = 1.0

        if checkpoint_callback is None and checkpoint_every is not None:
            checkpoint_callback = self.default_file_checkpoint_callback(
                checkpoint_file_path
            )
        if checkpoint_callback is not None and checkpoint_every is None:
            checkpoint_every = 1

        run_smc_loop = True
        if resumed:
            last_beta = self.history.beta[-1] if self.history.beta else beta
            if last_beta >= 1.0:
                run_smc_loop = False
                logger.info(
                    "Checkpoint beta %.4f indicates SMC loop already "
                    "completed; skipping to final mutation steps",
                    last_beta,
                )

        def maybe_checkpoint(force: bool = False):
            if checkpoint_callback is None:
                return
            should = force or (
                checkpoint_every is not None
                and checkpoint_every > 0
                and iterations % checkpoint_every == 0
            )
            if should:
                state = self.build_checkpoint_state(
                    samples, iterations, meta={"beta": beta}
                )
                checkpoint_callback(state)

        if device_ladder is None:
            # Per-iteration checkpoints work in every mode: in-loop
            # io_callback single-controller, chunked dispatches with
            # shard-local writes on multi-controller meshes.
            device_ladder = (
                self.adaptive
                and self.preconditioning_transform is None
                and not store_sample_history
                and self.target_is_jittable()
            )
            if device_ladder:
                logger.info(
                    "Auto-selected the single-dispatch device ladder "
                    "(jittable target, no preconditioning; pass "
                    "device_ladder=False to force the host ladder)."
                )

        if run_smc_loop and device_ladder:
            samples, ladder_iters = self._run_device_ladder(
                samples,
                min_beta_step=min_beta_step,
                max_beta_step=max_beta_step,
                beta_tolerance=beta_tolerance,
                # max_n_steps is a CUMULATIVE cap: a resumed run only
                # gets the remaining budget (>= 1, mirroring the host
                # loop's run-one-then-check semantics).
                max_iters=(
                    max(max_n_steps - iterations, 1)
                    if max_n_steps is not None
                    else device_ladder_max_iters
                ),
                checkpoint_callback=checkpoint_callback,
                checkpoint_every=checkpoint_every,
                store_history=store_sample_history,
            )
            # Resumed runs keep counting from the restored iteration.
            iterations += ladder_iters
            beta = samples.beta
            if beta < 1.0 and max_n_steps is None:
                # The compiled ladder is iteration-bounded by its
                # buffer size; a run that genuinely needs more rungs
                # continues on the (unbounded) host ladder instead of
                # silently returning a beta < 1 population.
                logger.warning(
                    "Device ladder hit its %d-iteration buffer at "
                    "beta=%.4f; continuing on the host ladder "
                    "(raise device_ladder_max_iters to keep such runs "
                    "compiled).",
                    device_ladder_max_iters,
                    beta,
                )
            else:
                run_smc_loop = False

        if run_smc_loop:
            while True:
                iterations += 1
                beta_prev = samples.beta
                target_eff = float(
                    self.current_target_efficiency(beta_prev)
                )
                beta_fixed = min(beta + beta_step, 1.0)
                with self.profiler.phase("determine_beta"):
                    stats = _iteration_stats(
                        samples.log_likelihood,
                        samples.log_prior,
                        samples.log_q,
                        beta_prev,
                        beta_fixed,
                        target_eff,
                        beta_tolerance,
                        min_beta_step,
                        max_beta_step,
                        adaptive=self.adaptive,
                        adaptive_min_step=self.adaptive_min_beta_step,
                    )
                    (
                        beta,
                        min_beta_step,
                        beta_star,
                        ess,
                        ess_at_one,
                        ratio,
                        var,
                    ) = map(float, jax.device_get(stats))
                _check_beta_progress(
                    beta,
                    beta_star,
                    beta_prev,
                    target_eff,
                    beta_tolerance,
                    min_beta_step,
                    self.adaptive,
                )
                self.history.eff_target.append(
                    float(self.current_target_efficiency(beta))
                )
                logger.info("it %d - beta: %s", iterations, beta)
                self.history.beta.append(float(beta))

                eff = ess / len(samples)
                if eff < 0.1:
                    logger.warning(
                        "it %d - Low sample efficiency: %.2f",
                        iterations,
                        eff,
                    )
                self.history.ess.append(ess)
                logger.info(
                    "it %d - ESS: %.1f (%.2f efficiency)",
                    iterations,
                    ess,
                    eff,
                )
                self.history.ess_target.append(ess_at_one)

                self.history.log_norm_ratio.append(ratio)
                # The delta-method variance assumes n independent
                # particles; after repeated resampling with imperfect
                # mutation mixing the population degenerates into fewer
                # independent lineages. Inflate by the tracked
                # lineage-degeneracy factor (see _update_lineage_*).
                self.history.log_norm_ratio_var.append(
                    var / self._lineage_fraction
                )
                self.history.lineage_fraction.append(
                    self._lineage_fraction
                )
                logger.info(
                    "it %d - Log evidence ratio: %.2f +/- %.2f "
                    "(lineage fraction %.2f)",
                    iterations,
                    ratio,
                    math.sqrt(max(var, 0.0) / self._lineage_fraction),
                    self._lineage_fraction,
                )

                n_before_resample = len(samples)
                with self.profiler.phase("resample"):
                    if waste_free:
                        # Waste-free SMC (Dau & Chopin 2020): resample
                        # only M = n/k ancestors; the mutation pools
                        # every state of the k-step chains back to a
                        # full-size population at k-fold fewer target
                        # evaluations.
                        k = int(
                            self.sampler_kwargs.get("n_steps")
                            or 5 * self.dims
                        )
                        n_ancestors = max(len(samples) // k, 1)
                        samples = samples.resample(
                            beta,
                            n_samples=n_ancestors,
                            key=self.next_key(),
                            method=self.resampling_method,
                            # M tiles the mesh (validated in sample()),
                            # so the hand-rolled collectives compose
                            # with waste-free ancestor selection too.
                            impl=self.resampling_impl,
                        )
                    else:
                        # sample() already rejected impl='ring' without
                        # a mesh, so the impl can route unconditionally.
                        samples = samples.resample(
                            beta,
                            key=self.next_key(),
                            method=self.resampling_method,
                            impl=self.resampling_impl,
                        )
                self._update_lineage_after_resample(
                    ess, n_before_resample
                )
                with self.profiler.phase("mutate"):
                    samples = self.mutate(samples, beta)
                self._update_lineage_after_mutation()
                k_steps = int(
                    self.sampler_kwargs.get("n_steps") or 5 * self.dims
                )
                # Waste-free runs only M = n/k chains for k steps.
                n_chains_done = (
                    len(samples) // k_steps if waste_free else len(samples)
                )
                self.profiler.add(
                    "particle_steps", n_chains_done * k_steps
                )
                if store_sample_history:
                    self.history.sample_history.append(
                        self._history_snapshot(samples)
                    )
                maybe_checkpoint()
                if beta == 1.0 or (
                    max_n_steps is not None and iterations >= max_n_steps
                ):
                    break

        if n_final_samples is not None and len(samples) != n_final_samples:
            logger.info("Generating %d final samples", n_final_samples)
            for name in ("log_likelihood", "log_prior", "log_q"):
                if not bool(jnp.isfinite(getattr(samples, name)).all()):
                    logger.warning(
                        "Final samples contain non-finite %s values", name
                    )
            if float(samples.beta or 0.0) < 1.0:
                # A max_n_steps-capped ladder stopped short of beta=1;
                # the final resample below reweights beta_last -> 1, so
                # that segment's evidence ratio must be accumulated too
                # (otherwise the returned posterior draws carry a logZ
                # missing the last factor).
                ratio = float(samples.log_evidence_ratio(1.0))
                var = float(samples.log_evidence_ratio_variance(1.0))
                logger.info(
                    "Accumulating the final beta %.4f -> 1 evidence "
                    "segment: %.3f",
                    float(samples.beta),
                    ratio,
                )
                self.history.log_norm_ratio.append(ratio)
                self.history.log_norm_ratio_var.append(
                    var / self._lineage_fraction
                )
            # Honor the explicit collective schedule for the final
            # draw too when the requested size tiles the mesh (an
            # arbitrary n_final_samples, e.g. 5000 on 8 shards, falls
            # back to the GSPMD gather — on a multi-controller mesh
            # that global gather is the only option anyway).
            final_impl = self.resampling_impl
            if (
                final_impl != "auto"
                and self.mesh is not None
                and n_final_samples % self.mesh.devices.size
            ):
                logger.debug(
                    "n_final_samples (%d) does not tile the %d-device "
                    "mesh; the final draw uses the GSPMD gather "
                    "instead of resampling_impl=%r.",
                    n_final_samples,
                    self.mesh.devices.size,
                    final_impl,
                )
                final_impl = "auto"
            final = samples.resample(
                1.0,
                n_samples=n_final_samples,
                key=self.next_key(),
                method=self.resampling_method,
                impl=final_impl,
            )
            # The final population's tau feeds no further evidence
            # increments, but it is the recorded mixing diagnostic of
            # the returned samples — default to the windowed estimate
            # on jittable targets (it only stores the strided
            # tau_walkers subset, so it is affordable at any n). An
            # explicit sampler_kwargs windowed_tau always wins, in
            # either direction.
            user_tau = self.sampler_kwargs.get("windowed_tau")
            final_windowed = (
                bool(user_tau)
                if user_tau is not None
                else self.target_is_jittable()
            )
            samples = self.mutate(
                final,
                1.0,
                n_steps=n_final_steps,
                waste_free=False,
                windowed_tau=final_windowed,
            )

        samples.log_evidence = float(np.sum(self.history.log_norm_ratio))
        samples.log_evidence_error = float(
            np.sqrt(np.sum(self.history.log_norm_ratio_var))
        )
        maybe_checkpoint(force=True)

        final_samples = samples.to_standard_samples()
        logger.info(
            "Log evidence: %.2f +/- %.2f",
            final_samples.log_evidence,
            final_samples.log_evidence_error,
        )
        mutate_s = self.profiler.phases["mutate"].total_s
        if mutate_s > 0:
            logger.info(
                "Throughput: %.3e particle-steps/s (mutation)",
                self.profiler.rate("particle_steps", "mutate"),
            )
        self.profiler.log_summary()
        return final_samples

    def _sample_replicated(
        self, k: int, n_samples: int, kwargs: dict
    ) -> Samples:
        """Run ``k`` independent SMC replicates; report the replicate
        mean logZ with the between-replicate standard error.

        Each replicate reuses every compiled program (identical shapes)
        and continues the sampler's key stream, so replicates are cheap
        on the device ladder and statistically independent. The
        reported ``log_evidence_error`` is the larger of the
        between-replicate SE (``std(logZ_r)/sqrt(k)``) and the pooled
        single-run bar — the former is the honest tier when mutation
        kernels mix poorly and individual runs collapse modes
        differently (context: reference smc/base.py:433-443 only ever
        reports the single-run delta-method bar).
        """
        histories = []

        def run_one():
            s = self.sample(n_samples, **kwargs)
            histories.append(self.history)
            return s, s.log_evidence, s.log_evidence_error

        # Statistics (consistency-scaled bar) shared with the PT
        # replicate tier: Sampler._replicate_evidence.
        result = self._replicate_evidence(k, run_one, "SMC")
        self.replicate_histories = histories
        return result

    # -- config / checkpoint -------------------------------------------------

    def config_dict(self, include_sample_calls: str | bool = "last") -> dict:
        # resume_from is scrubbed from recorded calls by the base class
        # (Sampler._scrub_sample_kwargs).
        config = super().config_dict(include_sample_calls)
        config["resampling_method"] = self.resampling_method
        config["resampling_impl"] = self.resampling_impl
        return config

    def _checkpoint_extra_state(self) -> dict:
        extra = {
            "history": copy.deepcopy(self.history),
            "sampler_kwargs": getattr(self, "sampler_kwargs", None),
            "lineage_fraction": getattr(self, "_lineage_fraction", 1.0),
        }
        # A fitted flow-preconditioning transform is run state the
        # resumed sampler cannot re-derive — persist the transport map.
        transform = self.preconditioning_transform
        payload_fn = getattr(transform, "checkpoint_payload", None)
        if payload_fn is not None:
            extra["preconditioning_state"] = payload_fn()
        return extra

    # -- lineage-degeneracy tracking -----------------------------------------
    #
    # The per-step evidence variance (delta method) divides by n as if
    # every particle were independent. They are not: each resampling
    # collapses the population onto ~ESS distinct ancestors, and a
    # mutation kernel with integrated autocorrelation time tau over k
    # steps only decorrelates duplicates by a factor 1 - rho^(2k)
    # (two chains started at the same point keep cross-correlation
    # rho^k * rho^k). We track the effective independent-lineage
    # FRACTION f recursively:
    #
    #   resample:  f <- f * (ESS / n)
    #   mutation:  f <- f + (1 - f) * (1 - rho^(2k)),  rho = (tau-1)/(tau+1)
    #
    # and report Var / f instead of Var. Perfect mixing (tau = 1) keeps
    # f = 1 and changes nothing; a stuck kernel (tau ~ k) makes f decay
    # geometrically so the reported error honestly blows up instead of
    # pretending n independent particles (TODO.md "Statistics": the
    # mala_smc@10-step underestimate).

    def _update_lineage_after_resample(self, ess: float, n: int) -> None:
        """``n`` is the PRE-resample population size (the ESS is
        measured on it); the fraction is capped at 1 — a waste-free
        step resamples M < n ancestors, where ess/M could exceed 1."""
        self._lineage_fraction = min(
            max(
                self._lineage_fraction * max(ess, 1.0) / n, 1.0 / n
            ),
            1.0,
        )

    def _update_lineage_after_mutation(self) -> None:
        stats = getattr(self, "_last_chain_stats", None)
        if stats is None:
            return
        tau, mixing = stats
        k = int(self.sampler_kwargs.get("n_steps") or 5 * self.dims)
        rho = max((tau - 1.0) / (tau + 1.0), 0.0)
        # Decorrelation needs BOTH a short autocorrelation time and
        # chains that actually traverse the target: a kernel mixing
        # fast inside one mode (rho small, mixing small) cannot make
        # resampled duplicates independent samples of the whole
        # distribution.
        recovered = (1.0 - rho ** (2 * k)) * mixing
        self._lineage_fraction += (
            1.0 - self._lineage_fraction
        ) * recovered
        if getattr(self, "_last_waste_free", False):
            # Waste-free pooling keeps every chain state: the pooled
            # population holds at most ~k/tau effectively independent
            # draws per ancestor chain.
            self._lineage_fraction /= max(
                min(float(self.history.mcmc_autocorr[-1]), k), 1.0
            )

    def restore_smc_checkpoint(
        self, source
    ) -> tuple[SMCSamples, float, int]:
        samples, state = self.restore_from_checkpoint(source)
        meta = state.get("meta", {}) if isinstance(state, dict) else {}
        beta = meta.get("beta") if isinstance(meta, dict) else None
        if beta is None:
            beta = state.get("beta", 0.0)
        iteration = state.get("iteration", 0)
        self.history = state.get("history", SMCHistory())
        if state.get("sampler_kwargs"):
            self.sampler_kwargs = state["sampler_kwargs"]
        self._lineage_fraction = float(
            state.get("lineage_fraction", 1.0)
        )
        if state.get("preconditioning_state") is not None:
            from ..transforms import get_transform_class

            payload = state["preconditioning_state"]
            self.preconditioning_transform = get_transform_class(
                payload["class"]
            ).from_checkpoint_payload(payload)
            logger.info(
                "Restored the fitted preconditioning transport map "
                "from the checkpoint."
            )
        samples = SMCSamples.from_samples(
            samples, beta=beta, dtype=self.dtype
        )
        return samples, beta, iteration


def _value_and_grad_batch(log_prob_fn, x):
    """Batched value+gradient of a summed log-density."""

    def total(x):
        lp = log_prob_fn(x)
        return jnp.sum(lp), lp

    (_, lp), grad = jax.value_and_grad(total, has_aux=True)(x)
    return lp, grad


# ---------------------------------------------------------------------------
# Concrete SMC samplers
# ---------------------------------------------------------------------------


class PCNSMC(SMCSampler):
    """SMC with (t)pCN mutation — the default sampler.

    Parity: reference ``MiniPCNSMC`` (smc/minipcn.py:14-135); defaults
    n_steps = 5 * dims, target acceptance 0.234, ``step_fn="tpcn"``.
    """

    @property
    def default_sampler_kwargs(self):
        return {
            "n_steps": 5 * self.dims,
            "target_acceptance_rate": 0.234,
            "step_fn": "tpcn",
            "nu": 5.0,
            "adaptation_rate": 0.1,
            "initial_step_size": 0.5,
        }

    def _kernel_step_builder(self, log_prob_fn, ref):
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        step_name = kwargs.get("step_fn", "tpcn")
        target = kwargs.get("target_acceptance_rate", 0.234)
        rate = kwargs.get("adaptation_rate", 0.1)
        init_step = kwargs.get("initial_step_size", 0.5)
        if step_name == "pcn":
            step = partial(
                K.pcn_step,
                log_prob_fn=log_prob_fn,
                ref=ref,
                target_acceptance=target,
                adaptation_rate=rate,
            )
        elif step_name == "tpcn":
            step = partial(
                K.tpcn_step,
                log_prob_fn=log_prob_fn,
                ref=ref,
                nu=kwargs.get("nu", 5.0),
                target_acceptance=target,
                adaptation_rate=rate,
            )
        else:
            raise ValueError(f"Unknown pCN step function: {step_name}")
        return step, init_step, False


class EnsembleSMC(SMCSampler):
    """SMC with affine-invariant ensemble (stretch) mutation.

    Parity: reference ``EmceeSMC`` (smc/emcee.py:13-89), with the serial
    emcee library replaced by the batched red-black stretch move.
    """

    @property
    def default_sampler_kwargs(self):
        return {"n_steps": 5 * self.dims, "a": 2.0}

    def _kernel_step_builder(self, log_prob_fn, ref):
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        step = partial(
            K.stretch_step,
            log_prob_fn=log_prob_fn,
            a=kwargs.get("a", 2.0),
        )
        return step, 1.0, False


class GradientSMC(SMCSampler):
    """SMC with gradient-based mutation: RWMH, MALA, HMC, or NUTS.

    Parity: reference ``BlackJAXSMC`` (smc/blackjax.py:13-358) with
    native kernels. ``kernel="nuts"`` is a real No-U-Turn sampler —
    per-particle data-dependent tree doubling under ``vmap``
    (:func:`aspire_tpu.samplers.kernels.nuts_trajectory`), with
    ``max_depth`` bounding the trajectory so every shape stays static.
    """

    kernel_name = "hmc"

    @property
    def default_sampler_kwargs(self):
        return {
            "n_steps": 5 * self.dims,
            "kernel": self.kernel_name,
            "step_size": 0.1,
            "n_leapfrog": 10,  # hmc only
            "max_depth": 8,  # nuts only
            "adaptation_rate": 0.05,
        }

    def _kernel_step_builder(self, log_prob_fn, ref):
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        kernel = kwargs.get("kernel", self.kernel_name)
        init_step = kwargs.get("step_size", 0.1)
        rate = kwargs.get("adaptation_rate", 0.05)
        if kernel == "rwmh":
            step = partial(
                K.rwmh_step,
                log_prob_fn=log_prob_fn,
                ref=ref,
                target_acceptance=kwargs.get(
                    "target_acceptance_rate", 0.234
                ),
                adaptation_rate=rate,
            )
            return step, init_step, False

        def lp_and_grad(x):
            return _value_and_grad_batch(log_prob_fn, x)

        if kernel == "mala":
            step = partial(
                K.mala_step,
                log_prob_and_grad_fn=lp_and_grad,
                target_acceptance=kwargs.get(
                    "target_acceptance_rate", 0.574
                ),
                adaptation_rate=rate,
            )
            return step, init_step, True
        if kernel == "hmc":
            step = partial(
                K.hmc_step,
                log_prob_and_grad_fn=lp_and_grad,
                n_leapfrog=kwargs.get("n_leapfrog", 10),
                target_acceptance=kwargs.get(
                    "target_acceptance_rate", 0.651
                ),
                adaptation_rate=rate,
                jitter_trajectory=kwargs.get("jitter_trajectory", False),
            )
            return step, init_step, True
        if kernel == "nuts":
            step = partial(
                K.nuts_step,
                log_prob_fn=log_prob_fn,
                max_depth=kwargs.get("max_depth", 8),
                target_acceptance=kwargs.get(
                    "target_acceptance_rate", 0.8
                ),
                adaptation_rate=rate,
            )
            return step, init_step, True
        raise ValueError(f"Unknown gradient kernel: {kernel}")


class RWMHSMC(GradientSMC):
    kernel_name = "rwmh"


class MALASMC(GradientSMC):
    kernel_name = "mala"


class HMCSMC(GradientSMC):
    kernel_name = "hmc"


class NUTSSMC(GradientSMC):
    kernel_name = "nuts"
