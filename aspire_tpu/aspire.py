"""Orchestrator: the user-facing ``Aspire`` facade.

Parity with the reference orchestrator (``/root/reference/src/aspire/
aspire.py:34-1152``): holds the problem definition, builds the flow and
sampler, drives fit / sample_posterior / sample_flow, and implements the
three resume modes (``resume_from_file`` aspire.py:572, primed
``sample_posterior`` call 451-465, and the ``auto_checkpoint`` context
manager 647-746 with fit-skip 239-243). Single-namespace (JAX) design:
the reference's xp/device plumbing is gone; dtype remains first-class.
"""

from __future__ import annotations

import copy
import logging
from contextlib import contextmanager
from inspect import signature
from typing import Any, Callable

from .checkpointing import CheckpointPolicy, ResumeState, open_run_file
from .flows import Flow, default_architecture_for_backend, get_flow_class
from .history import FlowHistory
from .io import AspireFile, save_dict_to_hdf5
from .samples import Samples
from .samplers import get_sampler_class as _registry_get_sampler_class
from .transforms import (
    CompositeTransform,
    FlowPreconditioningTransform,
    FlowTransform,
)
from .utils import function_id

logger = logging.getLogger("aspire_tpu")


class Aspire:
    """Accelerated sequential posterior inference via reuse, on device.

    Parameters
    ----------
    log_likelihood, log_prior : Callable
        Functions of a Samples-like object (``samples.x`` is ``(n, d)``)
        returning ``(n,)`` log-densities. Jittable functions run fully on
        device; plain numpy/scipy callables are evaluated on host.
    dims : int
        Number of parameters.
    parameters : list[str], optional
        Parameter names.
    periodic_parameters : list[str], optional
        Names of periodic parameters (wrapped, zero-Jacobian).
    prior_bounds : dict[str, tuple], optional
        Per-parameter bounds; enables bounded -> unbounded transforms.
    bounded_to_unbounded : bool
        Whether to unbound bounded parameters for the flow.
    bounded_transform : str
        "logit" or "probit".
    flow : Flow, optional
        Pre-built flow (otherwise built on first ``fit``).
    flow_backend : str
        Flow architecture/backend name ("maf", "nsf", "realnvp", ...).
    flow_matching : bool
        Use a flow-matching CNF instead of a discrete flow.
    eps : float
        Clamp epsilon for bounded transforms.
    dtype : str, optional
        Global dtype for samples/flow/transforms.
    prng_impl : str, optional
        JAX PRNG implementation for the SAMPLER key streams (the hot
        path: mutation proposals, resampling, accept draws). Its speed
        against threefry on the H100 is not measured; its bitstream is NOT guaranteed stable
        across XLA versions, so cross-version run reproducibility needs
        the default (threefry). Flow *training* keys stay on the
        default impl (one-time cost, not the hot path).
    **kwargs
        Extra keyword arguments forwarded to the flow constructor.
    """

    def __init__(
        self,
        *,
        log_likelihood: Callable,
        log_prior: Callable,
        dims: int,
        parameters: list[str] | None = None,
        periodic_parameters: list[str] | None = None,
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "logit",
        flow: Flow | None = None,
        flow_backend: str = "maf",
        flow_matching: bool = False,
        eps: float = 1e-6,
        dtype: Any = None,
        seed: int | None = None,
        prng_impl: str | None = None,
        **kwargs: Any,
    ) -> None:
        self.log_likelihood = log_likelihood
        self.log_prior = log_prior
        self.dims = dims
        self.parameters = (
            list(parameters)
            if parameters is not None
            else [f"x_{i}" for i in range(dims)]
        )
        self.periodic_parameters = periodic_parameters
        self.prior_bounds = prior_bounds
        self.bounded_to_unbounded = bounded_to_unbounded
        self.bounded_transform = bounded_transform
        self.flow_backend = flow_backend
        self.flow_matching = flow_matching
        # Reference-only knobs with no meaning in the single-namespace
        # JAX design (aspire.py:91-92: xp array backend, torch device
        # string). Swallow them with a pointer instead of letting them
        # surface later as a flow-constructor TypeError mid-migration.
        for gone, hint in (
            ("xp", "arrays are always JAX"),
            ("device", "placement is mesh/sharding-driven"),
        ):
            if gone in kwargs:
                kwargs.pop(gone)
                logger.warning(
                    "Aspire(%s=...) has no effect in aspire_tpu (%s); "
                    "ignoring. See docs/migration.md.",
                    gone,
                    hint,
                )
        self.flow_kwargs = kwargs
        self.eps = eps
        self.dtype = dtype
        self.seed = seed
        self.prng_impl = prng_impl

        self._flow = flow
        # Monotone counter bumped on every flow replacement: the
        # sampler compile-cache key uses it instead of id(self.flow),
        # which a free-then-realloc at the same address could alias.
        self._flow_generation = 0
        self._sampler = None
        self._sampler_sig = None
        #: retained by fit(); consumed by replicated_evidence's
        #: flow-refit cycles.
        self.training_samples: Samples | None = None
        # Context-scoped run-file state: a write policy for the current
        # checkpoint file (if any) and a primed continuation. Both are
        # plain slots swapped wholesale by ``auto_checkpoint`` — never
        # ad-hoc attributes.
        self._checkpoints: CheckpointPolicy | None = None
        self._resume: ResumeState | None = None
        self._skip_fit = False

    # -- properties ---------------------------------------------------------

    @property
    def flow(self) -> Flow | None:
        return self._flow

    @flow.setter
    def flow(self, flow: Flow) -> None:
        self._flow = flow
        self._flow_generation += 1

    @property
    def sampler(self):
        return self._sampler

    @property
    def n_likelihood_evaluations(self) -> int | None:
        if self._sampler is not None:
            return self._sampler.n_likelihood_evaluations
        return None

    # -- samples ------------------------------------------------------------

    def convert_to_samples(
        self,
        x,
        log_likelihood=None,
        log_prior=None,
        log_q=None,
        evaluate: bool = True,
    ) -> Samples:
        samples = Samples(
            x=x,
            parameters=self.parameters,
            log_likelihood=log_likelihood,
            log_prior=log_prior,
            log_q=log_q,
            dtype=self.dtype,
        )
        if evaluate:
            if log_prior is None:
                logger.info("Evaluating log prior")
                samples.log_prior = self.log_prior(samples)
            if log_likelihood is None:
                logger.info("Evaluating log likelihood")
                samples.log_likelihood = self.log_likelihood(samples)
            if samples.log_q is not None:
                samples.compute_weights()
        return samples

    # -- flow ---------------------------------------------------------------

    def init_flow(self) -> None:
        FlowClass = get_flow_class(
            backend=self.flow_backend, flow_matching=self.flow_matching
        )
        data_transform = FlowTransform(
            parameters=self.parameters,
            prior_bounds=self.prior_bounds,
            bounded_to_unbounded=self.bounded_to_unbounded,
            bounded_transform=self.bounded_transform,
            eps=self.eps,
            dtype=self.dtype,
        )
        flow_kwargs = dict(self.flow_kwargs)
        if FlowClass is Flow:
            flow_kwargs.setdefault(
                "architecture",
                default_architecture_for_backend(self.flow_backend),
            )
        if self.dtype is not None:
            flow_kwargs.setdefault("dtype", str(self.dtype))
        if self.seed is not None:
            flow_kwargs.setdefault("key", self.seed)
        logger.info(
            "Configuring %s with kwargs: %s", FlowClass.__name__, flow_kwargs
        )
        self.flow = FlowClass(
            dims=self.dims,
            data_transform=data_transform,
            **flow_kwargs,
        )

    def fit(
        self,
        samples: Samples,
        checkpoint_path: str | None = None,
        checkpoint_save_config: bool = True,
        overwrite: bool = False,
        **kwargs: Any,
    ) -> FlowHistory:
        """Fit the flow proposal to existing posterior samples."""
        if self.parameters is None and samples.parameters is not None:
            self.parameters = list(samples.parameters)

        if self.flow is None:
            self.init_flow()
        elif self._skip_fit and not overwrite:
            logger.info(
                "Skipping flow training because a checkpointed flow was "
                "loaded."
            )
            return FlowHistory()

        x = samples.x if hasattr(samples, "x") else samples
        self.training_samples = samples
        logger.info("Training with %d samples", len(x))
        history = self.flow.fit(x, **kwargs)

        policy = self._checkpoints
        if checkpoint_path is None and policy is not None:
            checkpoint_path = policy.path
            checkpoint_save_config = policy.owes("config")
        # The ledger only tracks the POLICY's file: writes a caller
        # routes to some other explicit path never settle it.
        on_policy_file = (
            policy is not None and str(checkpoint_path) == policy.path
        )
        if checkpoint_path is not None:
            with AspireFile(checkpoint_path, "a") as h5_file:
                if checkpoint_save_config:
                    self.save_config(h5_file, "aspire_config")
                    if on_policy_file:
                        policy.settle("config")
                if "flow" in h5_file and overwrite:
                    del h5_file["flow"]
                if "flow" not in h5_file:
                    self.save_flow(h5_file)
                    if on_policy_file:
                        policy.settle("flow")
        return history

    def sample_flow(self, n_samples: int = 1) -> Samples:
        """Sample from the flow proposal only (reference aspire.py:891)."""
        if self.flow is None:
            self.init_flow()
        x, log_q = self.flow.sample_and_log_prob(n_samples)
        return Samples(
            x=x,
            log_q=log_q,
            parameters=self.parameters,
            dtype=self.dtype,
        )

    # -- samplers -----------------------------------------------------------

    def get_sampler_class(self, sampler_type: str) -> type:
        return _registry_get_sampler_class(sampler_type)

    def init_sampler(
        self,
        sampler_type: str,
        preconditioning: str | None = None,
        preconditioning_kwargs: dict | None = None,
        **kwargs: Any,
    ):
        """Build a sampler with its preconditioning transform.

        Preconditioning parity: reference aspire.py:330-368 — "none",
        "standard"/"default" (composite: periodic wrap + optional bounded
        + optional affine), or "flow" (transport-map preconditioning).
        """
        SamplerClass = self.get_sampler_class(sampler_type)

        if sampler_type != "importance" and preconditioning is None:
            preconditioning = "default"
        preconditioning = (
            preconditioning.lower() if preconditioning else None
        )

        if preconditioning is None or preconditioning == "none":
            transform = None
        elif preconditioning in ("standard", "default"):
            preconditioning_kwargs = dict(preconditioning_kwargs or {})
            preconditioning_kwargs.setdefault("affine_transform", False)
            preconditioning_kwargs.setdefault("bounded_to_unbounded", False)
            preconditioning_kwargs.setdefault("bounded_transform", "logit")
            transform = CompositeTransform(
                parameters=self.parameters,
                prior_bounds=self.prior_bounds,
                periodic_parameters=self.periodic_parameters,
                dtype=self.dtype,
                **preconditioning_kwargs,
            )
            if transform.is_identity:
                # No periodic/bounded/affine component is active: drop
                # the no-op so samplers keep their transform-free fast
                # paths (e.g. the single-dispatch device ladder).
                logger.debug(
                    "Default preconditioning is a no-op for this "
                    "problem; running without a transform."
                )
                transform = None
        elif preconditioning == "flow":
            # Defaults inherited from the Aspire problem spec; anything
            # the user passes in preconditioning_kwargs overrides them.
            transform_kwargs = dict(
                affine_transform=False,
                parameters=self.parameters,
                flow_backend=self.flow_backend,
                flow_kwargs=self.flow_kwargs,
                flow_matching=self.flow_matching,
                periodic_parameters=self.periodic_parameters,
                bounded_to_unbounded=self.bounded_to_unbounded,
                prior_bounds=self.prior_bounds,
                dtype=self.dtype,
            )
            transform_kwargs.update(preconditioning_kwargs or {})
            transform = FlowPreconditioningTransform(**transform_kwargs)
        else:
            raise ValueError(f"Unknown preconditioning: {preconditioning}")

        if self.seed is not None:
            # Distinct stream from the flow's key (which uses self.seed)
            # so proposal sampling and kernel randomness never collide.
            kwargs.setdefault("rng", self.seed + 1)
        if self.prng_impl is not None:
            kwargs.setdefault("prng_impl", self.prng_impl)
        return SamplerClass(
            log_likelihood=self.log_likelihood,
            log_prior=self.log_prior,
            dims=self.dims,
            prior_flow=self.flow,
            dtype=self.dtype,
            preconditioning_transform=transform,
            parameters=self.parameters,
            **kwargs,
        )

    def sample_posterior(
        self,
        n_samples: int | None = 1000,
        sampler: str = "importance",
        return_history: bool = False,
        preconditioning: str | None = None,
        preconditioning_kwargs: dict | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 1,
        checkpoint_save_config: bool = True,
        **kwargs: Any,
    ):
        """Draw posterior samples (reference aspire.py:383-570)."""
        resume = self._resume
        if resume is not None:
            if sampler == "importance" and resume.sampler_type:
                # The default sampler argument yields to the sampler the
                # interrupted run actually used.
                sampler = resume.sampler_type
            if "resume_from" not in kwargs:
                kwargs["resume_from"] = resume.state
                kwargs.update(resume.sample_overrides)
                if resume.n_samples is not None and n_samples == 1000:
                    n_samples = resume.n_samples

        SamplerClass = self.get_sampler_class(sampler)
        # Collect ctor params across the MRO: subclasses forward through
        # *args/**kwargs, so the subclass signature alone misses base
        # params like ``mesh``/``rng`` (they would be silently dropped).
        init_params: dict = {}
        for klass in SamplerClass.__mro__:
            init = klass.__dict__.get("__init__")
            if init is not None:
                init_params.update(signature(init).parameters)
        # Arguments init_sampler supplies itself must not be routable
        # (they would arrive twice and raise TypeError).
        reserved = {
            "self",
            "args",
            "kwargs",
            "log_likelihood",
            "log_prior",
            "dims",
            "prior_flow",
            "dtype",
            "preconditioning_transform",
            "parameters",
        }
        sampler_init_kwargs = {
            k: v
            for k, v in kwargs.items()
            if k in init_params and k not in reserved
        }
        kwargs = {
            k: v for k, v in kwargs.items() if k not in sampler_init_kwargs
        }

        # Reuse the sampler (and with it every compiled program: draw,
        # mutation chains, device ladder) across sample_posterior calls
        # when the configuration is unchanged. Flow params and the
        # fitted data transform are traced ARGUMENTS of those programs,
        # so refitting the flow between calls stays correct; replacing
        # the flow object itself invalidates the cache.
        sampler_sig = (
            sampler,
            self._flow_generation,
            preconditioning,
            preconditioning_kwargs,
            sampler_init_kwargs,
        )
        if (
            self._sampler is None
            or getattr(self, "_sampler_sig", None) != sampler_sig
        ):
            self._sampler = self.init_sampler(
                sampler,
                preconditioning=preconditioning,
                preconditioning_kwargs=preconditioning_kwargs,
                **sampler_init_kwargs,
            )
            self._sampler_sig = sampler_sig
        else:
            logger.debug(
                "Reusing %s sampler (compiled programs cached)", sampler
            )
            self._sampler.n_likelihood_evaluations = 0
            if self.seed is not None:
                # Fresh-sampler semantics: a fixed seed gives identical
                # runs, so re-seed the reused sampler's stream.
                from .samplers.base import _as_key

                self._sampler.key = _as_key(
                    self.seed + 1, impl=self.prng_impl
                )
        self._last_sampler_type = sampler

        policy = self._checkpoints
        if checkpoint_path is None and policy is not None:
            checkpoint_path = policy.path
            checkpoint_every = policy.every
            checkpoint_save_config = policy.owes("config")
        on_policy_file = (
            policy is not None and str(checkpoint_path) == policy.path
        )
        if checkpoint_path is not None:
            sample_params = signature(self._sampler.sample).parameters
            if not {"checkpoint_file_path", "checkpoint_every"}.issubset(
                sample_params
            ):
                logger.warning(
                    "Sampler %s does not support checkpointing. Checkpoint "
                    "will not be saved.",
                    sampler,
                )
            else:
                kwargs.setdefault("checkpoint_file_path", checkpoint_path)
                kwargs.setdefault("checkpoint_every", checkpoint_every)
            # The flow AND the aspire config go into the file BEFORE
            # sampling so a run killed mid-flight still resumes with
            # its proposal and can rebuild the orchestrator
            # (resume_from_file needs the config; the post-sample
            # write below refreshes both with run outcomes).
            with AspireFile(checkpoint_path, "a") as h5_file:
                if checkpoint_save_config and (
                    "aspire_config" not in h5_file
                ):
                    self.save_config(h5_file, "aspire_config")
                if self.flow is not None and (
                    not on_policy_file or policy.owes("flow")
                ):
                    if "flow" not in h5_file:
                        self.save_flow(h5_file)
                    if on_policy_file:
                        policy.settle("flow")

        # Drop kwargs the sampler's sample() signature does not accept.
        sample_params = signature(self._sampler.sample).parameters
        has_var_kw = any(
            p.kind is p.VAR_KEYWORD for p in sample_params.values()
        )
        if not has_var_kw:
            unknown = {
                k: v for k, v in kwargs.items() if k not in sample_params
            }
            if unknown:
                logger.warning(
                    "Ignoring kwargs not supported by %s.sample: %s",
                    sampler,
                    sorted(unknown),
                )
            kwargs = {k: v for k, v in kwargs.items() if k in sample_params}

        samples = self._sampler.sample(n_samples, **kwargs)
        self._last_sample_posterior_kwargs = {
            "n_samples": n_samples,
            "sampler": sampler,
            "return_history": return_history,
            "preconditioning": preconditioning,
            "preconditioning_kwargs": preconditioning_kwargs,
            "sampler_init_kwargs": sampler_init_kwargs,
            "sample_kwargs": copy.deepcopy(
                {k: v for k, v in kwargs.items() if k != "resume_from"}
            ),
        }

        if checkpoint_path is not None:
            with AspireFile(checkpoint_path, "a") as h5_file:
                if checkpoint_save_config:
                    self.save_config(h5_file, "aspire_config")
                    if on_policy_file:
                        policy.settle("config")
                # The sampler record (type + recorded sample call) is
                # refreshed after every run so a resume always knows
                # which sampler and n_samples to continue with — even
                # when the aspire config itself was written earlier by
                # ``fit``.
                self.save_sampler_config(h5_file, include_sample_calls="last")
                if self.flow is not None and (
                    not on_policy_file or policy.owes("flow")
                ):
                    if "flow" not in h5_file:
                        self.save_flow(h5_file)
                    if on_policy_file:
                        policy.settle("flow")

        samples.parameters = self.parameters
        logger.info("Sampled %d samples from the posterior", len(samples))
        logger.info(
            "Number of likelihood evaluations: %s",
            self.n_likelihood_evaluations,
        )
        logger.info("Sample summary:\n%s", samples)
        if return_history:
            # Samplers without a history object (importance, the MCMC
            # family) return None rather than raising — the caller
            # asked for a pair.
            return samples, getattr(self._sampler, "history", None)
        return samples

    def replicated_evidence(
        self,
        n_replicates: int,
        *,
        refit_flow: bool = True,
        fit_kwargs: dict | None = None,
        **sample_kwargs: Any,
    ):
        """Between-run logZ spread over fully independent pipelines.

        The sampler-level ``n_replicates`` reruns the SAMPLER k times
        but shares one fitted flow, so flow-fit seed variation — the
        measured dominant systematic on funnel-like geometry (see
        TODO.md) — is invisible to its bar. This tier re-initializes
        and refits the flow each cycle (fresh init key on the retained
        ``training_samples``) before sampling, then reports the same
        consistency-scaled combination on the returned samples
        (``log_evidence`` / ``log_evidence_error`` /
        ``log_evidence_replicates``).

        Each cycle re-initializes the flow's parameters IN PLACE
        (:meth:`Flow.reinitialize`): params are traced arguments of the
        compiled sampler programs, so the refit replicates share every
        compiled program — the honest bar costs k fits, not k compiles.
        ``sample_kwargs`` are passed to :meth:`sample_posterior`
        verbatim (``sampler=``, ``sampler_kwargs=``, ...); PT runs are
        combined on their stepping-stone estimate.
        """
        if n_replicates < 2:
            raise ValueError("n_replicates must be >= 2")
        # (Nesting the sampler-level tier is impossible by signature:
        # a keyword n_replicates binds to this method's own argument.)
        if refit_flow and self.training_samples is None:
            raise ValueError(
                "replicated_evidence(refit_flow=True) needs a prior "
                "fit() so the training samples are retained."
            )
        from .samplers.base import combine_replicates

        sampler_name = sample_kwargs.get("sampler", "importance")
        base_seed = self.seed if self.seed is not None else 0
        fit_kwargs = dict(fit_kwargs or {})
        logzs, errs = [], []
        result = None
        # Replicate refits are DIAGNOSTIC: they must never touch the
        # user's checkpoint file (fit() would otherwise route writes
        # through the active policy and clobber the primary fitted
        # flow on disk). Stash the policy for the duration.
        saved_policy = self._checkpoints
        self._checkpoints = None
        # overwrite: a checkpointed-flow skip must not silently turn
        # the refit replicates into reruns of one fit (training only —
        # no file is written with the policy stashed).
        fit_kwargs.setdefault("overwrite", True)
        try:
            for r in range(n_replicates):
                logger.info(
                    "Pipeline replicate %d/%d", r + 1, n_replicates
                )
                if refit_flow:
                    if self.flow is None:
                        self.init_flow()
                    self.flow.reinitialize(base_seed + 101 + r)
                    self.fit(self.training_samples, **fit_kwargs)
                result = self.sample_posterior(**sample_kwargs)
                if sampler_name in ("ptmcmc", "parallel_tempered"):
                    lz, err = result.log_evidence_stepping_stone()
                else:
                    lz = float(result.log_evidence)
                    err = float(result.log_evidence_error)
                logzs.append(float(lz))
                errs.append(float(err))
        finally:
            self._checkpoints = saved_policy
        return combine_replicates(result, logzs, errs, "pipeline")

    # -- pool ---------------------------------------------------------------

    def enable_pool(self, pool, **kwargs):
        """Parallelize a host likelihood over a multiprocessing pool."""
        from .utils import PoolHandler

        return PoolHandler(self, pool, **kwargs)

    # -- config / persistence -----------------------------------------------

    def config_dict(self, include_sampler_config: bool = False, **kwargs):
        config = {
            "log_likelihood": function_id(self.log_likelihood),
            "log_prior": function_id(self.log_prior),
            "dims": self.dims,
            "parameters": self.parameters,
            "periodic_parameters": self.periodic_parameters,
            "prior_bounds": self.prior_bounds,
            "bounded_to_unbounded": self.bounded_to_unbounded,
            "bounded_transform": self.bounded_transform,
            "flow_matching": self.flow_matching,
            "flow_backend": self.flow_backend,
            "flow_kwargs": self.flow_kwargs,
            "eps": self.eps,
            "dtype": str(self.dtype) if self.dtype else None,
            "prng_impl": self.prng_impl,
        }
        if include_sampler_config:
            if hasattr(self, "_last_sampler_type"):
                config["sampler_type"] = self._last_sampler_type
            if self.sampler is None:
                raise ValueError("Sampler has not been initialized.")
            config["sampler_config"] = self.sampler.config_dict(**kwargs)
        return config

    def save_config(self, h5_file, path: str = "aspire_config", **kwargs):
        if path in h5_file:
            del h5_file[path]
        save_dict_to_hdf5(h5_file, path, self.config_dict(**kwargs))

    def save_sampler_config(
        self, h5_file, path: str = "sampler_config", **kwargs
    ):
        config = self.sampler.config_dict(**kwargs) if self.sampler else {}
        if hasattr(self, "_last_sampler_type"):
            config["sampler_type"] = self._last_sampler_type
        if path in h5_file:
            del h5_file[path]
        save_dict_to_hdf5(h5_file, path, config)

    def save_flow(self, h5_file, path: str = "flow") -> None:
        if self.flow is None:
            raise ValueError("Flow has not been initialized.")
        self.flow.save(h5_file, path=path)

    def load_flow(self, h5_file, path: str = "flow") -> None:
        FlowClass = get_flow_class(
            backend=self.flow_backend, flow_matching=self.flow_matching
        )
        self.flow = FlowClass.load(h5_file, path=path)

    def save_config_to_json(self, filename: str) -> None:
        import json

        with open(filename, "w") as f:
            json.dump(self.config_dict(), f, indent=4, default=str)


    # -- resume (three modes; behavior of reference aspire.py:572-746) ------

    @classmethod
    def resume_from_file(
        cls,
        file_path: str,
        *,
        log_likelihood: Callable,
        log_prior: Callable,
        sampler: str | None = None,
        checkpoint_path: str = "checkpoint",
        checkpoint_dset: str = "state",
        flow_path: str = "flow",
        config_path: str = "aspire_config",
        resume_kwargs: dict | None = None,
    ) -> "Aspire":
        """Recreate an orchestrator from a run file and prime resume.

        Mode 1 of the three resume modes: the stored config rebuilds the
        ``Aspire`` object (callables are never persisted and must be
        re-supplied), the stored flow is loaded, and — when a checkpoint
        is present — the next ``sample_posterior()`` call continues the
        interrupted run with the recorded sampler and ``n_samples``.
        """
        from .checkpointing import RunFile

        run = RunFile(
            file_path,
            config_group=config_path,
            flow_group=flow_path,
            checkpoint_group=checkpoint_path,
            state_dset=checkpoint_dset,
        )
        aspire = cls(
            log_likelihood=log_likelihood,
            log_prior=log_prior,
            **run.constructor_kwargs(cls),
        )
        run.load_flow_into(aspire, required=True)
        aspire._resume = run.resume_state(
            sampler=sampler, overrides=resume_kwargs
        )
        # Future checkpoints continue into the same file; config and
        # flow are already there, so the policy owes neither.
        aspire._checkpoints = CheckpointPolicy(
            path=str(file_path), config=False, flow=False
        )
        return aspire

    @contextmanager
    def auto_checkpoint(
        self,
        path: str,
        every: int = 1,
        save_config: bool = True,
        save_flow: bool = True,
        resume: bool = False,
    ):
        """Scope a checkpoint policy (and optionally a resume) to a block.

        Mode 3: within the context, ``fit`` and ``sample_posterior``
        default their checkpoint target to ``path``. With
        ``resume=True`` and an existing file, the stored flow is loaded
        (making ``fit`` a no-op) and the stored checkpoint primes the
        next ``sample_posterior`` call. On exit the orchestrator's
        previous policy/resume/fit-skip state returns untouched.
        """
        outer = (self._checkpoints, self._resume, self._skip_fit)
        self._checkpoints = CheckpointPolicy(
            path=str(path),
            every=every,
            config=save_config,
            flow=save_flow,
        )
        if resume:
            run = open_run_file(str(path))
            if run is not None:
                logger.info("Resuming run file %s", path)
                self._resume = run.resume_state()
                if run.config is not None:
                    self._checkpoints.settle("config")
                if run.load_flow_into(self, required=False):
                    self._checkpoints.settle("flow")
                # Reference parity (aspire.py:699-733): a resumed
                # context skips retraining whenever a flow is in hand —
                # loaded from the file or already on the orchestrator.
                self._skip_fit = self.flow is not None
        try:
            yield self
        finally:
            self._checkpoints, self._resume, self._skip_fit = outer
