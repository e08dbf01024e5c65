"""Sampler base class: problem definition, eval counting, checkpointing.

Parity with reference ``samplers/base.py:20-287``: the sampler owns the
user ``log_likelihood``/``log_prior`` callables (which receive a
:class:`~aspire_tpu.samples.Samples` view and return a ``(n,)`` array),
the flow proposal, the preconditioning transform, a likelihood-evaluation
counter, config capture, and the checkpoint protocol (state capture ->
pickled bytes at ``/checkpoint/state`` in an HDF5 file -> restore).

Addition over the reference: the sampler detects whether the user callables are
jit-traceable. If so, density evaluations fuse into the on-device sampler
kernels; otherwise they are evaluated on host exactly like the reference
(still vectorized over the whole particle array per call).
"""

from __future__ import annotations

import logging
import pickle
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..samples import Samples
from ..utils import CallHistory, function_id, resolve_dtype

logger = logging.getLogger("aspire_tpu")


def combine_replicates(result, logzs, errs, label: str):
    """Attach the replicate-mean logZ with the consistency-scaled bar.

    PDG-style scaling: ``std/sqrt(k)`` when the between-replicate
    spread agrees with the single-run bars, the UN-shrunk dispersion
    when the replicates scatter beyond them (shared systematics —
    e.g. every short chain collapses modes a little differently around
    a common bias). The single source of truth for every replicate
    tier (SMC, PT, and the facade's flow-refit tier).
    """
    import math

    k = len(logzs)
    between_sd = float(np.std(logzs, ddof=1))
    single_rms = float(np.sqrt(np.mean(np.square(errs))))
    consistent = between_sd <= 1.5 * single_rms
    between = between_sd / math.sqrt(k) if consistent else between_sd
    single = single_rms / math.sqrt(k)
    result.log_evidence = float(np.mean(logzs))
    result.log_evidence_error = max(between, single)
    result.log_evidence_replicates = np.asarray(logzs)
    result.log_evidence_error_single = single_rms
    logger.info(
        "Replicated %s log evidence: %.3f +/- %.3f (between-run "
        "%.3f, single-run rms %.3f)",
        label,
        result.log_evidence,
        result.log_evidence_error,
        between,
        single_rms,
    )
    return result


class _SamplesView:
    """Lightweight Samples-like view passed to user callables.

    Exposes ``.x`` (and ``parameters``) without triggering the data-model
    machinery, so user likelihoods written against the reference API
    (``samples.x``) work unchanged inside ``jit`` traces.
    """

    __slots__ = ("x", "parameters")

    def __init__(self, x, parameters=None):
        self.x = x
        self.parameters = parameters

    def __len__(self):
        return self.x.shape[0]

    @property
    def dims(self):
        return self.x.shape[-1]


class Sampler:
    """Base sampler.

    Parameters
    ----------
    log_likelihood, log_prior : Callable
        Functions of a Samples-like object returning ``(n,)`` arrays.
    dims : int
        Number of parameters.
    prior_flow : Flow
        Trained flow proposal.
    dtype : Any, optional
        Sample dtype.
    parameters : list[str], optional
        Parameter names.
    preconditioning_transform : BaseTransform, optional
        Invertible map applied before MCMC mutation.
    rng : int | jax.Array | np.random.Generator, optional
        Seed / PRNG key for the sampler's random stream.
    prng_impl : str, optional
        JAX PRNG implementation for the sampler's key stream (e.g.
        ``"rbg"``; default: JAX's default, threefry2x32). ``"rbg"`` uses
        XLA's RngBitGenerator (its speed on the H100 is not measured),
        at a documented cost: the rbg BITSTREAM
        is not guaranteed stable across XLA/jaxlib versions, so runs
        are reproducible only within one software version (threefry is
        stable across versions). Checkpoints record the impl and
        resume validates it. Ignored when ``rng`` is already a key.
    """

    def __init__(
        self,
        log_likelihood: Callable,
        log_prior: Callable,
        dims: int,
        prior_flow,
        dtype: Any = None,
        parameters: list[str] | None = None,
        preconditioning_transform=None,
        rng: Any = None,
        mesh=None,
        prng_impl: str | None = None,
    ):
        self.log_likelihood = log_likelihood
        self.log_prior = log_prior
        self.dims = dims
        self.prior_flow = prior_flow
        self.dtype = resolve_dtype(dtype)
        self.parameters = parameters
        self.preconditioning_transform = preconditioning_transform
        self.n_likelihood_evaluations = 0
        self.prng_impl = prng_impl
        self.key = _as_key(rng, impl=prng_impl)
        self.mesh = mesh
        # Phase wall-clock accumulator (§5 observability); SMC
        # re-assigns its own but every sampler gets one.
        from ..profiling import Profiler

        self.profiler = Profiler()
        self._call_history: dict[str, CallHistory] = {}
        self._jittable_target: bool | None = None

    # -- sharding ------------------------------------------------------------

    def shard_array(self, x):
        """Shard the leading (particle) axis over the mesh, if one is set.

        With a mesh, every downstream jitted computation runs SPMD: XLA
        inserts psum trees for the scalar reductions and handles the
        resampling gather's cross-shard movement (SURVEY.md §2.2, §5).
        """
        if self.mesh is None:
            return x
        from ..parallel.mesh import particle_sharding

        import jax as _jax

        n_shards = self.mesh.devices.size
        if x.ndim >= 1 and x.shape[0] % n_shards == 0:
            return _jax.device_put(x, particle_sharding(self.mesh))
        return x

    # -- PRNG --------------------------------------------------------------

    def next_key(self) -> jax.Array:
        self.key, sub = jax.random.split(self.key)
        return sub

    def key_impl_name(self) -> str:
        """Name of the PRNG implementation behind ``self.key``.

        Derived from the key itself (not the constructor argument): a
        key passed in as ``rng`` carries its own impl regardless of
        ``prng_impl``, and this is the name checkpoints must record.
        """
        return str(jax.random.key_impl(self.key))

    # -- target evaluation -------------------------------------------------

    def _make_view(self, x) -> _SamplesView:
        return _SamplesView(x, parameters=self.parameters)

    def evaluate_log_likelihood(self, x) -> jax.Array:
        """Evaluate the user likelihood on ``(n, d)`` positions."""
        self.n_likelihood_evaluations += int(x.shape[0])
        out = self.log_likelihood(self._make_view(x))
        return jnp.asarray(out).reshape(-1)

    def evaluate_log_prior(self, x) -> jax.Array:
        out = self.log_prior(self._make_view(x))
        return jnp.asarray(out).reshape(-1)

    def target_is_jittable(self) -> bool:
        """True if user log-likelihood/prior trace under jit.

        Determines whether mutation chains run fully on device (fused
        XLA) or fall back to host evaluation per step.
        """
        if self._jittable_target is None:
            try:
                x = jnp.zeros((2, self.dims), dtype=self.dtype)

                def probe(x):
                    view = self._make_view(x)
                    return (
                        jnp.asarray(self.log_likelihood(view)),
                        jnp.asarray(self.log_prior(view)),
                    )

                jax.eval_shape(probe, x)
                self._jittable_target = True
            except Exception as err:  # noqa: BLE001 - any trace failure
                logger.info(
                    "Target density is not jit-traceable (%s); sampler "
                    "will evaluate it on host per step.",
                    type(err).__name__,
                )
                self._jittable_target = False
        return self._jittable_target

    # -- preconditioning ---------------------------------------------------

    def fit_preconditioning_transform(self, x) -> jax.Array:
        if self.preconditioning_transform is None:
            return jnp.asarray(x)
        return self.preconditioning_transform.fit(x)

    def apply_preconditioning(self, x):
        if self.preconditioning_transform is None:
            return jnp.asarray(x)
        return self.preconditioning_transform.forward(x)[0]

    def invert_preconditioning(self, z):
        if self.preconditioning_transform is None:
            return jnp.asarray(z), jnp.zeros(z.shape[0], dtype=z.dtype)
        return self.preconditioning_transform.inverse(z)

    # -- initial sampling --------------------------------------------------

    def _draw_batch(self, n_samples: int):
        """One proposal batch + densities, fully on device when possible.

        For jittable targets the flow sampling pass and both target
        densities run as ONE jitted computation (a single dispatch
        instead of ~10 eager ops per attempt); otherwise falls back to
        the eager path.
        """
        key = self.next_key()
        if not self.target_is_jittable():
            x, log_q = self.prior_flow.sample_and_log_prob(
                n_samples, key=key
            )
            log_prior = self.evaluate_log_prior(x)
            log_likelihood = self.evaluate_log_likelihood(x)
            return x, log_q, log_prior, log_likelihood

        if getattr(self, "_draw_batch_jit", None) is None:
            base_draw = self.flow_draw_fn()
            log_likelihood_fn = self.log_likelihood
            log_prior_fn = self.log_prior
            make_view = self._make_view

            @partial(jax.jit, static_argnames=("n",))
            def draw(params, data_transform, key, n):
                x, log_q = base_draw((params, data_transform), key, n)
                view = make_view(x)
                log_pi = jnp.asarray(log_prior_fn(view)).reshape(-1)
                log_l = jnp.asarray(log_likelihood_fn(view)).reshape(-1)
                return x, log_q, log_pi, log_l

            self._draw_batch_jit = draw

        x, log_q, log_pi, log_l = self._draw_batch_jit(
            self.prior_flow.params,
            self.prior_flow.data_transform,
            key,
            n=n_samples,
        )
        self.n_likelihood_evaluations += n_samples
        return x, log_q, log_pi, log_l

    def flow_draw_fn(self):
        """Pure ``(flow_state, key, n) -> (x, log_q)`` flow draw.

        The single definition of the proposal-draw contract —
        ``flow_state = (params, data_transform)`` rides through jit as
        arguments. Used by the jitted initial draw and the SMC
        flow-independence moves, so the two can never drift apart.
        """
        flow = self.prior_flow
        arch = flow.architecture

        from ..flows.bijectors import (
            standard_normal_log_prob,
            standard_normal_sample,
        )

        def draw(flow_state, key, n):
            params, data_transform = flow_state
            z = standard_normal_sample(key, (n, arch.dims), flow.dtype)
            x_t, log_det = arch.inverse(params, z)
            log_q = standard_normal_log_prob(z) - log_det
            x, log_j = data_transform.inverse(x_t)
            return x, log_q - log_j

        return draw

    def draw_initial_samples(
        self, n_samples: int, max_attempts: int = 100
    ) -> Samples:
        """Draw ``n_samples`` valid samples from the flow proposal.

        Parity with reference ``mcmc.py:49-110``: invalid draws
        (non-finite log-prior/likelihood) are discarded and redrawn.
        Each attempt draws the full batch (static shapes per attempt).
        """
        collected: list[Samples] = []
        n_drawn = 0
        for _ in range(max_attempts):
            x, log_q, log_prior, log_likelihood = self._draw_batch(
                n_samples
            )
            if not bool(jnp.isfinite(log_q).all()):
                raise ValueError(
                    "Proposal returned non-finite log probabilities. "
                    "The proposal must be a valid, normalized probability "
                    "distribution with finite log probabilities."
                )
            valid = np.asarray(
                jnp.isfinite(log_prior) & jnp.isfinite(log_likelihood)
            )
            n_valid = int(valid.sum())
            if n_valid < n_samples:
                logger.debug(
                    "Proposal returned %d invalid samples with non-finite "
                    "log prior or log likelihood; discarding.",
                    n_samples - n_valid,
                )
            if n_valid > 0:
                if n_valid == n_samples:  # common case: no mask gathers
                    batch = Samples(
                        x=jnp.asarray(x),
                        log_q=jnp.asarray(log_q),
                        log_prior=log_prior,
                        log_likelihood=log_likelihood,
                        dtype=self.dtype,
                        parameters=self.parameters,
                    )
                else:
                    batch = Samples(
                        x=jnp.asarray(x)[valid],
                        log_q=jnp.asarray(log_q)[valid],
                        log_prior=log_prior[valid],
                        log_likelihood=log_likelihood[valid],
                        dtype=self.dtype,
                        parameters=self.parameters,
                    )
                collected.append(batch)
                n_drawn += n_valid
            if n_drawn >= n_samples:
                break
        else:
            raise RuntimeError(
                f"Failed to draw {n_samples} valid samples in "
                f"{max_attempts} attempts"
            )
        samples = (
            collected[0]
            if len(collected) == 1
            else Samples.concatenate(collected)
        )
        return samples[:n_samples]

    # -- config ------------------------------------------------------------

    @property
    def backend_str(self) -> str:
        return "jax"

    #: sample() kwargs scrubbed from recorded call configs: they point
    #: at artifacts of a previous run (e.g. a resume file) that a
    #: replayed call must not try to re-open.
    _scrub_sample_kwargs: tuple = ("resume_from",)

    def config_dict(self, include_sample_calls: str | bool = "last") -> dict:
        config = {
            "class": type(self).__name__,
            "dims": self.dims,
            "parameters": self.parameters,
            "dtype": str(self.dtype) if self.dtype else None,
            "log_likelihood": function_id(self.log_likelihood),
            "log_prior": function_id(self.log_prior),
            "n_likelihood_evaluations": self.n_likelihood_evaluations,
        }
        history = self._call_history.get("sample")
        if history and include_sample_calls:
            if include_sample_calls == "last":
                config["sample_calls"] = {
                    "args": history.to_dict()[
                        str(len(history.calls) - 1)
                    ]["args"],
                    "kwargs": history.to_dict()[
                        str(len(history.calls) - 1)
                    ]["kwargs"],
                }
            else:
                config["sample_calls"] = history.to_dict()
            kwargs = config["sample_calls"].get("kwargs")
            scrub = self._scrub_sample_kwargs
            if isinstance(kwargs, dict):
                for key in scrub:
                    kwargs.pop(key, None)
            else:
                for call in config["sample_calls"].values():
                    if isinstance(call, dict):
                        for key in scrub:
                            call.get("kwargs", {}).pop(key, None)
        return config

    # -- replicated evidence tier -------------------------------------------

    def _replicate_evidence(self, k: int, run_one, label: str):
        """Shared replicate statistics for the ``n_replicates`` tier.

        ``run_one()`` runs one replicate and returns
        ``(samples, logz, err)``. Used by both the SMC and PT samplers
        (and the facade's flow-refit tier) so the tiers cannot drift
        apart; the bar semantics live in :func:`combine_replicates`.
        """
        logzs, errs = [], []
        result = None
        for r in range(k):
            logger.info("%s replicate %d/%d", label, r + 1, k)
            result, lz, err = run_one()
            logzs.append(float(lz))
            errs.append(float(err))
        return combine_replicates(result, logzs, errs, label)

    # -- checkpoint protocol (reference samplers/base.py:158-287) ----------

    #: Array fields of the samples object that are checkpointed
    #: shard-wise (everything else rides in the host-state blob).
    _CHECKPOINT_ARRAY_FIELDS = ("x", "log_likelihood", "log_prior", "log_q")

    def build_checkpoint_state(
        self, samples, iteration: int, meta: dict | None = None
    ) -> dict:
        """Checkpoint state with the samples kept LIVE (possibly sharded
        on device): no global gather happens here. The gather — or the
        per-shard write — happens only at serialization time, per mode:
        in-memory resume uses the live arrays directly,
        ``serialize_checkpoint_state`` (bytes) fetches to host numpy,
        and ``save_checkpoint_to_hdf`` writes per-process shards.
        """
        state = {
            "sampler_class": type(self).__name__,
            "iteration": iteration,
            "samples": samples,
            "config": self.config_dict(),
            "parameters": self.parameters,
            "meta": meta or {},
            "key": np.asarray(jax.random.key_data(self.key)),
            "prng_impl": self.key_impl_name(),
            "n_likelihood_evaluations": self.n_likelihood_evaluations,
        }
        state.update(self._checkpoint_extra_state())
        return state

    def _checkpoint_extra_state(self) -> dict:
        return {}

    @staticmethod
    def serialize_checkpoint_state(state: dict) -> bytes:
        state = dict(state)
        samples = state.get("samples")
        if samples is not None and hasattr(samples, "to_numpy"):
            state["samples"] = samples.to_numpy()
        return pickle.dumps(state)

    def save_checkpoint_to_hdf(
        self, state: dict, file_path: str, path: str = "checkpoint"
    ) -> None:
        """Write a sharded checkpoint.

        Layout: ``{path}/state`` holds the pickled host state (history,
        config, RNG key, sample metadata) — written by process 0 — and
        ``{path}/arrays/<field>`` holds the particle arrays shard-wise;
        every process writes only its addressable shards to its own
        file (:func:`aspire_tpu.io.process_checkpoint_path`), followed
        by a cross-process write barrier.
        """
        import copy as _copy

        from ..io import (
            AspireFile,
            checkpoint_barrier,
            process_checkpoint_path,
            save_shard_blocks,
            save_sharded_array,
            save_state_bytes,
        )

        state = dict(state)
        samples = state.pop("samples", None)
        # Shard-local sample-history snapshots (multi-process meshes;
        # see SMCSampler._history_snapshot): every process writes its
        # own per-rung row blocks as shard datasets, the blob keeps
        # only the per-rung metadata, and loading reassembles the full
        # populations across the per-process files.
        history = state.get("history")
        snaps = list(getattr(history, "sample_history", None) or [])
        shard_snaps = None
        if snaps and any(
            getattr(s, "shard_starts", None) is not None for s in snaps
        ):
            shard_snaps = snaps
            hist_copy = _copy.copy(history)
            hist_copy.sample_history = []
            state["history"] = hist_copy
            state["history_shard_snapshots"] = [
                {
                    "class": type(s).__name__,
                    "beta": getattr(s, "beta", None),
                }
                for s in snaps
            ]
        target = process_checkpoint_path(file_path)
        with AspireFile(target, "a") as f:
            if samples is not None:
                for name in self._CHECKPOINT_ARRAY_FIELDS:
                    value = getattr(samples, name, None)
                    if value is not None:
                        save_sharded_array(
                            f, f"{path}/arrays/{name}", value
                        )
            if shard_snaps is not None:
                for i, snap in enumerate(shard_snaps):
                    for name in self._CHECKPOINT_ARRAY_FIELDS:
                        value = getattr(snap, name, None)
                        if value is None:
                            continue
                        value = np.asarray(value)
                        save_shard_blocks(
                            f,
                            f"{path}/history/sample_history/{i}/{name}",
                            value,
                            (snap.global_n,) + value.shape[1:],
                            snap.shard_starts,
                            snap.shard_sizes,
                        )
            if jax.process_index() == 0:
                if samples is not None:
                    state["samples_spec"] = {
                        "class": type(samples).__name__,
                        "parameters": samples.parameters,
                        "beta": getattr(samples, "beta", None),
                    }
                save_state_bytes(f, pickle.dumps(state), path=path)
        checkpoint_barrier()

    def default_file_checkpoint_callback(
        self, file_path: str | None
    ) -> Callable[[dict], None]:
        if file_path is None:
            raise ValueError(
                "checkpoint_file_path must be provided to use the default "
                "file checkpoint callback"
            )

        def callback(state: dict) -> None:
            self.save_checkpoint_to_hdf(state, file_path)

        return callback

    @classmethod
    def load_checkpoint_from_file(
        cls, file_path: str, path: str = "checkpoint", sharding=None
    ) -> dict:
        """Load a checkpoint, reassembling the shard-wise arrays.

        With ``sharding`` given, particle arrays come back as sharded
        ``jax.Array``s built shard-by-shard (each device reads its own
        hyperslabs); otherwise as host numpy. Pre-shard-format
        checkpoints (samples inside the pickled blob) load unchanged.
        """
        import h5py

        from ..io import (
            checkpoint_shard_files,
            load_sharded_array,
            load_state_bytes,
        )

        with h5py.File(file_path, "r") as f:
            state = pickle.loads(load_state_bytes(f, path=path))
        spec = state.pop("samples_spec", None)
        snap_specs = state.pop("history_shard_snapshots", None)
        if spec is None and snap_specs is None:
            return state  # legacy layout: samples were in the blob

        from .. import samples as samples_module

        def build_samples(klass_name, arrays, parameters, beta):
            klass = getattr(samples_module, klass_name)
            kwargs = dict(arrays)
            kwargs["parameters"] = parameters
            if beta is not None and hasattr(klass, "beta"):
                kwargs["beta"] = beta
            built = klass(**kwargs)
            # Re-assign the raw arrays after construction:
            # __post_init__ normalizes dtypes, but a checkpoint restore
            # must hand back exactly the bytes that were saved (live
            # samples may carry mixed precisions, e.g. f32 positions
            # with f64 densities).
            for name, value in arrays.items():
                setattr(built, name, value)
            return built

        files = [
            h5py.File(p, "r") for p in checkpoint_shard_files(file_path)
        ]
        try:

            def load_fields(base_path, sharding):
                arrays = {}
                for name in cls._CHECKPOINT_ARRAY_FIELDS:
                    array_path = f"{base_path}/{name}"
                    if any(array_path in f for f in files):
                        arrays[name] = load_sharded_array(
                            files, array_path, sharding=sharding
                        )
                return arrays

            if spec is not None:
                state["samples"] = build_samples(
                    spec["class"],
                    load_fields(f"{path}/arrays", sharding),
                    spec.get("parameters"),
                    spec.get("beta"),
                )
            if snap_specs is not None and state.get("history") is not None:
                # Shard-local sample history: reassemble each rung's
                # full population across the per-process files (host
                # numpy — these are plotting/diagnostic snapshots).
                for i, sp in enumerate(snap_specs):
                    arrays = load_fields(
                        f"{path}/history/sample_history/{i}", None
                    )
                    state["history"].sample_history.append(
                        build_samples(
                            sp.get("class", "SMCSamples"),
                            arrays,
                            state.get("parameters"),
                            sp.get("beta"),
                        )
                    )
        finally:
            for f in files:
                f.close()
        return state

    def _particle_sharding(self):
        """Target sharding for restored particle arrays (None off-mesh)."""
        if self.mesh is None:
            return None
        from ..parallel.mesh import particle_sharding

        return particle_sharding(self.mesh)

    def restore_from_checkpoint(
        self, source: str | bytes | dict
    ) -> tuple[Samples, dict]:
        if isinstance(source, str):
            state = self.load_checkpoint_from_file(
                source, sharding=self._particle_sharding()
            )
        elif isinstance(source, bytes):
            state = pickle.loads(source)
        elif isinstance(source, dict):
            state = source
        else:
            raise TypeError(
                f"Cannot restore from object of type {type(source)}"
            )
        samples = state["samples"]
        if state.get("key") is not None:
            # Restore the key under the impl it was SAVED with (absent
            # in pre-r5 checkpoints -> the default impl, matching their
            # writers); the resumed run continues the exact stream.
            self.key = jax.random.wrap_key_data(
                jnp.asarray(state["key"]), impl=state.get("prng_impl")
            )
        self.n_likelihood_evaluations = state.get(
            "n_likelihood_evaluations", self.n_likelihood_evaluations
        )
        return samples, state


def _as_key(rng: Any, impl: str | None = None) -> jax.Array:
    """Normalize rng argument to a JAX PRNG key.

    ``impl`` selects the PRNG implementation (``jax.random.key``'s
    ``impl=``, e.g. ``"rbg"``) when a key must be created; an rng that
    is already a key keeps its own impl.
    """
    if rng is None:
        return jax.random.key(
            int(np.random.default_rng().integers(2**31 - 1)), impl=impl
        )
    if isinstance(rng, int):
        return jax.random.key(rng, impl=impl)
    if isinstance(rng, np.random.Generator):
        return jax.random.key(int(rng.integers(2**31 - 1)), impl=impl)
    if isinstance(rng, jax.Array):
        return rng
    raise TypeError(f"Cannot interpret rng of type {type(rng)}")
