"""Utilities: logging, dtype handling, call tracking, host-pool support.

JAX replacement for the reference's array-portability layer
(``/root/reference/src/aspire/utils.py``). Because this framework targets a
single array namespace (JAX), the xp-dispatch machinery (``resolve_xp``,
``asarray``, ``convert_dtype``, DLPack exchange; utils.py:258-476 in the
reference) collapses to a handful of helpers; what remains here is the
cross-cutting infrastructure the reference keeps in the same module:
logger configuration (utils.py:56-114), call tracking for provenance
(utils.py:966-1050), and the host process-pool handler (utils.py:117-193).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import logging
import os
import sys
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("aspire_tpu")

# ---------------------------------------------------------------------------
# Logging (parity: reference utils.py:56-114 ``configure_logger``)
# ---------------------------------------------------------------------------


def configure_logger(
    level: str | int = "INFO",
    log_file: str | None = None,
    include_ecosystem: bool = True,
) -> logging.Logger:
    """Configure the ``aspire_tpu`` logger.

    Adds a stream handler (and optional file handler) to the package logger.
    If ``include_ecosystem`` is True, any logger whose name starts with
    ``aspire_tpu_`` is configured to propagate into the package logger, so
    plugins can share the configuration.
    """
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    pkg_logger = logging.getLogger("aspire_tpu")
    pkg_logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"
    )
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(fmt)
    stream.setLevel(level)
    pkg_logger.addHandler(stream)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        fh.setLevel(level)
        pkg_logger.addHandler(fh)
    if include_ecosystem:
        for name in list(logging.root.manager.loggerDict):
            if name.startswith("aspire_tpu_"):
                eco = logging.getLogger(name)
                eco.setLevel(level)
                eco.propagate = True
    return pkg_logger


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry point.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and nothing is changed. Otherwise the cache goes to the fixed
    directory ``<checkout>/.jax_cache``: the path is part of the cache's
    key, so a directory that moved would never hit. Entry-point scripts
    call this; importing the package never does, because the CPU test
    suite runs without a cache. Returns the cache directory.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def resolve_dtype(dtype: Any) -> jnp.dtype | None:
    """Resolve a dtype specification (string, numpy/jax dtype, None)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        return jnp.dtype(dtype)
    return jnp.dtype(dtype)


def default_dtype() -> jnp.dtype:
    """Default floating dtype: float64 iff jax x64 is enabled, else float32."""
    return jnp.asarray(0.0).dtype


def to_numpy(x: Any) -> np.ndarray:
    """Convert a JAX array (or anything array-like) to host numpy."""
    if x is None:
        return None
    return np.asarray(jax.device_get(x))


def asarray(x: Any, dtype: Any = None) -> jax.Array:
    """Convert array-like input to a JAX array with an optional dtype."""
    dtype = resolve_dtype(dtype)
    return jnp.asarray(x, dtype=dtype)


# ---------------------------------------------------------------------------
# Call tracking (parity: reference utils.py:966-1050)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CallHistory:
    """Record of calls to a tracked method (args/kwargs per call)."""

    calls: list = dataclasses.field(default_factory=list)

    def add_call(self, args: tuple, kwargs: dict) -> None:
        self.calls.append({"args": args, "kwargs": kwargs})

    @property
    def last(self) -> dict | None:
        return self.calls[-1] if self.calls else None

    def to_dict(self) -> dict:
        out = {}
        for i, call in enumerate(self.calls):
            out[str(i)] = {
                "args": _sanitize_for_config(call["args"]),
                "kwargs": _sanitize_for_config(call["kwargs"]),
            }
        return out


def _sanitize_for_config(obj: Any) -> Any:
    """Make call arguments serialization-friendly (callables -> id strings)."""
    if callable(obj) and not isinstance(obj, type):
        return function_id(obj)
    if isinstance(obj, dict):
        return {k: _sanitize_for_config(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_sanitize_for_config(v) for v in obj)
    if isinstance(obj, (jax.Array, np.ndarray)):
        return to_numpy(obj)
    return obj


def track_calls(method: Callable) -> Callable:
    """Decorator recording every invocation of ``method`` on the instance.

    Mirrors the reference's ``@track_calls`` (utils.py:1003-1030): the call
    history is stored on the instance under ``_call_history[method_name]``
    and surfaced by ``Sampler.config_dict``.
    """

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        if not hasattr(self, "_call_history"):
            self._call_history = {}
        history = self._call_history.setdefault(method.__name__, CallHistory())
        history.add_call(args, kwargs)
        return method(self, *args, **kwargs)

    wrapper.__wrapped__ = method
    return wrapper


def function_id(fn: Callable) -> str | None:
    """Stable identifier ``module:qualname`` for a callable.

    Used instead of pickling user likelihood/prior callables
    (reference utils.py:1033-1050): functions are recorded by id and must be
    re-supplied by the user on resume.
    """
    if fn is None:
        return None
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", getattr(fn, "__name__", None))
    if qualname is None:
        qualname = type(fn).__qualname__
        module = type(fn).__module__
    return f"{module}:{qualname}"


# ---------------------------------------------------------------------------
# Host process-pool support (parity: reference utils.py:117-193 PoolHandler)
# ---------------------------------------------------------------------------


class PoolHandler:
    """Context manager that parallelizes a *host* likelihood over a pool.

    On an accelerator the preferred contract is a jittable likelihood
    evaluated on device; this handler exists for parity with the reference's
    ``PoolHandler`` for user likelihoods that are plain Python and accept a
    ``map_fn`` keyword (reference utils.py:117-193,
    docs/multiprocessing.rst:1-70). The likelihood must accept ``map_fn`` as
    a keyword argument; inside the context it receives ``pool.map``.
    """

    def __init__(
        self,
        aspire,
        pool,
        parallelize_prior: bool = False,
        close_pool: bool = True,
    ):
        self.aspire = aspire
        self.pool = pool
        self.parallelize_prior = parallelize_prior
        self.close_pool = close_pool
        self._originals = {}

    @staticmethod
    def _accepts_map_fn(fn: Callable) -> bool:
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return False
        return "map_fn" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        )

    def __enter__(self):
        fns = ["log_likelihood"]
        if self.parallelize_prior:
            fns.append("log_prior")
        for name in fns:
            fn = getattr(self.aspire, name)
            if not self._accepts_map_fn(fn):
                raise ValueError(
                    f"{name} must accept a `map_fn` keyword argument to be "
                    "used with PoolHandler"
                )
            self._originals[name] = fn
            setattr(
                self.aspire, name, functools.partial(fn, map_fn=self.pool.map)
            )
        return self

    def __exit__(self, *exc):
        for name, fn in self._originals.items():
            setattr(self.aspire, name, fn)
        self._originals.clear()
        if self.close_pool:
            self.pool.close()
            self.pool.join()
        return False


# ---------------------------------------------------------------------------
# Signature-based kwarg routing (parity: reference aspire.py:468-480)
# ---------------------------------------------------------------------------


def split_kwargs_by_signature(
    fn: Callable, kwargs: dict
) -> tuple[dict, dict]:
    """Split ``kwargs`` into (accepted-by-fn, remainder) via signature."""
    sig = inspect.signature(fn)
    has_var_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD
        for p in sig.parameters.values()
    )
    if has_var_kw:
        return dict(kwargs), {}
    accepted, rest = {}, {}
    for k, v in kwargs.items():
        if k in sig.parameters:
            accepted[k] = v
        else:
            rest[k] = v
    return accepted, rest


def get_parameter_names(dims: int, parameters: list[str] | None) -> list[str]:
    if parameters is not None:
        if len(parameters) != dims:
            raise ValueError(
                f"Number of parameters ({len(parameters)}) does not match "
                f"dims ({dims})"
            )
        return list(parameters)
    return [f"x_{i}" for i in range(dims)]
