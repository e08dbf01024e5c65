"""Invertible data transforms with log-abs-det Jacobians.

Pytree redesign of the reference's transform layer
(``/root/reference/src/aspire/transforms.py``): every transform is a
**registered pytree** whose fitted parameters are JAX arrays, so a
transform instance can be passed straight through ``jit``/``shard_map``
boundaries as an argument. This matters because the SMC driver refits the
preconditioning transform every temperature step (reference
smc/minipcn.py:105-109); treating the transform as a pytree argument means
refitting never triggers recompilation.

Class parity (reference file:line):

- :class:`IdentityTransform`      (transforms.py:125)
- :class:`CompositeTransform`     (142) — masked periodic/bounded/affine
- :class:`FlowTransform`          (361) — composite minus periodic
- :class:`PeriodicTransform`      (411) — modulo wrap, zero Jacobian
- :class:`BoundedTransform`       (440) — [lower, upper] <-> [0, 1]
- :class:`ProbitTransform`        (537) — via ``jax.scipy.special.erfinv``
- :class:`LogitTransform`         (573)
- :class:`AffineTransform`        (609) — whitening fit to mean/std
- :class:`FlowPreconditioningTransform` (649) — inner flow as transport map

All ``forward``/``inverse`` return ``(y, log_abs_det_jacobian)`` with the
Jacobian reduced over the feature axis (shape ``(n,)``).
"""

from __future__ import annotations

import importlib
import logging
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .utils import asarray, resolve_dtype, to_numpy

logger = logging.getLogger("aspire_tpu")

_TRANSFORM_REGISTRY: dict[str, type] = {}


def _name_list(names) -> list:
    """Normalize an optional name sequence (list/tuple/ndarray) to a list.

    Avoids truthiness on arrays: an empty numpy array (as HDF5 round-trips
    produce) raises a DeprecationWarning under ``if names``.
    """
    return [] if names is None else list(names)


def _freeze(value):
    """Make aux data hashable (jit caches on pytree aux)."""
    if isinstance(value, dict):
        return ("__dict__", tuple((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, list):
        return ("__list__", tuple(_freeze(v) for v in value))
    if isinstance(value, tuple):
        return ("__tuple__", tuple(_freeze(v) for v in value))
    return value


def _thaw(value):
    if isinstance(value, tuple) and len(value) == 2:
        tag, payload = value
        if tag == "__dict__":
            return {k: _thaw(v) for k, v in payload}
        if tag == "__list__":
            return [_thaw(v) for v in payload]
        if tag == "__tuple__":
            return tuple(_thaw(v) for v in payload)
    return value


def register_transform(cls):
    """Class decorator: register for save/load dispatch + as a pytree."""
    _TRANSFORM_REGISTRY[cls.__name__] = cls

    def flatten(obj):
        children = tuple(getattr(obj, name) for name in cls.pytree_children)
        aux = tuple(
            (name, _freeze(getattr(obj, name))) for name in cls.pytree_aux
        )
        return children, aux

    def unflatten(aux, children):
        obj = object.__new__(cls)
        for name, value in zip(cls.pytree_children, children):
            object.__setattr__(obj, name, value)
        for name, value in aux:
            object.__setattr__(obj, name, _thaw(value))
        return obj

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


class BaseTransform:
    """Base class: fit / forward / inverse / config / HDF5 save-load."""

    pytree_children: tuple[str, ...] = ()
    pytree_aux: tuple[str, ...] = ("dtype",)

    def __init__(self, dtype: Any = None):
        self.dtype = resolve_dtype(dtype)

    def fit(self, x):
        raise NotImplementedError

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def config_dict(self) -> dict:
        return {"dtype": str(self.dtype) if self.dtype else None}

    def save(self, h5_file, path: str = "data_transform"):
        from .io import save_dict_to_hdf5

        if path in h5_file:
            del h5_file[path]
        grp = h5_file.create_group(path)
        grp.attrs["class"] = type(self).__name__
        save_dict_to_hdf5(grp, "config", self.config_dict())
        self._save_state(grp)

    @classmethod
    def load(cls, h5_file, path: str = "data_transform", strict: bool = False):
        from .io import load_dict_from_hdf5

        grp = h5_file[path]
        class_name = grp.attrs["class"]
        target = _TRANSFORM_REGISTRY.get(class_name)
        if target is None:
            raise ValueError(f"Unknown transform class: {class_name}")
        if strict and target is not cls:
            raise ValueError(
                f"Expected class {cls.__name__}, got {class_name}."
            )
        config = load_dict_from_hdf5(grp, "config")
        obj = target(**config)
        obj._load_state(grp)
        return obj

    def _save_state(self, grp):
        pass

    def _load_state(self, grp):
        pass

    def new_instance(self, dtype: Any = None):
        config = self.config_dict()
        if dtype is not None:
            config["dtype"] = dtype
        return type(self)(**config)


@register_transform
class IdentityTransform(BaseTransform):
    """No-op transform (reference transforms.py:125)."""

    def fit(self, x):
        return asarray(x, dtype=self.dtype)

    def forward(self, x):
        x = asarray(x, dtype=self.dtype)
        return x, jnp.zeros(len(x), dtype=x.dtype)

    def inverse(self, y):
        y = asarray(y, dtype=self.dtype)
        return y, jnp.zeros(len(y), dtype=y.dtype)


@register_transform
class PeriodicTransform(BaseTransform):
    """Wrap values into [lower, upper) with zero Jacobian (reference :411)."""

    name = "periodic"
    requires_prior_bounds = True
    pytree_children = ("lower", "upper")

    def __init__(self, lower, upper, dtype: Any = None):
        super().__init__(dtype=dtype)
        self.lower = asarray(lower, dtype=self.dtype)
        self.upper = asarray(upper, dtype=self.dtype)

    @property
    def _width(self):
        return self.upper - self.lower

    def fit(self, x):
        return self.forward(x)[0]

    def forward(self, x):
        y = self.lower + (x - self.lower) % self._width
        return y, jnp.zeros(y.shape[0], dtype=y.dtype)

    def inverse(self, y):
        x = self.lower + (y - self.lower) % self._width
        return x, jnp.zeros(x.shape[0], dtype=x.dtype)

    def config_dict(self):
        return super().config_dict() | {
            "lower": to_numpy(self.lower).tolist(),
            "upper": to_numpy(self.upper).tolist(),
        }


class BoundedTransform(BaseTransform):
    """Linear map [lower, upper] <-> [0, 1]; subclass to add the unbounding
    map (probit/logit). Reference transforms.py:440-534."""

    name = "bounded"
    requires_prior_bounds = True
    pytree_children = ("lower", "upper")
    pytree_aux = ("dtype", "eps")

    def __init__(self, lower, upper, eps: float = 1e-6, dtype: Any = None):
        super().__init__(dtype=dtype)
        self.lower = jnp.atleast_1d(asarray(lower, dtype=self.dtype))
        self.upper = jnp.atleast_1d(asarray(upper, dtype=self.dtype))
        self.eps = eps
        self.interval_check(self.lower, self.upper)

    def interval_check(self, lower, upper):
        if bool(jnp.any((upper - lower) == 0.0)):
            raise ValueError(
                f"Current floating precision ({self.dtype}) is too small "
                "for specified parameter ranges"
            )

    @property
    def _denom(self):
        return self.upper - self.lower

    @property
    def _scale_log_abs_det_jacobian(self):
        return -jnp.log(self._denom).sum()

    def to_unit_interval(self, x):
        y = (x - self.lower) / self._denom
        log_j = self._scale_log_abs_det_jacobian * jnp.ones(
            y.shape[0], dtype=y.dtype
        )
        return y, log_j

    def from_unit_interval(self, y):
        x = self._denom * y + self.lower
        log_j = -self._scale_log_abs_det_jacobian * jnp.ones(
            x.shape[0], dtype=x.dtype
        )
        return x, log_j

    def fit(self, x):
        return self.forward(x)[0]

    def config_dict(self):
        return super().config_dict() | {
            "lower": to_numpy(self.lower).tolist(),
            "upper": to_numpy(self.upper).tolist(),
            "eps": self.eps,
        }


@register_transform
class ProbitTransform(BoundedTransform):
    """[lower, upper] -> R via the probit (reference transforms.py:537)."""

    name = "probit"

    def forward(self, x):
        y, log_j_unit = self.to_unit_interval(x)
        y = jnp.clip(y, self.eps, 1.0 - self.eps)
        y = jax.scipy.special.erfinv(2 * y - 1) * math.sqrt(2)
        log_j = 0.5 * (math.log(2 * math.pi) + y**2).sum(-1)
        return y, log_j + log_j_unit

    def inverse(self, y):
        log_j = -(0.5 * (math.log(2 * math.pi) + y**2)).sum(-1)
        x = 0.5 * (1 + jax.scipy.special.erf(y / math.sqrt(2)))
        x, log_j_unit = self.from_unit_interval(x)
        return x, log_j + log_j_unit


@register_transform
class LogitTransform(BoundedTransform):
    """[lower, upper] -> R via the logit (reference transforms.py:573)."""

    name = "logit"

    def forward(self, x):
        y, log_j_unit = self.to_unit_interval(x)
        y = jnp.clip(y, self.eps, 1.0 - self.eps)
        z = jnp.log(y) - jnp.log1p(-y)
        # d logit / dy = 1 / (y (1-y))
        log_j = -(jnp.log(y) + jnp.log1p(-y)).sum(-1)
        return z, log_j + log_j_unit

    def inverse(self, z):
        y = jax.nn.sigmoid(z)
        # d sigmoid / dz = y (1 - y); log = log y + log(1-y)
        log_j = (jax.nn.log_sigmoid(z) + jax.nn.log_sigmoid(-z)).sum(-1)
        x, log_j_unit = self.from_unit_interval(y)
        return x, log_j + log_j_unit


@register_transform
class AffineTransform(BaseTransform):
    """Whitening transform fit to data mean/std (reference :609)."""

    name = "affine"
    requires_prior_bounds = False
    pytree_children = ("_mean", "_std")

    def __init__(self, dtype: Any = None):
        super().__init__(dtype=dtype)
        self._mean = None
        self._std = None

    @property
    def log_abs_det_jacobian(self):
        return -jnp.log(jnp.abs(self._std)).sum()

    def fit(self, x):
        x = asarray(x, dtype=self.dtype)
        self._mean = x.mean(0)
        self._std = x.std(0)
        return self.forward(x)[0]

    def forward(self, x):
        y = (x - self._mean) / self._std
        return y, self.log_abs_det_jacobian * jnp.ones(
            y.shape[0], dtype=y.dtype
        )

    def inverse(self, y):
        x = y * self._std + self._mean
        return x, -self.log_abs_det_jacobian * jnp.ones(
            y.shape[0], dtype=y.dtype
        )

    def _save_state(self, grp):
        if self._mean is not None:
            grp.create_dataset("mean", data=to_numpy(self._mean))
            grp.create_dataset("std", data=to_numpy(self._std))

    def _load_state(self, grp):
        if "mean" in grp:
            self._mean = asarray(grp["mean"][()], dtype=self.dtype)
            self._std = asarray(grp["std"][()], dtype=self.dtype)


@register_transform
class CompositeTransform(BaseTransform):
    """Masked composition: periodic wrap, bounded->unbounded, affine whiten.

    Reference transforms.py:142-358. Masks are static (aux data); fitted
    state (affine mean/std) is pytree children via the sub-transforms.
    """

    pytree_children = (
        "_periodic_transform",
        "_bounded_transform",
        "_affine_transform",
    )
    pytree_aux = (
        "dtype",
        "parameters",
        "periodic_parameters",
        "bounded_parameters",
        "bounded_to_unbounded",
        "bounded_transform",
        "affine_transform",
        "eps",
        "_prior_bounds_config",
        "_periodic_mask",
        "_bounded_mask",
    )

    def __init__(
        self,
        parameters: list[str],
        periodic_parameters: list[str] | None = None,
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "probit",
        affine_transform: bool = True,
        eps: float = 1e-6,
        dtype: Any = None,
    ):
        super().__init__(dtype=dtype)
        if prior_bounds is None:
            logger.warning(
                "Missing prior bounds, some transforms may not be applied."
            )
        periodic_parameters = _name_list(periodic_parameters)
        if periodic_parameters and not prior_bounds:
            raise ValueError(
                "Must specify prior bounds to use periodic parameters."
            )
        self.parameters = list(parameters)
        self.periodic_parameters = periodic_parameters
        self.bounded_to_unbounded = bounded_to_unbounded
        self.bounded_transform = bounded_transform
        self.affine_transform = affine_transform
        self.eps = eps

        if prior_bounds is None:
            self._prior_bounds_config = None
            self.bounded_parameters = []
            lower = upper = None
        else:
            self._prior_bounds_config = {
                k: [float(v) for v in np.asarray(prior_bounds[k]).ravel()]
                for k in self.parameters
            }
            lower = np.asarray(
                [self._prior_bounds_config[p][0] for p in self.parameters]
            )
            upper = np.asarray(
                [self._prior_bounds_config[p][1] for p in self.parameters]
            )
            if bounded_to_unbounded:
                finite = np.isfinite(lower) & np.isfinite(upper)
                self.bounded_parameters = [
                    p
                    for p, ok in zip(self.parameters, finite)
                    if ok and p not in self.periodic_parameters
                ]
            else:
                self.bounded_parameters = []

        self._periodic_mask = tuple(
            p in self.periodic_parameters for p in self.parameters
        )
        self._bounded_mask = tuple(
            p in self.bounded_parameters for p in self.parameters
        )

        if self.periodic_parameters:
            pmask = np.asarray(self._periodic_mask)
            self._periodic_transform = PeriodicTransform(
                lower=lower[pmask], upper=upper[pmask], dtype=self.dtype
            )
        else:
            self._periodic_transform = None

        if self.bounded_parameters:
            bmask = np.asarray(self._bounded_mask)
            if bounded_transform == "probit":
                BoundedClass = ProbitTransform
            elif bounded_transform == "logit":
                BoundedClass = LogitTransform
            else:
                raise ValueError(
                    f"Unknown bounded transform: {bounded_transform}"
                )
            self._bounded_transform = BoundedClass(
                lower=lower[bmask],
                upper=upper[bmask],
                eps=eps,
                dtype=self.dtype,
            )
        else:
            self._bounded_transform = None

        if affine_transform:
            self._affine_transform = AffineTransform(dtype=self.dtype)
        else:
            self._affine_transform = None

    @property
    def prior_bounds(self):
        return self._prior_bounds_config

    @property
    def is_identity(self) -> bool:
        """True when no sub-transform is active (the composite is a
        no-op): callers can drop it and keep fast paths that require
        ``preconditioning_transform is None``."""
        return (
            self._periodic_transform is None
            and self._bounded_transform is None
            and self._affine_transform is None
        )

    @property
    def periodic_mask(self):
        return jnp.asarray(self._periodic_mask)

    @property
    def bounded_mask(self):
        return jnp.asarray(self._bounded_mask)

    def fit(self, x):
        x = asarray(x, dtype=self.dtype)
        if self.periodic_parameters:
            mask = np.asarray(self._periodic_mask)
            x = x.at[:, mask].set(
                self._periodic_transform.fit(x[:, mask]).astype(x.dtype)
            )
        if self.bounded_parameters:
            mask = np.asarray(self._bounded_mask)
            x = x.at[:, mask].set(
                self._bounded_transform.fit(x[:, mask]).astype(x.dtype)
            )
        if self.affine_transform:
            x = self._affine_transform.fit(x)
        return x

    def forward(self, x):
        x = jnp.atleast_2d(asarray(x, dtype=self.dtype))
        log_j = jnp.zeros(len(x), dtype=x.dtype)
        if self.periodic_parameters:
            mask = np.asarray(self._periodic_mask)
            y, lj = self._periodic_transform.forward(x[..., mask])
            x = x.at[:, mask].set(y.astype(x.dtype))
            log_j += lj
        if self.bounded_parameters:
            mask = np.asarray(self._bounded_mask)
            y, lj = self._bounded_transform.forward(x[..., mask])
            x = x.at[:, mask].set(y.astype(x.dtype))
            log_j += lj
        if self.affine_transform:
            x, lj = self._affine_transform.forward(x)
            log_j += lj
        return x, log_j

    def inverse(self, y):
        y = jnp.atleast_2d(asarray(y, dtype=self.dtype))
        log_j = jnp.zeros(len(y), dtype=y.dtype)
        if self.affine_transform:
            y, lj = self._affine_transform.inverse(y)
            log_j += lj
        if self.bounded_parameters:
            mask = np.asarray(self._bounded_mask)
            x, lj = self._bounded_transform.inverse(y[..., mask])
            y = y.at[:, mask].set(x.astype(y.dtype))
            log_j += lj
        if self.periodic_parameters:
            mask = np.asarray(self._periodic_mask)
            x, lj = self._periodic_transform.inverse(y[..., mask])
            y = y.at[:, mask].set(x.astype(y.dtype))
            log_j += lj
        return y, log_j

    def config_dict(self):
        return super().config_dict() | {
            "parameters": self.parameters,
            "periodic_parameters": self.periodic_parameters,
            "prior_bounds": self._prior_bounds_config,
            "bounded_to_unbounded": self.bounded_to_unbounded,
            "bounded_transform": self.bounded_transform,
            "affine_transform": self.affine_transform,
            "eps": self.eps,
        }

    def new_instance(self, dtype: Any = None):
        config = self.config_dict()
        if dtype is not None:
            config["dtype"] = dtype
        return type(self)(**config)

    def _save_state(self, grp):
        if self.affine_transform and self._affine_transform is not None:
            sub = grp.create_group("affine_transform")
            self._affine_transform._save_state(sub)

    def _load_state(self, grp):
        if self.affine_transform and "affine_transform" in grp:
            self._affine_transform._load_state(grp["affine_transform"])


@register_transform
class FlowTransform(CompositeTransform):
    """Composite transform without periodic support; used as the flow's
    data transform (reference transforms.py:361-408)."""

    def __init__(
        self,
        parameters: list[str],
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "probit",
        affine_transform: bool = True,
        eps: float = 1e-6,
        dtype: Any = None,
    ):
        super().__init__(
            parameters=parameters,
            periodic_parameters=[],
            prior_bounds=prior_bounds,
            bounded_to_unbounded=bounded_to_unbounded,
            bounded_transform=bounded_transform,
            affine_transform=affine_transform,
            eps=eps,
            dtype=dtype,
        )

    def config_dict(self):
        cfg = super().config_dict()
        cfg.pop("periodic_parameters", None)
        return cfg


@register_transform
class FlowPreconditioningTransform(BaseTransform):
    """Preconditioning via an inner normalizing flow as a transport map.

    ``fit`` trains a fresh flow on the current particles; forward maps to
    the flow's latent space. Reference transforms.py:649-748.

    Pytree contract: the *fitted* state (inner-flow params + its data
    transform) are children and the architecture config is hashable aux,
    so a fitted instance passes through jit/shard_map boundaries — the
    SMC mutation chain evaluates the transport map on device. Instances
    reconstructed from flattening only support forward/inverse (config
    attributes live on the original object).
    """

    pytree_children = ("_params", "_inner_data_transform")
    pytree_aux = ("dtype", "_arch")

    def __init__(
        self,
        parameters: list[str],
        flow_backend: str = "maf",
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "probit",
        affine_transform: bool = True,
        periodic_parameters: list[str] | None = None,
        eps: float = 1e-6,
        dtype: Any = None,
        flow_matching: bool = False,
        flow_kwargs: dict | None = None,
        fit_kwargs: dict | None = None,
    ):
        super().__init__(dtype=dtype)
        self.parameters = list(parameters)
        self.periodic_parameters = _name_list(periodic_parameters)
        self.prior_bounds = prior_bounds
        self.bounded_to_unbounded = bounded_to_unbounded
        self.bounded_transform = bounded_transform
        self.affine_transform = affine_transform
        self.eps = eps
        self.flow_backend = flow_backend
        self.flow_matching = flow_matching
        self.flow_kwargs = dict(flow_kwargs or {})
        self.fit_kwargs = dict(fit_kwargs or {})
        self.flow = None
        self._params = None
        self._inner_data_transform = None
        self._arch = None

    def _make_data_transform(self):
        return CompositeTransform(
            parameters=self.parameters,
            periodic_parameters=self.periodic_parameters,
            prior_bounds=self.prior_bounds,
            bounded_to_unbounded=self.bounded_to_unbounded,
            bounded_transform=self.bounded_transform,
            affine_transform=self.affine_transform,
            eps=self.eps,
            dtype=self.dtype,
        )

    def fit(self, x):
        from .flows import get_flow_class

        FlowClass = get_flow_class(
            self.flow_backend, flow_matching=self.flow_matching
        )
        self.flow = FlowClass(
            dims=len(self.parameters),
            data_transform=self._make_data_transform(),
            **self.flow_kwargs,
        )
        self.flow.fit(x, **self.fit_kwargs)
        # Functional state for jit traversal (pytree children/aux).
        self._params = self.flow.params
        self._inner_data_transform = self.flow.data_transform
        self._arch = self.flow.architecture
        return self.flow.forward(x)[0]

    def forward(self, x):
        if getattr(self, "_params", None) is None:
            raise RuntimeError("FlowPreconditioningTransform is not fitted")
        x_t, log_j = self._inner_data_transform.forward(x)
        z, log_det = self._arch.forward(self._params, x_t)
        return z, log_det + log_j

    def inverse(self, y):
        if getattr(self, "_params", None) is None:
            raise RuntimeError("FlowPreconditioningTransform is not fitted")
        x_t, log_det = self._arch.inverse(self._params, y)
        x, log_j = self._inner_data_transform.inverse(x_t)
        return x, log_det + log_j

    def config_dict(self):
        return super().config_dict() | {
            "parameters": self.parameters,
            "periodic_parameters": self.periodic_parameters,
            "prior_bounds": self.prior_bounds,
            "bounded_to_unbounded": self.bounded_to_unbounded,
            "bounded_transform": self.bounded_transform,
            "affine_transform": self.affine_transform,
            "eps": self.eps,
            "flow_backend": self.flow_backend,
            "flow_matching": self.flow_matching,
            "flow_kwargs": self.flow_kwargs,
            "fit_kwargs": self.fit_kwargs,
        }

    def _rebuild_flow(self, data_transform, params):
        """Reattach a fitted transport map (no training)."""
        import jax as _jax
        import jax.numpy as _jnp

        from .flows import get_flow_class

        FlowClass = get_flow_class(
            self.flow_backend, flow_matching=self.flow_matching
        )
        self.flow = FlowClass(
            dims=len(self.parameters),
            data_transform=data_transform,
            **self.flow_kwargs,
        )
        if params is not None:
            self._params = _jax.tree.map(_jnp.asarray, params)
            self.flow.params = self._params
        self._inner_data_transform = self.flow.data_transform
        self._arch = self.flow.architecture

    def _save_state(self, grp):
        """Persist the fitted transport map (reference parity:
        transforms.py:63-122 class-dispatch save of fitted state — the
        round-1 gap where a checkpoint under ``preconditioning="flow"``
        silently dropped the map)."""
        if getattr(self, "_params", None) is None:
            return
        from .io import save_pytree_to_hdf5

        save_pytree_to_hdf5(grp, "flow_params", self._params)
        self._inner_data_transform.save(grp, "inner_data_transform")

    def _load_state(self, grp):
        if "flow_params" not in grp:
            return  # saved unfitted
        from .io import load_pytree_from_hdf5

        inner = BaseTransform.load(grp, "inner_data_transform")
        self._rebuild_flow(inner, None)
        self._params = load_pytree_from_hdf5(
            grp, "flow_params", like=self.flow.params
        )
        self.flow.params = self._params

    # -- in-memory checkpoint payload (for the sampler state blob) ---------

    def checkpoint_payload(self) -> dict | None:
        """Picklable fitted state: config + params + inner transform."""
        if getattr(self, "_params", None) is None:
            return None
        import jax as _jax

        return {
            "class": type(self).__name__,
            "config": self.config_dict(),
            "params": _jax.device_get(self._params),
            "inner_data_transform": self._inner_data_transform,
        }

    @classmethod
    def from_checkpoint_payload(
        cls, payload: dict
    ) -> "FlowPreconditioningTransform":
        obj = cls(**payload["config"])
        obj._rebuild_flow(
            payload["inner_data_transform"], payload["params"]
        )
        return obj


def get_transform_class(name: str) -> type:
    try:
        return _TRANSFORM_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown transform class: {name}") from None
