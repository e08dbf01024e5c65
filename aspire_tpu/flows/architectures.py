"""Flow architectures as pure functional cores.

Internalizes the architectures the reference pulls from ``zuko``/
``flowjax`` (reference flows/torch/flows.py:155-158, flows/jax/utils.py:
11-22): masked autoregressive flows (MAF, affine or RQS transformer),
coupling flows (RealNVP-style affine, NSF-style rational-quadratic
spline), all with a standard-normal base.

Each architecture is a small config object exposing

- ``init(key) -> params``            (nested-dict pytree)
- ``forward(params, x) -> (z, log_det)``   data -> latent (density pass)
- ``inverse(params, z) -> (x, log_det)``   latent -> data (sampling pass)

``log_det`` is d log|z|/d x summed over features, shape ``(batch,)``.
Forward passes are single batched matmul chains; the MAF inverse is a
``lax.fori_loop`` over dims (d is small in this problem class). Coupling
flows are single-pass in both directions, which is why they are the
preferred architecture for large sampling workloads.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .bijectors import (
    affine_forward,
    affine_inverse,
    constrain_log_scale,
    rational_quadratic_spline,
)
from .nets import apply_made, apply_mlp, init_made, init_mlp, made_masks


@dataclasses.dataclass(frozen=True)
class Architecture:
    """Base config; subclasses implement init/forward/inverse."""

    dims: int
    n_layers: int = 4
    n_hidden: tuple = (64, 64)
    dtype: str = "float32"

    @property
    def _dtype(self):
        return jnp.dtype(self.dtype)

    def init(self, key):
        raise NotImplementedError

    def forward(self, params, x):
        raise NotImplementedError

    def inverse(self, params, z):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Masked autoregressive flows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MAF(Architecture):
    """Masked autoregressive flow with affine or RQS transformer.

    Default architecture parity: reference flowjax default
    ``masked_autoregressive_flow`` (flows/jax/utils.py:25-57) and zuko MAF
    (flows/torch/flows.py:155-158).
    """

    transformer: str = "affine"  # "affine" | "rqs"
    num_bins: int = 8
    tail_bound: float = 5.0

    @property
    def _n_params_per_dim(self):
        if self.transformer == "affine":
            return 2
        return 3 * self.num_bins - 1

    def _masks(self):
        masks, _ = made_masks(
            self.dims, list(self.n_hidden), self._n_params_per_dim
        )
        return [jnp.asarray(m, dtype=self._dtype) for m in masks]

    def init(self, key):
        keys = jax.random.split(key, self.n_layers)
        layers = []
        for k in keys:
            params, _ = init_made(
                k,
                self.dims,
                list(self.n_hidden),
                self._n_params_per_dim,
                dtype=self._dtype,
            )
            layers.append(params)
        return {"layers": layers}

    def _transform(self, h, x, inverse: bool):
        """Apply the elementwise transformer given MADE outputs ``h``."""
        batch = x.shape[0]
        h = h.reshape(batch, self.dims, self._n_params_per_dim)
        if self.transformer == "affine":
            shift = h[..., 0]
            log_scale = constrain_log_scale(h[..., 1])
            if inverse:
                y, eld = affine_inverse(x, shift, log_scale)
            else:
                y, eld = affine_forward(x, shift, log_scale)
            return y, eld.sum(-1)
        y, eld = rational_quadratic_spline(
            x, h, self.num_bins, self.tail_bound, inverse=inverse
        )
        return y, eld.sum(-1)

    def _forward_xla(self, params, x):
        masks = self._masks()
        log_det = jnp.zeros(x.shape[0], dtype=x.dtype)
        z = x
        for layer in params["layers"]:
            h = apply_made(layer, masks, z)
            z, ld = self._transform(h, z, inverse=True)
            log_det += ld
            z = z[:, ::-1]  # reverse permutation between layers
        return z, log_det

    def forward(self, params, x):
        """Data -> latent: one MADE pass per layer (parallel over dims).

        Convention: the autoregressive conditioner reads the *data-side*
        variable of each layer, so the density pass is the fast direction
        (one network evaluation per layer).
        """
        return self._forward_xla(params, x)

    def inverse(self, params, z):
        """Latent -> data: autoregressive solve, sequential over dims."""
        masks = self._masks()
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        x = z
        for layer in reversed(params["layers"]):
            x = x[:, ::-1]  # undo the reverse permutation
            latent = x

            def dim_step(i, y, layer=layer, latent=latent):
                # Conditioner reads the partially-built data vector y;
                # autoregressive masks guarantee dim i only sees y[:, :i].
                h = apply_made(layer, masks, y)
                candidate, _ = self._transform(h, latent, inverse=False)
                return y.at[:, i].set(candidate[:, i])

            y = jax.lax.fori_loop(0, self.dims, dim_step, jnp.zeros_like(x))
            h = apply_made(layer, masks, y)
            x, ld = self._transform(h, latent, inverse=False)
            log_det += ld
        return x, log_det


# ---------------------------------------------------------------------------
# Coupling flows
# ---------------------------------------------------------------------------


def _coupling_masks(dims: int, n_layers: int):
    """Alternating binary masks; mask==1 marks the conditioning half."""
    base = jnp.arange(dims) % 2
    return [
        jnp.asarray((base + i) % 2, dtype=bool) for i in range(n_layers)
    ]


@dataclasses.dataclass(frozen=True)
class Coupling(Architecture):
    """Coupling flow: conditioner MLP on one half, transformer on the other.

    ``transformer="affine"`` is RealNVP; ``transformer="rqs"`` is a
    neural-spline (NSF-style) coupling flow — the reference's NSF example
    config (examples/smc_example.py:82) maps here.
    """

    transformer: str = "rqs"
    num_bins: int = 8
    tail_bound: float = 5.0

    @property
    def _n_params_per_dim(self):
        if self.transformer == "affine":
            return 2
        return 3 * self.num_bins - 1

    def init(self, key):
        keys = jax.random.split(key, self.n_layers)
        layers = []
        for k in keys:
            layers.append(
                init_mlp(
                    k,
                    self.dims,
                    list(self.n_hidden),
                    self.dims * self._n_params_per_dim,
                    dtype=self._dtype,
                )
            )
        return {"layers": layers}

    def _transform(self, params_net, x, mask, inverse: bool):
        batch = x.shape[0]
        x_cond = jnp.where(mask[None, :], x, 0.0)
        h = apply_mlp(params_net, x_cond)
        h = h.reshape(batch, self.dims, self._n_params_per_dim)
        if self.transformer == "affine":
            shift = h[..., 0]
            log_scale = constrain_log_scale(h[..., 1])
            if inverse:
                y, eld = affine_inverse(x, shift, log_scale)
            else:
                y, eld = affine_forward(x, shift, log_scale)
        else:
            y, eld = rational_quadratic_spline(
                x, h, self.num_bins, self.tail_bound, inverse=inverse
            )
        # Only the non-conditioning half is transformed.
        y = jnp.where(mask[None, :], x, y)
        eld = jnp.where(mask[None, :], 0.0, eld)
        return y, eld.sum(-1)

    def _forward_xla(self, params, x):
        masks = _coupling_masks(self.dims, self.n_layers)
        log_det = jnp.zeros(x.shape[0], dtype=x.dtype)
        z = x
        for layer, mask in zip(params["layers"], masks):
            z, ld = self._transform(layer, z, mask, inverse=True)
            log_det += ld
        return z, log_det

    def _inverse_xla(self, params, z):
        masks = _coupling_masks(self.dims, self.n_layers)
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        x = z
        for layer, mask in zip(
            reversed(params["layers"]), reversed(masks)
        ):
            x, ld = self._transform(layer, x, mask, inverse=False)
            log_det += ld
        return x, log_det

    def forward(self, params, x):
        """Data -> latent; the density pass of every mutation step.

        On a GPU, large float32 batches run the fused Pallas kernel
        (ops/fused_coupling.py); its gradient recomputes through the XLA
        path, so training and gradient-based kernels are exact.
        """
        from ..ops.fused_coupling import coupling_density, use_kernel

        if use_kernel(self, x):
            return coupling_density(self, params, x)
        return self._forward_xla(params, x)

    def inverse(self, params, z):
        """Latent -> data (the sampling pass)."""
        return self._inverse_xla(params, z)


def realnvp(dims: int, **kwargs) -> Coupling:
    kwargs.setdefault("transformer", "affine")
    return Coupling(dims=dims, **kwargs)


def nsf(dims: int, **kwargs) -> Coupling:
    kwargs.setdefault("transformer", "rqs")
    return Coupling(dims=dims, **kwargs)


def nsf_tpu(dims: int, **kwargs) -> Coupling:
    """Compact NSF preset: 3 coupling layers x (64, 64) hidden x 8 bins.

    Chosen by a sweep of speed against statistical-gate margin
    (benchmarks/dev/flow_pareto.py and flow_pareto_refit.py): every
    smaller configuration (2 layers, 4 bins, or 32-wide hidden) failed
    the funnel gate under the flow-refit replicate bar. Its place on the
    H100's speed curve is not measured. Explicit kwargs still override.
    """
    kwargs.setdefault("transformer", "rqs")
    kwargs.setdefault("n_layers", 3)
    kwargs.setdefault("n_hidden", (64, 64))
    kwargs.setdefault("num_bins", 8)
    return Coupling(dims=dims, **kwargs)


def maf(dims: int, **kwargs) -> MAF:
    kwargs.setdefault("transformer", "affine")
    return MAF(dims=dims, **kwargs)


def maf_rqs(dims: int, **kwargs) -> MAF:
    kwargs.setdefault("transformer", "rqs")
    return MAF(dims=dims, **kwargs)


ARCHITECTURES = {
    "maf": maf,
    "maf-rqs": maf_rqs,
    "nsf": nsf,
    "nsf-tpu": nsf_tpu,
    "realnvp": realnvp,
    "coupling": nsf,
}


def get_architecture(name: str, dims: int, **kwargs) -> Architecture:
    key = name.lower()
    if key not in ARCHITECTURES:
        raise ValueError(
            f"Unknown flow architecture '{name}'. "
            f"Choose from {sorted(ARCHITECTURES)}"
        )
    return ARCHITECTURES[key](dims, **kwargs)
