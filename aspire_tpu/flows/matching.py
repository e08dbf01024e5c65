"""Continuous normalizing flow trained with conditional flow matching.

Parity with the reference's ``ZukoFlowMatching``
(flows/torch/flows.py:447-483): a velocity field trained with the
linear-path CFM MSE loss; sampling integrates the ODE noise -> data, and
``log_prob`` integrates the augmented ODE with the exact divergence
(dims are small in this problem class, so the d x d Jacobian trace is
cheap and avoids Hutchinson noise).

Device notes: fixed-step RK4 under ``lax.scan`` (static step count, no
adaptive control flow), batched MLP evaluations as matrix products.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from .base import Flow
from .bijectors import standard_normal_sample
from .nets import apply_mlp, init_mlp


import dataclasses


@dataclasses.dataclass(frozen=True)
class _VelocityField:
    """Architecture shim: velocity MLP + fixed-step RK4 ODE transport.

    Frozen/hashable so it can ride through jit boundaries as pytree aux
    (e.g. inside FlowPreconditioningTransform). Exposes the same
    ``init/forward/inverse`` surface as the discrete architectures.
    """

    dims: int
    n_hidden: tuple
    dtype: str
    n_steps: int = 64

    def init(self, key):
        # Input: x (dims) + time embedding (2: t, 1-t).
        return init_mlp(
            key,
            self.dims + 2,
            list(self.n_hidden),
            self.dims,
            dtype=jnp.dtype(self.dtype),
        )

    def forward(self, params, x):
        """Data -> latent (t: 1 -> 0) with log-det accumulation."""
        return _ode_integrate(
            params, x, self.n_steps, forward=True
        )

    def inverse(self, params, z):
        """Latent -> data (t: 0 -> 1)."""
        return _ode_integrate(
            params, z, self.n_steps, forward=False
        )


def _divergence(params, t, x):
    """Exact divergence of v at each row of x."""

    def v_single(xi):
        return _velocity(params, t, xi[None, :])[0]

    def div_single(xi):
        jac = jax.jacfwd(v_single)(xi)
        return jnp.trace(jac)

    return jax.vmap(div_single)(x)


def _rk4_step_with_div(params, t, dt, carry):
    x, logp = carry

    def f(t, state):
        x, _ = state
        return (
            _velocity(params, t, x),
            -_divergence(params, t, x),
        )

    k1 = f(t, (x, logp))
    k2 = f(t + dt / 2, (x + dt / 2 * k1[0], logp))
    k3 = f(t + dt / 2, (x + dt / 2 * k2[0], logp))
    k4 = f(t + dt, (x + dt * k3[0], logp))
    x_new = x + dt / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    logp_new = logp + dt / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    return x_new, logp_new


def _ode_integrate(params, x, n_steps: int, forward: bool):
    """RK4 transport with divergence accumulation under ``lax.scan``.

    Returns ``(out, log_det)`` following the discrete-flow conventions
    used by :class:`~aspire_tpu.flows.base.Flow` in each direction.
    """
    dt = (-1.0 if forward else 1.0) / n_steps
    t0 = 1.0 if forward else 0.0

    def step(carry, i):
        t = t0 + i * dt
        return _rk4_step_with_div(params, t, dt, carry), None

    (out, delta), _ = jax.lax.scan(
        step,
        (x, jnp.zeros(x.shape[0], dtype=x.dtype)),
        jnp.arange(n_steps),
    )
    return out, -delta


def _velocity(params, t, x):
    """v(t, x) for a batch; t scalar in [0, 1]."""
    tvec = jnp.full((x.shape[0], 1), t, dtype=x.dtype)
    feats = jnp.concatenate([x, tvec, 1.0 - tvec], axis=-1)
    return apply_mlp(params, feats)


class FlowMatching(Flow):
    """CNF proposal trained by conditional flow matching."""

    def __init__(
        self,
        dims: int,
        data_transform=None,
        key: jax.Array | int | None = None,
        dtype: str = "float32",
        n_hidden: tuple = (128, 128, 128),
        n_steps: int = 64,
        **kwargs: Any,
    ):
        self.n_steps = n_steps
        self._n_hidden = tuple(n_hidden)
        # Bypass Flow.__init__'s architecture plumbing; set up manually.
        self.dims = dims
        self.dtype = jnp.dtype(dtype)
        self._architecture_name = "flow_matching"
        self.architecture = _VelocityField(
            dims, tuple(n_hidden), str(self.dtype), n_steps
        )
        self._architecture_kwargs = {
            "n_hidden": list(n_hidden),
            "n_steps": n_steps,
        }
        from ..transforms import IdentityTransform

        self.data_transform = data_transform or IdentityTransform(dtype=dtype)
        if key is None:
            key = jax.random.key(0)
        elif isinstance(key, int):
            key = jax.random.key(key)
        self._key = key
        self._key, init_key = jax.random.split(self._key)
        self.params = self.architecture.init(init_key)

        arch = self.architecture
        self._latent_log_prob = jax.jit(
            lambda params, x: arch.forward(params, x)
        )
        self._latent_inverse = jax.jit(
            lambda params, z: arch.inverse(params, z)
        )

    def config_dict(self) -> dict:
        return {
            "dims": self.dims,
            "architecture": "flow_matching",
            "dtype": str(self.dtype),
            "architecture_config": {
                "n_hidden": list(self._n_hidden),
                "n_steps": self.n_steps,
            },
        }

    # -- training ----------------------------------------------------------

    def loss_fn(self, params, batch, key):
        """Linear-path CFM loss: ||v(t, x_t) - (x1 - x0)||^2."""
        n = batch.shape[0]
        t_key, noise_key = jax.random.split(key)
        t = jax.random.uniform(t_key, (n, 1), dtype=batch.dtype)
        x0 = standard_normal_sample(noise_key, batch.shape, batch.dtype)
        x_t = (1 - t) * x0 + t * batch
        target = batch - x0
        tvec = jnp.concatenate([t, 1.0 - t], axis=-1)
        feats = jnp.concatenate([x_t, tvec], axis=-1)
        v = apply_mlp(params, feats)
        return jnp.mean(jnp.sum((v - target) ** 2, axis=-1))

