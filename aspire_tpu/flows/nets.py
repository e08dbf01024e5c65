"""Neural network building blocks for flows (pure-pytree, no framework).

Internalizes the conditioner networks the reference delegates to
``flowjax``/``zuko`` (SURVEY.md §2.3): a MADE masked autoregressive dense
network (Germain et al. 2015) and a plain MLP conditioner for coupling
layers. Parameters are nested dicts of JAX arrays; all forward passes are
batched matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _init_dense(key, n_in: int, n_out: int, dtype) -> dict:
    w_key, _ = jax.random.split(key)
    scale = 1.0 / np.sqrt(max(n_in, 1))
    return {
        "w": jax.random.uniform(
            w_key, (n_in, n_out), minval=-scale, maxval=scale, dtype=dtype
        ),
        "b": jnp.zeros((n_out,), dtype=dtype),
    }


# ---------------------------------------------------------------------------
# MLP (coupling-layer conditioner)
# ---------------------------------------------------------------------------


def init_mlp(
    key, n_in: int, n_hidden: list[int], n_out: int, dtype=jnp.float32
) -> dict:
    sizes = [n_in] + list(n_hidden) + [n_out]
    keys = jax.random.split(key, len(sizes) - 1)
    layers = [
        _init_dense(k, sizes[i], sizes[i + 1], dtype)
        for i, k in enumerate(keys)
    ]
    # Zero-init the output layer so the flow starts at the identity.
    layers[-1]["w"] = jnp.zeros_like(layers[-1]["w"])
    return {"layers": layers}


def apply_mlp(params: dict, x: jax.Array) -> jax.Array:
    layers = params["layers"]
    h = x
    for layer in layers[:-1]:
        h = jax.nn.relu(h @ layer["w"] + layer["b"])
    out = layers[-1]
    return h @ out["w"] + out["b"]


# ---------------------------------------------------------------------------
# MADE (masked autoregressive conditioner)
# ---------------------------------------------------------------------------


def made_masks(
    dims: int, n_hidden: list[int], n_params_per_dim: int, rng_degrees=None
) -> tuple[list[np.ndarray], np.ndarray]:
    """Build MADE masks for sequential degrees 1..dims.

    Output units for dimension i depend only on inputs with degree < i,
    giving a strictly autoregressive conditioner. Returns (masks, degrees).
    """
    degrees = [np.arange(1, dims + 1)]
    for h in n_hidden:
        # Hidden degrees cycle over 1..dims-1 (min(dims-1,1) guard for d=1).
        max_deg = max(dims - 1, 1)
        degrees.append((np.arange(h) % max_deg) + 1)
    masks = []
    for d_in, d_out in zip(degrees[:-1], degrees[1:]):
        masks.append((d_out[None, :] >= d_in[:, None]).astype(np.float32))
    # Output mask: strict inequality so output i depends on inputs < i.
    d_last = degrees[-1]
    out_deg = np.repeat(np.arange(1, dims + 1), n_params_per_dim)
    masks.append((out_deg[None, :] > d_last[:, None]).astype(np.float32))
    return masks, degrees[0]


def init_made(
    key,
    dims: int,
    n_hidden: list[int],
    n_params_per_dim: int,
    dtype=jnp.float32,
) -> tuple[dict, list[jax.Array]]:
    """Initialize a MADE network producing ``n_params_per_dim`` per input.

    Returns ``(params, masks)``; masks are static (not trained) and are
    passed to :func:`apply_made` separately so optimizers never touch them.
    """
    masks, _ = made_masks(dims, n_hidden, n_params_per_dim)
    sizes = [dims] + list(n_hidden) + [dims * n_params_per_dim]
    keys = jax.random.split(key, len(sizes) - 1)
    layers = []
    for i, k in enumerate(keys):
        layer = _init_dense(k, sizes[i], sizes[i + 1], dtype)
        layers.append(layer)
    layers[-1]["w"] = jnp.zeros_like(layers[-1]["w"])
    return {"layers": layers}, [jnp.asarray(m, dtype=dtype) for m in masks]


def apply_made(
    params: dict, masks: list[jax.Array], x: jax.Array
) -> jax.Array:
    """Masked forward pass; returns ``(batch, dims * n_params_per_dim)``.

    The output layout is ``[dim0_p0, dim0_p1, ..., dim1_p0, ...]`` so a
    ``reshape(batch, dims, n_params_per_dim)`` recovers per-dim params.
    """
    layers = params["layers"]
    h = x
    for layer, mask in zip(layers[:-1], masks[:-1]):
        h = jax.nn.relu(h @ (layer["w"] * mask) + layer["b"])
    out = layers[-1]
    return h @ (out["w"] * masks[-1]) + out["b"]
