"""Elementwise bijector math for flows.

Pure functions over batched arrays — internalizes the transformer math the
reference imports from ``flowjax``/``zuko`` (SURVEY.md §2.3): affine
(shift/scale) transformers for MAF/RealNVP and monotonic
rational-quadratic splines (Durkan et al. 2019, arXiv:1906.04032) for
spline flows. Everything is elementwise VPU work that XLA fuses into the
surrounding matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


# ---------------------------------------------------------------------------
# Affine transformer
# ---------------------------------------------------------------------------


def affine_forward(x, shift, log_scale):
    """y = x * exp(log_scale) + shift; elementwise log|dy/dx| = log_scale."""
    return x * jnp.exp(log_scale) + shift, log_scale


def affine_inverse(y, shift, log_scale):
    return (y - shift) * jnp.exp(-log_scale), -log_scale


def constrain_log_scale(raw, bound: float = 3.0):
    """Soft-clamp raw log-scales to (-bound, bound) for stability."""
    return bound * jnp.tanh(raw / bound)


# ---------------------------------------------------------------------------
# Rational-quadratic spline transformer
# ---------------------------------------------------------------------------


def _parse_spline_params(
    raw,
    num_bins: int,
    tail_bound: float,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """Convert raw params ``(..., 3K - 1)`` into knots and derivatives.

    Returns (x_knots, y_knots, derivatives) with shapes ``(..., K+1)``,
    ``(..., K+1)``, ``(..., K+1)``; boundary derivatives fixed so the
    spline matches the identity linear tails at +/- tail_bound.
    """
    w_raw = raw[..., :num_bins]
    h_raw = raw[..., num_bins : 2 * num_bins]
    d_raw = raw[..., 2 * num_bins :]

    widths = jax.nn.softmax(w_raw, axis=-1)
    widths = min_bin_width + (1 - min_bin_width * num_bins) * widths
    heights = jax.nn.softmax(h_raw, axis=-1)
    heights = min_bin_height + (1 - min_bin_height * num_bins) * heights

    x_knots = jnp.cumsum(widths, axis=-1) * (2 * tail_bound) - tail_bound
    x_knots = jnp.concatenate(
        [jnp.full_like(x_knots[..., :1], -tail_bound), x_knots], axis=-1
    )
    y_knots = jnp.cumsum(heights, axis=-1) * (2 * tail_bound) - tail_bound
    y_knots = jnp.concatenate(
        [jnp.full_like(y_knots[..., :1], -tail_bound), y_knots], axis=-1
    )

    derivs = min_derivative + jax.nn.softplus(d_raw)
    # Boundary derivative chosen so softplus(raw=0)+min == 1 at init is not
    # required; fix the endpoints at exactly 1 to match the linear tails.
    ones = jnp.ones_like(derivs[..., :1])
    derivs = jnp.concatenate([ones, derivs, ones], axis=-1)
    return x_knots, y_knots, derivs


def rational_quadratic_spline(
    inputs,
    raw_params,
    num_bins: int,
    tail_bound: float = 5.0,
    inverse: bool = False,
):
    """Monotonic RQS with linear tails.

    ``inputs``: any shape; ``raw_params``: inputs.shape + (3*num_bins-1,).
    Returns ``(outputs, elementwise_log_abs_det)``. Outside
    ``[-tail_bound, tail_bound]`` the transform is the identity.
    """
    x_knots, y_knots, derivs = _parse_spline_params(
        raw_params, num_bins, tail_bound
    )

    inside = (inputs > -tail_bound) & (inputs < tail_bound)
    # Clamp for safe bin selection; outside values pass through unchanged.
    safe = jnp.clip(inputs, -tail_bound, tail_bound)

    ref_knots = y_knots if inverse else x_knots
    # Find bin index k such that ref_knots[k] <= value < ref_knots[k+1].
    k = (
        jnp.sum((safe[..., None] >= ref_knots[..., :-1]), axis=-1) - 1
    )
    k = jnp.clip(k, 0, num_bins - 1)

    # One-hot contraction instead of take_along_axis: a (..., K) mask
    # reduction is elementwise work that XLA fuses, with no gather.
    onehot = (
        k[..., None]
        == jax.lax.broadcasted_iota(k.dtype, k.shape + (num_bins,), k.ndim)
    ).astype(raw_params.dtype)

    def take(a):
        return jnp.sum(a * onehot, axis=-1)

    x_k = take(x_knots[..., :-1])
    x_k1 = take(x_knots[..., 1:])
    y_k = take(y_knots[..., :-1])
    y_k1 = take(y_knots[..., 1:])
    d_k = take(derivs[..., :-1])
    d_k1 = take(derivs[..., 1:])

    w = x_k1 - x_k
    h = y_k1 - y_k
    s = h / w

    if not inverse:
        xi = (safe - x_k) / w
        xi = jnp.clip(xi, 0.0, 1.0)
        xi_1m = 1 - xi
        num = h * (s * xi**2 + d_k * xi * xi_1m)
        den = s + (d_k1 + d_k - 2 * s) * xi * xi_1m
        outputs = y_k + num / den
        log_det_num = 2 * jnp.log(s) + jnp.log(
            d_k1 * xi**2 + 2 * s * xi * xi_1m + d_k * xi_1m**2
        )
        log_det = log_det_num - 2 * jnp.log(den)
    else:
        # Solve the quadratic a xi^2 + b xi + c = 0 for xi in [0, 1].
        y_rel = safe - y_k
        a = h * (s - d_k) + y_rel * (d_k1 + d_k - 2 * s)
        b = h * d_k - y_rel * (d_k1 + d_k - 2 * s)
        c = -s * y_rel
        disc = b**2 - 4 * a * c
        disc = jnp.maximum(disc, 0.0)
        # Numerically stable root: xi = 2c / (-b - sqrt(disc)).
        xi = (2 * c) / (-b - jnp.sqrt(disc))
        xi = jnp.clip(xi, 0.0, 1.0)
        xi_1m = 1 - xi
        outputs = xi * w + x_k
        den = s + (d_k1 + d_k - 2 * s) * xi * xi_1m
        log_det_num = 2 * jnp.log(s) + jnp.log(
            d_k1 * xi**2 + 2 * s * xi * xi_1m + d_k * xi_1m**2
        )
        log_det = -(log_det_num - 2 * jnp.log(den))

    outputs = jnp.where(inside, outputs, inputs)
    log_det = jnp.where(inside, log_det, 0.0)
    return outputs, log_det


# ---------------------------------------------------------------------------
# Standard normal base distribution
# ---------------------------------------------------------------------------


def standard_normal_log_prob(z):
    """Log N(z; 0, I) reduced over the last axis."""
    d = z.shape[-1]
    return -0.5 * jnp.sum(z**2, axis=-1) - 0.5 * d * jnp.log(2 * jnp.pi)


def standard_normal_sample(key, shape, dtype=jnp.float32):
    return jax.random.normal(key, shape, dtype=dtype)
