"""Fused coupling-flow density pass for NVIDIA GPUs (Pallas, Triton route).

The coupling flow's density direction (``Coupling._forward_xla``: data
-> latent, the spline *inverse* in every layer) runs once per particle
per SMC mutation step. Per layer it is a small MLP (two or three dense
layers) followed by elementwise rational-quadratic-spline (or affine)
math. Under XLA every dense layer writes its ``(n, hidden)`` or
``(n, dims * params)`` activation to device memory and the spline reads
it back; this kernel keeps one block of particles in registers through
every layer and writes only ``(z, log_det)``.

Layout: particles on rows, one program per block of rows. The dims are
split by parity into an even and an odd half (the coupling masks
alternate by parity, so every layer transforms one half conditioned on
the other), each padded to a power of two ``A``. The spline parameters
of one layer come from three output products of width ``A * num_bins``
(widths, heights, derivatives), reshaped to ``(rows, A, num_bins)``, so
the bin search is a masked reduction over the last axis. Products run
through ``pl.dot``; an output group narrower than Triton's minimum dot
size (16) is zero-padded to 16 columns and split off afterwards, and a
conditioner input narrower than 16 is contracted column by column.

The dots follow JAX's default matmul precision, as XLA's do: TF32 on the
tensor cores by default, full float32 under
``jax.default_matmul_precision("highest")``. Gradients come from a
``jax.custom_vjp`` whose backward pass recomputes through
``Coupling._forward_xla``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..flows.bijectors import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
)

# Triton's smallest dot operand dimension.
_MIN_DOT = 16

# The flows the kernel is chosen for. chip_smoke.py's parity sweep runs
# the compiled kernel against XLA on an H100 at every value of each axis
# (every dims x transformer pair, each depth, hidden width and bin
# count); a flow outside them stays on XLA. On an H100: d=1 (one fixed
# spline, no conditioning product to fuse) gave the kernel's largest
# error relative to XLA's (2.85x its maximum log_det error); compile
# time grows steeply with hidden width (3 x (16, 16) in 4.5 s, 3 x (64,
# 64) in 14 s, 6 x (128, 128) not within 170 s); the d=8 flow at 6 x
# (128, 128) won 2.0x end to end but is not yet checked.
_MIN_DIMS, _MAX_DIMS = 2, 4
_MAX_LAYERS = 4
_MAX_HIDDEN_LAYERS = 2
_HIDDEN_WIDTHS = (16, 32, 64)
_NUM_BINS = (4, 8, 16)

# Rows and warps per program, the fastest of blocks {64, 128, 256} x
# warps {2, 4, 8} on an H100 at d=4, n=131072
# (benchmarks/coupling_kernel_trial.py --sweep). The kernel beat XLA's
# density pass at every population timed (256 to 131072), so any whole
# number of blocks takes it.
_BLOCK = 64
_NUM_WARPS = 4


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Static shape of one kernel instance."""

    dims: int
    n_layers: int
    n_hidden: tuple
    transformer: str
    num_bins: int
    tail_bound: float
    block: int
    num_warps: int

    @property
    def half(self) -> int:
        """Padded width ``A`` of each parity half (at least 2)."""
        return max(_pow2((self.dims + 1) // 2), 2)

    @property
    def n_out(self) -> int:
        """Output groups per layer: widths/heights/derivs or shift/scale."""
        return 3 if self.transformer == "rqs" else 2


def kernel_config(arch) -> KernelConfig:
    """The kernel instance for the flow ``arch``."""
    return KernelConfig(
        dims=arch.dims,
        n_layers=arch.n_layers,
        n_hidden=tuple(arch.n_hidden),
        transformer=arch.transformer,
        num_bins=arch.num_bins,
        tail_bound=float(arch.tail_bound),
        block=_BLOCK,
        num_warps=_NUM_WARPS,
    )


def supported(arch) -> bool:
    """True for the float32 coupling flows inside the kernel's checked
    domain (the axes above)."""
    return (
        arch.dtype == "float32"
        and _MIN_DIMS <= arch.dims <= _MAX_DIMS
        and 1 <= arch.n_layers <= _MAX_LAYERS
        and arch.transformer in ("affine", "rqs")
        and (arch.transformer == "affine" or arch.num_bins in _NUM_BINS)
        and 1 <= len(arch.n_hidden) <= _MAX_HIDDEN_LAYERS
        and all(h in _HIDDEN_WIDTHS for h in arch.n_hidden)
    )


def use_kernel(arch, x) -> bool:
    """True when the fused kernel runs the density pass of ``arch`` on ``x``.

    Chosen on a GPU only, for a ``supported`` flow and a 2-D float32
    input whose rows divide into whole blocks. The kernel has no
    partitioning rule, so a process with more than one device keeps XLA,
    which partitions the density pass over a mesh.
    """
    if getattr(x, "ndim", None) != 2 or x.dtype != jnp.float32:
        return False
    if not supported(arch):
        return False
    n = x.shape[0]
    if n == 0 or n % _BLOCK:
        return False
    devices = jax.devices()
    return len(devices) == 1 and devices[0].platform == "gpu"


# ---------------------------------------------------------------------------
# Parameter preparation (nested layer dicts -> per-layer kernel operands)
# ---------------------------------------------------------------------------


def _parity_take(a, parity: int, width: int, axis: int):
    """Entries ``parity, parity + 2, ...`` of ``a`` along ``axis``, padded
    with zeros to ``width``. An exact gather: a one-hot product would
    round the weights to the default matmul precision (TF32 on a GPU)."""
    d = a.shape[axis]
    idx = np.arange(width) * 2 + parity
    taken = jnp.take(a, np.minimum(idx, d - 1), axis=axis)
    shape = [1] * a.ndim
    shape[axis] = width
    return jnp.where((idx < d).reshape(shape), taken, 0.0)


def prepare_params(cfg: KernelConfig, params: dict) -> list[jax.Array]:
    """Reorganise the coupling MLPs into the kernel's per-layer operands.

    Per layer: the first dense layer keeps only the rows of the
    conditioning half, ``(A, H)``; hidden layers stay ``(H, H)``; the
    output layer becomes ``n_out`` groups ``(H, A * P_g)`` holding, for
    the active half's dim ``a`` and group entry ``k``, column
    ``a * P_g + k``, zero-padded to at least 16 columns. The derivative
    group has ``num_bins - 1`` entries per dim, padded with a zero column
    to ``num_bins``. Returns the flat list ``[w, b, w, b, ...]`` over
    layers.
    """
    d, A, K = cfg.dims, cfg.half, cfg.num_bins
    P = 3 * K - 1 if cfg.transformer == "rqs" else 2
    out = []
    for layer, mlp in enumerate(params["layers"]):
        dense = mlp["layers"]
        active = layer % 2  # parity of the transformed half
        out += [_parity_take(dense[0]["w"], 1 - active, A, 0), dense[0]["b"]]
        for lyr in dense[1:-1]:
            out += [lyr["w"], lyr["b"]]
        w = dense[-1]["w"].reshape(-1, d, P)
        w = _parity_take(w, active, A, 1)  # (H, A, P)
        b = _parity_take(dense[-1]["b"].reshape(d, P), active, A, 0)  # (A, P)
        if cfg.transformer == "rqs":
            groups = [(0, K), (K, 2 * K), (2 * K, 3 * K - 1)]
        else:
            groups = [(0, 1), (1, 2)]
        for lo, hi in groups:
            width = K if cfg.transformer == "rqs" else 1
            wg = jnp.pad(w[:, :, lo:hi], ((0, 0), (0, 0), (0, width - (hi - lo))))
            bg = jnp.pad(b[:, lo:hi], ((0, 0), (0, width - (hi - lo))))
            pad = max(_MIN_DOT - A * width, 0)
            wg = jnp.pad(wg.reshape(w.shape[0], A * width), ((0, 0), (0, pad)))
            out += [wg, jnp.pad(bg.reshape(A * width), (0, pad))]
    return out


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _conditioner_input(h, w_ref):
    """``h @ w`` for the conditioning half ``h`` ``(B, A)``.

    Below the dot minimum, one outer product per input column, each
    column taken by a masked sum over the last axis.
    """
    A = h.shape[1]
    if A >= _MIN_DOT:
        return pl.dot(h, w_ref[...])
    lane = jnp.arange(A)[None, :]
    out = None
    for j in range(A):
        col = jnp.sum(jnp.where(lane == j, h, 0.0), axis=1)
        term = col[:, None] * w_ref[j][None, :]
        out = term if out is None else out + term
    return out


def _output_group(h, w_ref, b_ref, width: int):
    """One output group, ``(B, width)``, from a product padded to 16."""
    out = pl.dot(h, w_ref[...]) + b_ref[...]
    padded = w_ref.shape[1]
    if padded == width:
        return out
    return jnp.split(out, padded // width, axis=1)[0]


def _softmax(r):
    e = jnp.exp(r - jnp.max(r, axis=2, keepdims=True))
    return e / jnp.sum(e, axis=2, keepdims=True)


def _rqs_inverse(cfg: KernelConfig, v, raw):
    """Inverse RQS of ``v`` ``(B, A)`` given raw groups ``(B, A * K)``.

    Mirrors ``rational_quadratic_spline(..., inverse=True)``: the left
    knot of bin ``k`` is the cumulative sum through bin ``k - 1`` (or
    ``-tail_bound``), and the boundary derivatives are 1.
    """
    K, tb = cfg.num_bins, cfg.tail_bound
    B, A = v.shape
    w_raw, h_raw, d_raw = (r.reshape(B, A, K) for r in raw)
    widths = DEFAULT_MIN_BIN_WIDTH + (
        1 - DEFAULT_MIN_BIN_WIDTH * K
    ) * _softmax(w_raw)
    heights = DEFAULT_MIN_BIN_HEIGHT + (
        1 - DEFAULT_MIN_BIN_HEIGHT * K
    ) * _softmax(h_raw)
    x_hi = jnp.cumsum(widths, axis=2) * (2 * tb) - tb
    y_hi = jnp.cumsum(heights, axis=2) * (2 * tb) - tb
    derivs = DEFAULT_MIN_DERIVATIVE + jax.nn.softplus(d_raw)

    inside = (v > -tb) & (v < tb)
    safe = jnp.clip(v, -tb, tb)
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, 1, K), 2)
    # Bin k holds y_hi[k-1] <= safe < y_hi[k]; the last knot is excluded,
    # as in the reference's clip to K - 1.
    below = (bins < K - 1) & (safe[:, :, None] >= y_hi)
    k = jnp.sum(below.astype(jnp.int32), axis=2)
    this = bins == k[:, :, None]
    prev = bins == (k - 1)[:, :, None]

    def take(a, m):
        return jnp.sum(jnp.where(m, a, 0.0), axis=2)

    first, last = k == 0, k == K - 1
    x_k = jnp.where(first, -tb, take(x_hi, prev))
    y_k = jnp.where(first, -tb, take(y_hi, prev))
    w = take(x_hi, this) - x_k
    h = take(y_hi, this) - y_k
    d_k = jnp.where(first, 1.0, take(derivs, prev))
    d_k1 = jnp.where(last, 1.0, take(derivs, this))
    s = h / w

    y_rel = safe - y_k
    a = h * (s - d_k) + y_rel * (d_k1 + d_k - 2 * s)
    b = h * d_k - y_rel * (d_k1 + d_k - 2 * s)
    c = -s * y_rel
    disc = jnp.maximum(b**2 - 4 * a * c, 0.0)
    xi = jnp.clip((2 * c) / (-b - jnp.sqrt(disc)), 0.0, 1.0)
    xi_1m = 1 - xi
    out = xi * w + x_k
    den = s + (d_k1 + d_k - 2 * s) * xi * xi_1m
    log_det = -(
        2 * jnp.log(s)
        + jnp.log(d_k1 * xi**2 + 2 * s * xi * xi_1m + d_k * xi_1m**2)
        - 2 * jnp.log(den)
    )
    return jnp.where(inside, out, v), jnp.where(inside, log_det, 0.0)


def _affine_inverse(v, raw, bound: float = 3.0):
    shift, scale_raw = raw
    log_scale = bound * jnp.tanh(scale_raw / bound)
    return (v - shift) * jnp.exp(-log_scale), -log_scale


def _coupling_kernel(cfg: KernelConfig, x_ref, *refs):
    """One block of particles through every coupling layer."""
    z_ref, ld_ref = refs[-2], refs[-1]
    w_refs = refs[:-2]
    A = cfg.half
    n_dense = len(cfg.n_hidden) + 1
    per_layer = 2 * (n_dense - 1 + cfg.n_out)
    lane = jnp.arange(A)
    n_dims = ((cfg.dims + 1) // 2, cfg.dims // 2)  # even, odd halves
    ok = [(lane < m)[None, :] for m in n_dims]
    in_row = (jnp.arange(2 * A) < cfg.dims)[None, :]
    # Split the row block into its even and odd dims by a reshape and a
    # split of the trailing pair (Triton slices registers no other way).
    x = plgpu.load(x_ref, mask=in_row, other=0.0)
    halves = [
        h.reshape(cfg.block, A)
        for h in jnp.split(x.reshape(cfg.block, A, 2), 2, axis=2)
    ]
    log_det = jnp.zeros((cfg.block,), jnp.float32)
    for layer in range(cfg.n_layers):
        ops = w_refs[layer * per_layer:(layer + 1) * per_layer]
        p = layer % 2
        h = jax.nn.relu(_conditioner_input(halves[1 - p], ops[0]) + ops[1][...])
        for j in range(1, n_dense - 1):
            h = jax.nn.relu(pl.dot(h, ops[2 * j][...]) + ops[2 * j + 1][...])
        width = A * (cfg.num_bins if cfg.transformer == "rqs" else 1)
        raw = [
            _output_group(h, ops[2 * j], ops[2 * j + 1], width)
            for j in range(n_dense - 1, n_dense - 1 + cfg.n_out)
        ]
        if cfg.transformer == "rqs":
            y, eld = _rqs_inverse(cfg, halves[p], raw)
        else:
            y, eld = _affine_inverse(halves[p], raw)
        halves[p] = jnp.where(ok[p], y, 0.0)
        log_det = log_det + jnp.sum(jnp.where(ok[p], eld, 0.0), axis=1)
    z = jnp.concatenate([h.reshape(cfg.block, A, 1) for h in halves], axis=2)
    plgpu.store(z_ref, z.reshape(cfg.block, 2 * A), mask=in_row)
    ld_ref[...] = log_det


def coupling_density_pallas(cfg: KernelConfig, prepared, x, interpret=False):
    """Run the kernel on ``x`` ``(n, d)``; ``n`` a multiple of the block."""
    n, d = x.shape
    if n % cfg.block:
        raise ValueError(f"n={n} is not a multiple of block={cfg.block}")
    width = 2 * cfg.half
    row_block = pl.BlockSpec((cfg.block, width), lambda i: (i, 0))
    weight_specs = [
        pl.BlockSpec(w.shape, lambda i, nd=w.ndim: (0,) * nd)
        for w in prepared
    ]
    return pl.pallas_call(
        functools.partial(_coupling_kernel, cfg),
        out_shape=(
            jax.ShapeDtypeStruct((n, d), x.dtype),
            jax.ShapeDtypeStruct((n,), x.dtype),
        ),
        grid=(n // cfg.block,),
        in_specs=[row_block] + weight_specs,
        out_specs=(row_block, pl.BlockSpec((cfg.block,), lambda i: (i,))),
        compiler_params=plgpu.CompilerParams(num_warps=cfg.num_warps),
        interpret=interpret,
        name="coupling_density",
    )(x, *prepared)


# ---------------------------------------------------------------------------
# custom_vjp wrapper: fused forward, XLA-recompute backward
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def coupling_density(arch, params, x):
    """Fused ``Coupling._forward_xla``: returns ``(z, log_det)``."""
    cfg = kernel_config(arch)
    return coupling_density_pallas(cfg, prepare_params(cfg, params), x)


def _density_fwd(arch, params, x):
    return coupling_density(arch, params, x), (params, x)


def _density_bwd(arch, res, cotangents):
    params, x = res
    _, vjp = jax.vjp(arch._forward_xla, params, x)
    return vjp(cotangents)


coupling_density.defvjp(_density_fwd, _density_bwd)
