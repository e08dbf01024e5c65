"""On-device particle resampling.

The reference resamples by dropping to host numpy and calling
``rng.choice`` (multinomial; ``samples.py:1251-1287``) — a host round-trip
per SMC iteration. Here every scheme runs on device with static shapes:

- ``systematic`` (default; lower-variance upgrade over the reference's
  multinomial, kept as the default per BASELINE.json),
- ``multinomial`` (parity with the reference for comparison runs),
- ``stratified`` and ``residual`` for completeness.

All schemes reduce to: build an inclusion-count / index vector from the
normalized weights, then gather rows. Index construction is a cumulative
sum + ``searchsorted`` — O(n log n) on device, no host sync. Under a
sharded mesh the weights are all-gathered (they are O(n) scalars, tiny
compared to the (n, d) particle array) and the gather is a collective-aware
``jnp.take`` on the sharded particle array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _normalized_weights(log_w: jax.Array) -> jax.Array:
    log_w = log_w - jax.scipy.special.logsumexp(log_w)
    return jnp.exp(log_w)


def systematic_resample(
    key: jax.Array, log_w: jax.Array, n_out: int | None = None
) -> jax.Array:
    """Systematic resampling: one uniform offset, n evenly spaced points.

    Returns indices of shape ``(n_out,)`` into the particle array.
    """
    n = log_w.shape[0]
    n_out = n_out or n
    w = _normalized_weights(log_w)
    cdf = jnp.cumsum(w)
    # Guard against round-off: force the final CDF value to 1.
    cdf = cdf / cdf[-1]
    u0 = jax.random.uniform(key, ())
    pts = (u0 + jnp.arange(n_out)) / n_out
    idx = jnp.searchsorted(cdf, pts, side="left")
    return jnp.clip(idx, 0, n - 1)


def stratified_resample(
    key: jax.Array, log_w: jax.Array, n_out: int | None = None
) -> jax.Array:
    """Stratified resampling: one uniform per stratum."""
    n = log_w.shape[0]
    n_out = n_out or n
    w = _normalized_weights(log_w)
    cdf = jnp.cumsum(w)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key, (n_out,))
    pts = (u + jnp.arange(n_out)) / n_out
    idx = jnp.searchsorted(cdf, pts, side="left")
    return jnp.clip(idx, 0, n - 1)


def multinomial_resample(
    key: jax.Array, log_w: jax.Array, n_out: int | None = None
) -> jax.Array:
    """Multinomial resampling (parity with reference samples.py:1277-1278)."""
    n = log_w.shape[0]
    n_out = n_out or n
    return jax.random.categorical(key, log_w, shape=(n_out,))


def residual_resample(
    key: jax.Array, log_w: jax.Array, n_out: int | None = None
) -> jax.Array:
    """Residual resampling: deterministic floor counts + multinomial rest.

    Implemented with static shapes: the deterministic part is expressed as a
    repeat-by-counts gather built from a cumulative sum, and the residual
    part reuses multinomial sampling on the residual weights.
    """
    n = log_w.shape[0]
    n_out = n_out or n
    w = _normalized_weights(log_w)
    counts = jnp.floor(n_out * w).astype(jnp.int32)
    n_det = jnp.sum(counts)
    # Deterministic replication: position j in the output takes particle i
    # where i is the bucket of j in the cumulative counts.
    ends = jnp.cumsum(counts)
    det_idx = jnp.searchsorted(ends, jnp.arange(n_out), side="right")
    det_idx = jnp.clip(det_idx, 0, n - 1)
    # Residual multinomial for the remaining slots.
    resid = n_out * w - counts
    resid_log_w = jnp.log(jnp.maximum(resid, 1e-38))
    mult_idx = jax.random.categorical(key, resid_log_w, shape=(n_out,))
    slot = jnp.arange(n_out)
    return jnp.where(slot < n_det, det_idx, mult_idx)


_SCHEMES = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
    "residual": residual_resample,
}


# ---------------------------------------------------------------------------
# Hand-rolled sharded resampling (SURVEY.md §5, BASELINE.md)
# ---------------------------------------------------------------------------
#
# The default path lets GSPMD lower the global gather `x[idx]` however it
# likes. This is the explicit alternative, written with shard_map so the
# collective schedule is pinned:
#
#   1. all_gather the LOG-WEIGHTS only — O(n) scalars, tiny next to the
#      (n, d) particle array;
#   2. every shard computes the identical global systematic index vector
#      (same key => same single uniform => bit-identical to the GSPMD
#      path) and slices out its own output rows;
#   3. the particle blocks stream around a ppermute RING: in S steps
#      each shard sees every block once and copies out the rows it
#      needs. Peak memory stays O(chunk * d) per device — the global
#      particle array is never materialized anywhere — and total bytes
#      moved (n * d per device around the ring) meet the all-to-all
#      redistribution lower bound.


_RING_CACHE: dict = {}


def ring_resample_matrix(key, log_w, data, mesh, axis_name: str = "data",
                         method: str = "systematic",
                         n_out: int | None = None):
    """Resample a row-sharded ``(n, cols)`` matrix on a 1-D mesh.

    ``log_w`` must carry the same ``P(axis_name)`` sharding as ``data``.
    Returns the resampled matrix with the input sharding, bit-identical
    to ``data[get_resampler(method)(key, log_w, n_out)]`` evaluated in
    the replicated (single-device) summation order — the collective
    impls always agree with each other and with that order; GSPMD's
    sharded lowering of the f32 weight prefix-sum may reorder the
    summation and flip a small fraction of bin-boundary assignments at
    large n. The jitted shard_map program is cached per
    (mesh, axis, method, n_out) so repeated SMC iterations hit the
    compile cache instead of re-tracing.

    ``n_out`` (default ``n``) selects a different output population
    size — e.g. the ``M = n/k`` ancestor population of waste-free SMC —
    and must tile the mesh.
    """
    n_shards = int(mesh.devices.size)
    if n_out is not None and n_out % n_shards:
        raise ValueError(
            f"n_out ({n_out}) must be divisible by the mesh size "
            f"({n_shards}) — each shard emits n_out/S rows."
        )
    cache_key = (mesh, axis_name, method, n_out)
    cached = _RING_CACHE.get(cache_key)
    if cached is None:
        cached = _build_ring_resampler(mesh, axis_name, method, n_out)
        _RING_CACHE[cache_key] = cached
    return cached(key, log_w, data)


def _build_ring_resampler(mesh, axis_name: str, method: str,
                          n_out: int | None = None):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    n_shards = mesh.devices.size
    resampler = get_resampler(method)
    ring = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def local_fn(key, lw_local, block):
        chunk = block.shape[0]
        out_rows = (n_out // n_shards) if n_out is not None else chunk
        lw_global = jax.lax.all_gather(
            lw_local, axis_name, tiled=True
        )
        idx = resampler(
            key,
            lw_global,
            n_out if n_out is not None else lw_global.shape[0],
        )
        me = jax.lax.axis_index(axis_name)
        idx_mine = jax.lax.dynamic_slice_in_dim(
            idx, me * out_rows, out_rows
        )
        out0 = jnp.zeros((out_rows, block.shape[1]), block.dtype)

        def ring_step(r, carry):
            held, out = carry
            src = (me - r) % n_shards  # whose block we hold this step
            rows = idx_mine - src * chunk
            want = (rows >= 0) & (rows < chunk)
            picked = held[jnp.clip(rows, 0, chunk - 1)]
            out = jnp.where(want[:, None], picked, out)
            held = jax.lax.ppermute(held, axis_name, perm=ring)
            return held, out

        _, out = jax.lax.fori_loop(
            0, n_shards, ring_step, (block, out0)
        )
        return out

    sharded = NamedSharding(mesh, P(axis_name))
    return jax.jit(
        shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
            check_vma=False,
        ),
        in_shardings=(NamedSharding(mesh, P()), sharded, sharded),
        out_shardings=sharded,
    )


# ---------------------------------------------------------------------------
# Pod-scale alternative: count-based all_to_all redistribution
# ---------------------------------------------------------------------------
#
# The ring streams EVERY particle block through EVERY shard: n * d bytes
# per device regardless of how much actually moves. At pod scale most
# resampled rows stay on their own shard (systematic resampling with
# roughly balanced weights maps output block t mostly onto input block
# t), so the bandwidth-optimal schedule sends only the rows that change
# shards: every shard computes the identical global index vector
# (prefix-sum of weights -> systematic positions), derives the exact
# per-(src, dst) transfer lists from it, and exchanges fixed-capacity
# buckets in ONE all_to_all. Ragged reality meets static shapes via the
# ``cap`` rows-per-pair bound; the rare overflow (severely concentrated
# weights) is detected globally in-program and the result falls back to
# the ring schedule inside a ``lax.cond`` — correctness never depends
# on the cap.

_A2A_CACHE: dict = {}


def alltoall_resample_matrix(
    key,
    log_w,
    data,
    mesh,
    axis_name: str = "data",
    method: str = "systematic",
    cap: int | None = None,
    n_out: int | None = None,
):
    """Resample a row-sharded ``(n, cols)`` matrix via bucketed all_to_all.

    Bit-identical to :func:`ring_resample_matrix` (same key, same global
    index vector); moves ``O(S * cap * cols)`` bytes per device instead
    of the ring's ``O(n * cols)``. ``cap`` bounds the rows any single
    (src, dst) shard pair may exchange; overflow triggers an in-program
    fallback to the ring schedule. ``n_out`` (default ``n``) selects a
    smaller mesh-tiling output population (waste-free ancestors).
    """
    n_shards = int(mesh.devices.size)
    if n_out is not None and n_out % n_shards:
        raise ValueError(
            f"n_out ({n_out}) must be divisible by the mesh size "
            f"({n_shards}) — each shard emits n_out/S rows."
        )
    out_chunk = (n_out or data.shape[0]) // n_shards
    if cap is None:
        # Balanced resampling needs ~out_chunk/S rows per pair; 4x
        # headroom (+ a floor) keeps the fallback rare without
        # re-creating the ring's full-matrix traffic.
        cap = min(out_chunk, max(4 * out_chunk // n_shards, 16))
    cap = min(int(cap), out_chunk)
    cache_key = (mesh, axis_name, method, int(cap), n_out)
    cached = _A2A_CACHE.get(cache_key)
    if cached is None:
        cached = _build_alltoall_resampler(
            mesh, axis_name, method, int(cap), n_out
        )
        _A2A_CACHE[cache_key] = cached
    return cached(key, log_w, data)


def _build_alltoall_resampler(
    mesh, axis_name: str, method: str, cap: int,
    n_out: int | None = None,
):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    n_shards = mesh.devices.size
    resampler = get_resampler(method)
    ring = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def local_fn(key, lw_local, block):
        chunk = block.shape[0]
        out_rows = (n_out // n_shards) if n_out is not None else chunk
        me = jax.lax.axis_index(axis_name)
        lw_global = jax.lax.all_gather(lw_local, axis_name, tiled=True)
        idx = resampler(
            key,
            lw_global,
            n_out if n_out is not None else lw_global.shape[0],
        )  # (n_out,)

        # -- sender: bucket MY rows by destination block --------------
        sends = []
        overflow = jnp.zeros((), jnp.bool_)
        for t in range(n_shards):
            idx_t = jax.lax.dynamic_slice_in_dim(
                idx, t * out_rows, out_rows
            )
            mine = (idx_t // chunk) == me
            # Stable compaction: rows destined to t, in t's row order.
            order = jnp.argsort(~mine)
            rows = jnp.where(mine, idx_t - me * chunk, 0)[order]
            sends.append(block[rows[:cap]])
            overflow = overflow | (jnp.sum(mine) > cap)
        send = jnp.stack(sends)  # (S, cap, cols)
        recv = jax.lax.all_to_all(
            send, axis_name, split_axis=0, concat_axis=0, tiled=True
        )  # recv[s] = rows shard s prepared for me, in my row order

        # -- receiver: place each row by its per-source running rank --
        idx_me = jax.lax.dynamic_slice_in_dim(
            idx, me * out_rows, out_rows
        )
        src = idx_me // chunk  # (out_rows,)
        onehot = src[:, None] == jnp.arange(n_shards)[None, :]
        rank = (
            jnp.take_along_axis(
                jnp.cumsum(onehot, axis=0), src[:, None], axis=1
            )[:, 0]
            - 1
        )
        out_a2a = recv[src, jnp.minimum(rank, cap - 1)]

        # -- overflow fallback: the ring schedule, same index vector --
        any_overflow = jax.lax.pmax(overflow, axis_name)

        def ring_path(_):
            out0 = jnp.zeros((out_rows, block.shape[1]), block.dtype)

            def ring_step(r, carry):
                held, out = carry
                s = (me - r) % n_shards
                rows = idx_me - s * chunk
                want = (rows >= 0) & (rows < chunk)
                picked = held[jnp.clip(rows, 0, chunk - 1)]
                out = jnp.where(want[:, None], picked, out)
                held = jax.lax.ppermute(held, axis_name, perm=ring)
                return held, out

            return jax.lax.fori_loop(
                0, n_shards, ring_step, (block, out0)
            )[1]

        return jax.lax.cond(
            any_overflow, ring_path, lambda _: out_a2a, None
        )

    sharded = NamedSharding(mesh, P(axis_name))
    return jax.jit(
        shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
            check_vma=False,
        ),
        in_shardings=(NamedSharding(mesh, P()), sharded, sharded),
        out_shardings=sharded,
    )


def get_resampler(name: str):
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"Unknown resampling scheme '{name}'. "
            f"Choose from {sorted(_SCHEMES)}"
        ) from None
