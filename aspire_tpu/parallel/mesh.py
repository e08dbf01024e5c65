"""Device mesh and sharding for the particle axis.

The reference's only parallelism is a host process pool mapped over
likelihood evaluations (utils.py:117-193). The replacement (SURVEY.md
§2.2, §5): particles live in device-resident ``(n, d)`` arrays sharded
``P('data')`` over a flat 1-D device mesh (the cards of one host are
joined all to all, so no topology enters the mesh); every sampler computation is jitted, so XLA/GSPMD inserts
the collectives — psum trees for ESS/logZ/moment reductions, all-gathers
for the O(n) weight vectors at resampling, and the resampling gather's
data movement. No pool, no pickling: the likelihood contract is a
jittable function of the sharded array.

Multi-host: call :func:`initialize_distributed` first (wraps
``jax.distributed.initialize``), then build the mesh over all devices.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("aspire_tpu")

_MESH: Mesh | None = None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the multi-controller runtime (no-op if single process)."""
    if num_processes is None or num_processes <= 1:
        logger.debug("Single-process run; skipping jax.distributed init")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "Initialized jax.distributed: process %d / %d, %d local devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
    )


def make_mesh(
    n_devices: int | None = None, axis_name: str = "data"
) -> Mesh:
    """1-D mesh over (up to) ``n_devices`` devices for the particle axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def get_mesh(axis_name: str = "data") -> Mesh:
    """Process-wide default mesh (created over all devices on first use)."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh(axis_name=axis_name)
    return _MESH


def set_mesh(mesh: Mesh | None) -> None:
    global _MESH
    _MESH = mesh


def particle_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """Sharding for ``(n, ...)`` particle arrays: rows over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def walker_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """Sharding for ``(T, n, ...)`` tempered ensembles: walkers over the
    mesh, temperature axis replicated.

    Used by the parallel-tempering sampler: every rung's walkers split
    across devices, so the tempered stretch sweeps (the likelihood-eval
    bulk) run SPMD while replica swaps — elementwise in the walker
    axis — stay device-local.
    """
    return NamedSharding(mesh, P(None, axis_name))


def shard_particles(tree, mesh: Mesh, axis_name: str = "data"):
    """Place every array in ``tree`` with its leading axis sharded.

    Arrays whose leading dimension is not divisible by the mesh size are
    replicated instead (scalars, small state).
    """
    n_shards = mesh.devices.size
    sharded = particle_sharding(mesh, axis_name)
    replicated = replicated_sharding(mesh)

    def place(leaf):
        leaf = jax.numpy.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[0] % n_shards == 0:
            return jax.device_put(leaf, sharded)
        return jax.device_put(leaf, replicated)

    return jax.tree_util.tree_map(place, tree)


def pad_to_shards(x, mesh: Mesh):
    """Pad the leading axis up to a multiple of the mesh size.

    Returns ``(padded, n_valid)``. SMC particle counts should be chosen
    divisible by the mesh size; this helper exists for ragged final
    resamples.
    """
    import jax.numpy as jnp

    n = x.shape[0]
    n_shards = mesh.devices.size
    rem = (-n) % n_shards
    if rem == 0:
        return x, n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, mode="edge"), n
