"""HDF5 persistence.

Single-file HDF5 layout with the same top-level semantics as the reference
(``docs/checkpointing.rst:18-27``: ``/aspire_config``, ``/sampler_config``,
``/flow``, ``/checkpoint/state``), with two array formats:

- pytrees (flow params, optimizer state) stored leaf-by-leaf as native
  HDF5 datasets with the treedef as a JSON attribute — small, replicated
  state written by one writer (:func:`save_pytree_to_hdf5`);
- particle arrays stored SHARD-WISE (:func:`save_sharded_array` /
  :func:`load_sharded_array`): each process writes only its locally
  addressable shards as hyperslab datasets tagged with global offsets,
  and loading reassembles through ``jax.make_array_from_callback`` so
  each device reads only its own region — no global gather on either
  side, and resharding across different meshes on resume.

Reference equivalents: ``AspireFile`` (utils.py:910-928),
``recursively_save_to_h5_file``/``load_from_h5_file`` (utils.py:841-887),
``encode_for_hdf5``/``decode_from_hdf5`` (utils.py:652-730),
``dump_state``/pickle-bytes datasets (utils.py:733-770).
"""

from __future__ import annotations

import json
import pickle
from typing import Any

import jax
import numpy as np

from . import __version__ as _pkg_version
from .utils import to_numpy

_NONE = "__none__"
_EMPTY_DICT = "__empty_dict__"
_PICKLE = "__pickle__"
_STRING = "__string__"


def _h5py():
    """Import h5py at first use: only checkpoints and result files need it."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(
            "HDF5 files (checkpoints, saved results) need the h5py package"
        ) from err
    return h5py


def AspireFile(*args, **kwargs):
    """Open an ``h5py.File`` stamped with the package version attribute.

    Parity: reference ``AspireFile`` (utils.py:910-928).
    """
    f = _h5py().File(*args, **kwargs)
    if f.mode != "r":
        f.attrs["aspire_tpu_version"] = _pkg_version
    return f


def _encode_value(value: Any) -> Any:
    """Encode a single value into an HDF5-storable form."""
    if value is None:
        return np.bytes_(_NONE)
    if isinstance(value, str):
        return np.bytes_(_STRING + value)
    if isinstance(value, (bool, np.bool_)):
        return np.bool_(value)
    if isinstance(value, (int, float, complex, np.number)):
        return value
    if isinstance(value, jax.Array):
        return to_numpy(value)
    if isinstance(value, np.ndarray):
        return value
    if isinstance(value, (list, tuple)):
        try:
            arr = np.asarray(value)
            if arr.dtype.kind in "ifubc":
                return arr
            if arr.dtype.kind == "U":
                return np.array([s.encode() for s in arr.ravel()]).reshape(
                    arr.shape
                )
        except (ValueError, TypeError):
            pass
    # Fallback: pickle bytes with sentinel prefix.
    return np.void(_PICKLE.encode() + pickle.dumps(value))


def _decode_value(value: Any) -> Any:
    if isinstance(value, bytes):
        if value == _NONE.encode():
            return None
        if value.startswith(_STRING.encode()):
            return value[len(_STRING) :].decode()
        return value.decode()
    if isinstance(value, np.void):
        raw = bytes(value.tobytes())
        if raw.startswith(_PICKLE.encode()):
            return pickle.loads(raw[len(_PICKLE) :])
        return raw
    if isinstance(value, np.ndarray):
        if value.dtype.kind == "S":
            if value.ndim == 0:
                return _decode_value(value.item())
            return [_decode_value(v) for v in value.ravel()]
        if value.ndim == 0:
            return value.item()
        return value
    if isinstance(value, np.generic):
        return value.item()
    return value


def save_dict_to_hdf5(h5_file, path: str, dictionary: dict) -> None:
    """Recursively save a (possibly nested) dict under ``path``.

    Parity: reference ``recursively_save_to_h5_file`` (utils.py:841-887).
    Existing groups/datasets at the same keys are overwritten.
    """
    if path in h5_file:
        del h5_file[path]
    group = h5_file.require_group(path)
    _save_dict(group, dictionary)


def _save_dict(group, dictionary: dict) -> None:
    for key, value in dictionary.items():
        key = str(key)
        if key in group:
            del group[key]
        if isinstance(value, dict):
            if not value:
                group.create_dataset(key, data=np.bytes_(_EMPTY_DICT))
            else:
                sub = group.create_group(key)
                _save_dict(sub, value)
        else:
            group.create_dataset(key, data=_encode_value(value))


def load_dict_from_hdf5(h5_file, path: str) -> dict:
    """Recursively load a dict saved with :func:`save_dict_to_hdf5`."""
    group = h5_file[path]
    return _load_group(group)


def _load_group(group) -> dict:
    out = {}
    for key, item in group.items():
        if isinstance(item, _h5py().Group):
            out[key] = _load_group(item)
        else:
            value = item[()]
            if isinstance(value, bytes) and value == _EMPTY_DICT.encode():
                out[key] = {}
            else:
                out[key] = _decode_value(value)
    return out


# ---------------------------------------------------------------------------
# Pytree <-> HDF5 (flows, optimizer states, sampler state)
# ---------------------------------------------------------------------------


def save_pytree_to_hdf5(h5_file, path: str, tree: Any) -> None:
    """Save a pytree: leaves as datasets ``leaf_{i}``, treedef as JSON attr.

    Array leaves are written as native numeric datasets (mmap-able,
    shard-writable); non-array leaves are JSON-encoded into the structure
    attribute. This replaces the reference's equinox partition/flatten
    serialization (flows/jax/flows.py:219-328) with a library-agnostic
    format stable across versions.
    """
    if path in h5_file:
        del h5_file[path]
    group = h5_file.require_group(path)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    spec = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, (jax.Array, np.ndarray)):
            arr = to_numpy(leaf)
            group.create_dataset(f"leaf_{i}", data=arr)
            spec.append({"kind": "array", "dtype": str(arr.dtype)})
        elif isinstance(leaf, (bool, int, float, complex, str)) or leaf is None:
            spec.append({"kind": "json", "value": leaf})
        else:
            group.create_dataset(
                f"leaf_{i}", data=np.void(pickle.dumps(leaf))
            )
            spec.append({"kind": "pickle"})
    group.attrs["treedef"] = str(treedef)
    group.attrs["leaf_spec"] = json.dumps(spec)
    group.attrs["n_leaves"] = len(leaves)


def load_pytree_from_hdf5(h5_file, path: str, like: Any) -> Any:
    """Load a pytree saved with :func:`save_pytree_to_hdf5`.

    ``like`` provides the treedef (structure must match what was saved).
    """
    group = h5_file[path]
    spec = json.loads(group.attrs["leaf_spec"])
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    if len(like_leaves) != len(spec):
        raise ValueError(
            f"Pytree structure mismatch: file has {len(spec)} leaves, "
            f"template has {len(like_leaves)}"
        )
    leaves = []
    for i, entry in enumerate(spec):
        if entry["kind"] == "array":
            arr = np.asarray(group[f"leaf_{i}"][()])
            like_leaf = like_leaves[i]
            if (
                hasattr(like_leaf, "shape")
                and tuple(like_leaf.shape) != tuple(arr.shape)
            ):
                raise ValueError(
                    f"Leaf {i} shape mismatch: file {arr.shape} vs "
                    f"template {like_leaf.shape}"
                )
            leaves.append(arr)
        elif entry["kind"] == "json":
            leaves.append(entry["value"])
        else:
            leaves.append(pickle.loads(bytes(group[f"leaf_{i}"][()])))
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Shard-wise array checkpointing
# ---------------------------------------------------------------------------
#
# Multi-host contract (reference layout semantics: docs/checkpointing.rst
# :18-27, lifted to SPMD): every process writes ONLY its locally
# addressable shards — no device_get of the global array, no cross-host
# gather — as hyperslab datasets tagged with their global offsets.
# Process 0 additionally owns the host-state blob. Loading goes through
# ``jax.make_array_from_callback`` so each device reads exactly the
# hyperslabs it needs, which also reshards transparently when the
# resuming mesh differs from the writing mesh.


def save_sharded_array(h5_file, path: str, arr) -> None:
    """Write the locally addressable shards of ``arr`` under ``path``.

    Works for plain numpy / single-device arrays too (stored as one
    shard spanning the full global shape). Replicated copies of the
    same global region (e.g. a fully replicated array on an 8-device
    mesh) are deduplicated: one dataset per distinct region.
    """
    if path in h5_file:
        del h5_file[path]
    group = h5_file.require_group(path)

    if isinstance(arr, jax.Array):
        global_shape = arr.shape
        dtype = np.dtype(arr.dtype)
        pieces = [
            (shard.index, shard.data) for shard in arr.addressable_shards
        ]
    else:
        arr = np.asarray(arr)
        global_shape = arr.shape
        dtype = arr.dtype
        pieces = [(tuple(slice(0, s) for s in arr.shape), arr)]

    group.attrs["global_shape"] = np.asarray(global_shape, dtype=np.int64)
    group.attrs["dtype"] = str(dtype)

    written = set()
    for index, block in pieces:
        starts = tuple(
            0 if sl.start is None else int(sl.start) for sl in index
        )
        if starts in written:
            continue  # replicated copy of a region already on disk
        written.add(starts)
        name = "shard_p{}_{}".format(
            jax.process_index(), "_".join(map(str, starts))
        )
        ds = group.create_dataset(name, data=np.asarray(block))
        ds.attrs["start"] = np.asarray(starts, dtype=np.int64)


def save_shard_blocks(
    h5_file, path: str, local, global_shape, starts, sizes
) -> None:
    """Write process-local row blocks of a globally sharded array.

    ``local`` holds this process's rows (concatenated, block-major);
    ``starts``/``sizes`` give each block's global row offset and length.
    The on-disk format is exactly :func:`save_sharded_array`'s (one
    hyperslab dataset per block, tagged with its global offset), so
    :func:`load_sharded_array` reassembles across the per-process files
    unchanged. Used by the shard-local sample-history checkpoints,
    where the snapshot data is already host numpy rather than a live
    ``jax.Array``.
    """
    local = np.asarray(local)
    group = h5_file.require_group(path)
    group.attrs["global_shape"] = np.asarray(global_shape, dtype=np.int64)
    group.attrs["dtype"] = str(local.dtype)
    row = 0
    for start, size in zip(starts, sizes):
        starts_nd = (int(start),) + (0,) * (local.ndim - 1)
        name = "shard_p{}_{}".format(
            jax.process_index(), "_".join(map(str, starts_nd))
        )
        if name in group:
            del group[name]
        ds = group.create_dataset(name, data=local[row : row + size])
        ds.attrs["start"] = np.asarray(starts_nd, dtype=np.int64)
        row += size


def load_sharded_array(h5_files, path: str, sharding=None):
    """Reassemble an array saved with :func:`save_sharded_array`.

    ``h5_files``: one open file or a sequence (one per writing
    process). With ``sharding=None`` the full array is assembled into
    host numpy. With a ``jax.sharding.Sharding``, the array is built
    via ``jax.make_array_from_callback`` and each device reads only
    the hyperslabs overlapping its own shard — the writing and reading
    meshes need not match.
    """
    if not isinstance(h5_files, (list, tuple)):
        h5_files = [h5_files]
    groups = [f[path] for f in h5_files if path in f]
    if not groups:
        raise KeyError(f"No shard group {path!r} in the given files")
    shape = tuple(int(s) for s in groups[0].attrs["global_shape"])
    dtype = np.dtype(groups[0].attrs["dtype"])
    blocks = [
        (tuple(int(s) for s in ds.attrs["start"]), ds)
        for g in groups
        for ds in g.values()
    ]

    def read_region(region: tuple[slice, ...]) -> np.ndarray:
        bounds = [sl.indices(dim) for sl, dim in zip(region, shape)]
        out_shape = tuple(stop - start for start, stop, _ in bounds)
        out = np.empty(out_shape, dtype)
        # Element-wise fill mask: replicated shards may overlap, so a
        # byte COUNT cannot prove coverage — a lost shard file must
        # fail loudly rather than hand back np.empty garbage.
        filled = np.zeros(out_shape, dtype=bool)
        for starts, ds in blocks:
            lo = [max(b[0], s) for b, s in zip(bounds, starts)]
            hi = [
                min(b[1], s + e)
                for b, s, e in zip(bounds, starts, ds.shape)
            ]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(
                slice(a - s, b - s) for a, b, s in zip(lo, hi, starts)
            )
            dst = tuple(
                slice(a - b0[0], b - b0[0])
                for a, b, b0 in zip(lo, hi, bounds)
            )
            out[dst] = ds[src]  # hyperslab read: only this region's bytes
            filled[dst] = True
        if not filled.all():
            missing = int(filled.size - filled.sum())
            raise ValueError(
                f"Shard files leave {missing}/{filled.size} elements "
                f"of region {region} in {path!r} unfilled (missing "
                "per-process shard files?)"
            )
        return out

    if sharding is None:
        return read_region(tuple(slice(0, s) for s in shape))
    return jax.make_array_from_callback(shape, sharding, read_region)


def checkpoint_barrier(tag: str = "aspire_tpu_checkpoint") -> None:
    """Block until every process finished writing its shard file.

    No-op in a single-process run; on a multi-host mesh this is the
    write barrier that makes the per-process shard files a consistent
    checkpoint.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)


def checkpoint_shard_files(file_path: str) -> list[str]:
    """All files of a sharded checkpoint: the main file + per-process
    sibling files written by non-zero processes."""
    import glob as _glob

    return [str(file_path)] + sorted(
        _glob.glob(str(file_path) + ".proc*")
    )


def process_checkpoint_path(file_path: str) -> str:
    """Where THIS process writes its checkpoint shards."""
    idx = jax.process_index()
    return str(file_path) if idx == 0 else f"{file_path}.proc{idx}"


def save_state_bytes(h5_file, payload: bytes, path: str = "checkpoint") -> None:
    """Write opaque state bytes at ``{path}/state`` (resizable dataset).

    Parity: reference ``dump_state`` (utils.py:733-770). Used only for
    small host-side orchestration state (history, iteration counters);
    array payloads go through :func:`save_pytree_to_hdf5`.
    """
    group = h5_file.require_group(path)
    if "state" in group:
        del group["state"]
    group.create_dataset(
        "state", data=np.frombuffer(payload, dtype=np.uint8), maxshape=(None,)
    )


def load_state_bytes(h5_file, path: str = "checkpoint") -> bytes:
    return bytes(np.asarray(h5_file[path]["state"][()]).tobytes())
