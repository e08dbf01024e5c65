"""Probe: io_callback per-shard via shard_map inside lax.while_loop.

Validates the mechanism for shard-local in-ladder checkpoints: each
device's callback receives its LOCAL shard plus its shard index, from
inside a compiled while_loop, on an 8-virtual-device mesh.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

mesh = Mesh(np.asarray(jax.devices()), ("data",))
received = []


def host_cb(shard_idx, it, x_local):
    received.append((int(shard_idx), int(it), np.asarray(x_local).copy()))


@partial(
    shard_map,
    mesh=mesh,
    in_specs=(P("data"), P()),
    out_specs=P("data"),
    check_rep=False,
)
def post_shards(x, it):
    idx = jax.lax.axis_index("data")
    io_callback(host_cb, None, idx, it, x, ordered=True)
    return x


@jax.jit
def run(x):
    def body(state):
        x, it = state
        x = x + 1.0
        x = post_shards(x, it)
        return (x, it + 1)

    def cond(state):
        return state[1] < 3

    return jax.lax.while_loop(cond, body, (x, jnp.int32(0)))


x = jax.device_put(
    jnp.arange(16.0).reshape(16, 1),
    NamedSharding(mesh, P("data")),
)
out, it = run(x)
jax.block_until_ready(out)
print("iterations:", int(it), "callbacks:", len(received))
by_it = {}
for idx, it_, shard in received:
    by_it.setdefault(it_, {})[idx] = shard
for it_, shards in sorted(by_it.items()):
    assert len(shards) == 8, (it_, sorted(shards))
    full = np.concatenate([shards[i] for i in range(8)])
    expect = np.arange(16.0).reshape(16, 1) + it_ + 1
    np.testing.assert_allclose(full, expect)
print("OK: per-shard callbacks reassemble the global array each iteration")
