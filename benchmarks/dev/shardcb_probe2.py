"""Bisect the shard_map+io_callback hang: outside loop, unordered, etc."""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

case = sys.argv[1] if len(sys.argv) > 1 else "outside"
mesh = Mesh(np.asarray(jax.devices()), ("data",))
received = []


def host_cb(idx, x_local):
    received.append((int(idx), np.asarray(x_local).copy()))


ordered = case != "unordered"


@partial(
    shard_map,
    mesh=mesh,
    in_specs=(P("data"),),
    out_specs=P("data"),
    check_rep=False,
)
def post_shards(x):
    idx = jax.lax.axis_index("data")
    io_callback(host_cb, None, idx, x, ordered=ordered)
    return x


x = jax.device_put(
    jnp.arange(16.0).reshape(16, 1), NamedSharding(mesh, P("data"))
)

if case in ("outside", "unordered"):

    @jax.jit
    def run(x):
        return post_shards(x + 1.0)

    out = run(x)
    jax.block_until_ready(out)
else:  # inside while_loop, unordered

    @jax.jit
    def run(x):
        def body(state):
            x, it = state
            x = post_shards(x + 1.0)
            return (x, it + 1)

        return jax.lax.while_loop(lambda s: s[1] < 3, body, (x, jnp.int32(0)))

    out, it = run(x)
    jax.block_until_ready(out)

print(f"case={case} callbacks={len(received)} idxs={sorted(i for i, _ in received)}")
