"""Multi-device scaling harness: sharded solves + efficiency report.

The engine's replacement for the reference's single-process execution model:
scenario batches shard over a (dp, sp) device mesh
(distributed/mesh.py), the batched MPC solve runs under jit with sharding
constraints (XLA inserts the collectives, NCCL over NVLink), and
solve statistics reduce across the mesh with `psum` under `shard_map` — the
"rollout gathers / QP-block reductions" axis of BASELINE.json.

`scaling_report(...)` measures solves/s at 1 device and at N devices and
reports the scaling efficiency the north star requires (>= 90%).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from quadruped_jax.distributed.mesh import make_mesh, batch_sharding, shard_batch


def sharded_solve_stats(mesh, solve_fn):
    """Wrap a batched solve so per-shard stats psum-reduce over the mesh.

    solve_fn: batch pytree -> forces [B_local, 4, 3].
    Returns fn: batch -> (forces [B, 4, 3], global mean |f| scalar).
    """
    spec = P(("dp", "sp"))

    @partial(shard_map, mesh=mesh, in_specs=(spec,),
             out_specs=(spec, P()))
    def inner(batch):
        forces = solve_fn(batch)
        local = jnp.sum(jnp.abs(forces))
        count = jnp.asarray(forces.size, jnp.float32)
        total = jax.lax.psum(local, ("dp", "sp"))
        n = jax.lax.psum(count, ("dp", "sp"))
        return forces, total / n

    return jax.jit(inner)


def measure_throughput(fn, args, reps: int = 10) -> float:
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def scaling_report(build_fn, batch_per_device: int, n_devices: int,
                   reps: int = 10) -> dict:
    """Measure solves/s at 1 device vs n_devices for a weak-scaling sweep.

    build_fn(batch_size, mesh) -> (jitted fn, args) producing one batched
    solve; the batch is sharded over the mesh.
    """
    results = {}
    for n in (1, n_devices):
        mesh = make_mesh(n)
        fn, args = build_fn(batch_per_device * n, mesh)
        dt = measure_throughput(fn, args, reps)
        results[n] = batch_per_device * n / dt
    eff = results[n_devices] / (results[1] * n_devices)
    return {
        "solves_per_s_1dev": results[1],
        f"solves_per_s_{n_devices}dev": results[n_devices],
        "scaling_efficiency": eff,
    }
