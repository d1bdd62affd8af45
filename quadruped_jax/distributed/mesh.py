"""Device mesh setup and scenario-batch sharding.

The reference's "distribution" is ROS pub/sub to Gazebo and vendor UDP to the
robot MCU (SURVEY.md §2.4) — a single control loop. This engine's
parallel axes are:

  * `dp`  — scenario data parallelism: rollouts (robots x gaits x commands x
    terrains) sharded across GPUs; the workhorse (throughput) axis.
  * `sp`  — solver parallelism: the QP's [12H] force-variable axis is
    partitioned across sp by `distributed.solver_sp.solve_cone_sp` — each
    member streams one column block of M^{-1} and the x-update reduces
    with one [B, n] psum per ADMM iteration. Correctness-proven but
    measured UNPROFITABLE in every regime tried so far (H=10 fleet
    config AND the H=16 move-blocked system, batches 8-64: 2-3x slower
    than sp=1 on the virtual mesh — see solver_sp.py STATUS). Default
    sp=1; keep it there unless a real multi-GPU measurement shows
    otherwise.

Collectives between the GPUs of one host are NCCL over NVLink (all to
all; jax.sharding inserts them); reductions of rollout/solve statistics
use `psum` under `shard_map` (see distributed/scaling.py); multi-process
bootstrap (jax.distributed — gRPC coordination, NCCL between GPUs, gloo
on CPU hosts) lives in distributed/runtime.py. This replaces the
reference's ROS/UDP process boundaries with XLA collectives as "the
communication backend".

For pure batch sharding, data placed with `shard_batch` spreads over BOTH
axes (P(("dp", "sp"))) so no device idles whatever the mesh shape.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None) -> Mesh:
    """Build a (dp, sp) mesh over the first n_devices devices.

    Defaults: all devices on the dp axis (sp=1) — correct for pure scenario
    batching; pass sp>1 to split the solver axis.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if dp is None:
        sp = sp or 1
        dp = n_devices // sp
    else:
        sp = sp or n_devices // dp
    assert dp * sp == n_devices, (dp, sp, n_devices)
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading scenario-batch axis over both mesh axes."""
    return NamedSharding(mesh, P(("dp", "sp")))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Device-put a pytree with its leading axis sharded over the mesh."""
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)
