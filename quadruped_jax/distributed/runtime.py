"""Multi-process runtime: jax.distributed bootstrap + host-local/global
array plumbing.

The reference's process boundaries are ROS pub/sub (controller <-> Gazebo)
and vendor UDP (controller <-> robot MCU) — see SURVEY.md §2.4. The
batched equivalent is the JAX multi-process runtime: one Python process
per host (or per GPU), bootstrapped through a gRPC coordination service
(`jax.distributed.initialize`), with XLA collectives carrying the data —
NCCL over NVLink between the GPUs of a host, NCCL over the network
across hosts, gloo on CPU hosts (the test fabric;
tests/test_multiprocess.py runs the same code 2-process on one
machine).

Environment-driven bootstrap (the launcher contract, mirroring
JAX_COORDINATOR_ADDRESS & co. so the same worker runs under any process
manager):

  QTPU_COORDINATOR   host:port of process 0 (default 127.0.0.1:12321)
  QTPU_NUM_PROCESSES total process count   (default 1 -> no-op)
  QTPU_PROCESS_ID    this process's rank   (default 0)

With QTPU_NUM_PROCESSES unset (or 1) `initialize_from_env()` does
nothing: one process drives all of its host's GPUs. Nothing detects a
cluster by itself, so several processes need all three variables (the
coordinator at `localhost:<port>` on one host).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils


def initialize_from_env() -> bool:
    """Bootstrap jax.distributed from QTPU_* env vars.

    Returns True if a multi-process runtime was initialized, False for
    single-process (the no-op default, so every entry point can call this
    unconditionally)."""
    n = int(os.environ.get("QTPU_NUM_PROCESSES", "1"))
    if n <= 1:
        return False
    coord = os.environ.get("QTPU_COORDINATOR", "127.0.0.1:12321")
    pid = int(os.environ.get("QTPU_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=n, process_id=pid)
    return True


def global_mesh(dp: int | None = None, sp: int = 1) -> Mesh:
    """A (dp, sp) mesh over ALL processes' devices (jax.devices() is
    global after initialize)."""
    devices = jax.devices()
    if dp is None:
        dp = len(devices) // sp
    assert dp * sp == len(devices), (dp, sp, len(devices))
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))


def host_local_to_global(mesh: Mesh, tree, spec: P = P(("dp", "sp"))):
    """Assemble per-process local batches into one global sharded array.

    Each process passes ITS shard (e.g. the scenarios it owns); the result
    is a global jax.Array addressable from jit on every process — the
    multi-process analogue of mesh.shard_batch."""
    return multihost_utils.host_local_array_to_global_array(tree, mesh, spec)


def global_to_host_local(mesh: Mesh, tree, spec: P = P(("dp", "sp"))):
    """Back out this process's shard of a global array (for host-side IO,
    e.g. feeding a hardware bridge from the local host)."""
    return multihost_utils.global_array_to_host_local_array(tree, mesh, spec)


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()
