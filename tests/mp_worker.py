"""Worker process for tests/test_multiprocess.py (not a pytest module).

Run as: python mp_worker.py <out.npz>   with QTPU_* env set by the parent.

Each process owns HALF the scenario batch (rank-local rows), assembles the
global sharded array, runs the psum-reducing sharded solve over the global
(dp, sp) mesh, and writes its LOCAL output shard + the global stat. The
parent stitches both shards and compares against a single-process solve —
the "same batch sharded vs unsharded, multi-process" gate of SURVEY.md §4.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))   # repo root
sys.path.insert(0, HERE)                    # tests/

import numpy as np  # noqa: E402

from quadruped_jax.utils import compile_cache  # noqa: E402
from quadruped_jax.distributed import runtime  # noqa: E402
from quadruped_jax.distributed.scaling import sharded_solve_stats  # noqa: E402

compile_cache.enable()


def main():
    out_path = sys.argv[1]
    assert runtime.initialize_from_env(), "expected multi-process env"
    assert jax.device_count() == 8 and jax.local_device_count() == 4

    from test_distributed import make_batch, solve_batch

    b_global = 16
    pid = runtime.process_index()
    nproc = runtime.process_count()
    b_local = b_global // nproc

    params, operands = make_batch(b_global)      # deterministic, seed 0
    local = jax.tree.map(
        lambda x: np.asarray(x)[pid * b_local:(pid + 1) * b_local],
        operands)

    mesh = runtime.global_mesh(dp=4, sp=2)
    global_ops = runtime.host_local_to_global(mesh, local)
    fn = sharded_solve_stats(mesh, lambda ops: solve_batch(params, ops))
    forces, stat = fn(global_ops)
    forces_local = runtime.global_to_host_local(mesh, forces)

    np.savez(out_path, forces_local=np.asarray(forces_local),
             stat=float(stat), pid=pid)
    print(f"proc {pid}: wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
