"""Two-PROCESS distributed runtime test (jax.distributed + gloo on CPU).

Launches two real OS processes (tests/mp_worker.py), each owning 4 virtual
CPU devices and HALF the scenario batch; they bootstrap through
`quadruped_jax.distributed.runtime.initialize_from_env`, assemble a global
8-device (dp=4, sp=2) mesh, and run the psum-reducing sharded MPC solve.
The stitched multi-process result must match the single-process solve of
the same batch — the cross-process analogue of
tests/test_distributed.py::test_sharded_matches_unsharded, exercising the
actual multi-host code path (coordination service, cross-process
collectives, host-local <-> global array plumbing) that a multi-host GPU
job uses over NCCL.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

HERE = Path(__file__).parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Hang guard: the manual communicate(timeout=240) below (pytest-timeout is
# not installed in this environment, so a mark would silently do nothing).
def test_two_process_sharded_solve(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"out{i}.npz" for i in range(2)]
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)   # worker sets its own device count
        env.update({
            "QTPU_COORDINATOR": f"127.0.0.1:{port}",
            "QTPU_NUM_PROCESSES": "2",
            "QTPU_PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "mp_worker.py"), str(outs[pid])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    # Stitch the per-process shards back into the global batch.
    d0, d1 = (np.load(o) for o in outs)
    forces = np.concatenate([d0["forces_local"], d1["forces_local"]])
    assert d0["pid"] == 0 and d1["pid"] == 1

    # Single-process reference on the same deterministic batch.
    sys.path.insert(0, str(HERE))
    from test_distributed import make_batch, solve_batch

    params, operands = make_batch(16)
    expected = jax.jit(lambda ops: solve_batch(params, ops))(operands)
    np.testing.assert_allclose(forces, np.asarray(expected), atol=2e-2)
    # The psum-reduced global stat agrees on both processes and with the
    # unsharded mean.
    assert abs(float(d0["stat"]) - float(d1["stat"])) < 1e-6
    np.testing.assert_allclose(float(d0["stat"]),
                               float(np.mean(np.abs(np.asarray(expected)))),
                               rtol=1e-4)
