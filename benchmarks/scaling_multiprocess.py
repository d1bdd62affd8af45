"""Multi-PROCESS weak-scaling measurement (the 1-host vs N-hosts axis).

Launches the same timed batched-MPC solve under 1 process and under N
processes (each with its own set of virtual CPU devices, bootstrapped
through quadruped_jax.distributed.runtime — gRPC coordination + gloo
collectives, the code path a multi-host GPU job uses with NCCL), batch
per device held constant, and records solves/s + efficiency into
SCALING.md/json.

    python benchmarks/scaling_multiprocess.py [--procs 2]
        [--devices-per-proc 2] [--batch-per-device 32]

On this CI machine the processes share 2 physical cores, so the
efficiency upper bound is cores/total-devices (recorded alongside, as in
scaling_report.py); on real hosts the bound is 1. The cross-process
CORRECTNESS gate lives in tests/test_multiprocess.py.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count="
                           + os.environ["QTPU_DEV_PER_PROC"])
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["QTPU_ROOT"])
from quadruped_jax.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from quadruped_jax.distributed import runtime
from quadruped_jax.control.mpc import MpcConfig
from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, cone_qp

runtime.initialize_from_env()
n_dev = jax.device_count()
bpd = int(os.environ["QTPU_BATCH_PER_DEV"])
batch = bpd * n_dev
cfg = MpcConfig()
params = a1_params()
weights = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                      jnp.float32)
H, DT = 10, 0.03

rng = np.random.default_rng(0)
rpy = (rng.normal(size=(batch, 3)) * 0.1).astype(np.float32)
feet = (rng.normal(size=(batch, 4, 3)) * 0.05
        + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                    [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
        ).astype(np.float32)
x0 = np.concatenate([rng.normal(size=(batch, 12)) * 0.05,
                     srb.GRAVITY * np.ones((batch, 1))], 1).astype(np.float32)
offs = rng.uniform(size=(batch, 1))
phase = (np.arange(H)[None, :] * DT / 0.6 + offs) % 1.0
diag_a = (phase < 0.6).astype(np.float32)
table = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a], axis=2)
table[:, 0, :] = 1.0
table = table.astype(np.float32)

mesh = runtime.global_mesh(dp=n_dev, sp=1)
pid = runtime.process_index()
nproc = runtime.process_count()
loc = batch // nproc
sl = slice(pid * loc, (pid + 1) * loc)
spec = P("dp")
g = lambda a: runtime.host_local_to_global(mesh, a[sl], spec)
inputs = (g(rpy), g(feet), g(x0), g(table))

def build_prob(rpy, feet, x0, contact):
    b = rpy.shape[0]
    r = se3.rpy_to_rotmat(rpy)
    k = jnp.arange(H, dtype=jnp.float32)[:, None]
    drift = jnp.zeros((13,), jnp.float32).at[3].set(0.4 * DT)
    x_des = (x0[:, None, :] + k[None] * drift[None, None, :])
    x_des = x_des.at[..., 9].set(0.4)
    a, bmat = srb.srb_continuous(r, params.total_inertia,
                                 params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, bmat, DT)
    p, q = condense.condense_cost_structured(
        a, bd, ad, x0, x_des, weights, 4e-6, H, DT)
    fz_hi = (contact * params.max_force).reshape(b, H * 4)
    return cone_qp.ConeQP(p=p, q=q, mu=jnp.asarray(0.45, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)

def cold_boot(rpy, feet, x0, contact):
    sol = cone_qp.solve(build_prob(rpy, feet, x0, contact),
                        iters=cfg.qp_cold_iters, alpha=cfg.qp_cold_alpha)
    return sol.x, sol.y

def full_solve(rpy, feet, x0, contact, x_warm, y_warm):
    # The production steady state: warm-started qp_iters Fast-ADMM —
    # the SAME configuration bench.py and scaling_report.py time.
    return cone_qp.solve(build_prob(rpy, feet, x0, contact),
                         iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                         accel_restart=cfg.qp_accel_restart,
                         x0=x_warm, y0=y_warm).x

warm = jax.jit(cold_boot)(*inputs)
jax.block_until_ready(warm)
inputs = inputs + tuple(warm)
fn = jax.jit(full_solve)
out = fn(*inputs)
jax.block_until_ready(out)
reps = int(os.environ.get("QTPU_REPS", "5"))
t0 = time.perf_counter()
for _ in range(reps):
    out = fn(*inputs)
jax.block_until_ready(out)
dt = (time.perf_counter() - t0) / reps
if pid == 0:
    print(json.dumps({"solves_per_s": batch / dt, "devices": n_dev,
                      "processes": nproc}), flush=True)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(n_procs, dev_per_proc, batch_per_dev, reps):
    port = free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({
            "QTPU_COORDINATOR": f"127.0.0.1:{port}",
            "QTPU_NUM_PROCESSES": str(n_procs),
            "QTPU_PROCESS_ID": str(pid),
            "QTPU_DEV_PER_PROC": str(dev_per_proc),
            "QTPU_BATCH_PER_DEV": str(batch_per_dev),
            "QTPU_REPS": str(reps),
            "QTPU_ROOT": str(ROOT),
        })
        if n_procs == 1:
            env.pop("QTPU_NUM_PROCESSES")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))
    outs = [p.communicate(timeout=900)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for o in outs:
        for line in o.splitlines():
            if line.startswith("{"):
                return json.loads(line)
    raise RuntimeError(f"no result line: {outs}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--batch-per-device", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    one = run_procs(1, args.devices_per_proc, args.batch_per_device,
                    args.reps)
    many = run_procs(args.procs, args.devices_per_proc,
                     args.batch_per_device, args.reps)
    eff = many["solves_per_s"] / (one["solves_per_s"] * args.procs)
    cores = os.cpu_count() or 1
    total_dev = args.procs * args.devices_per_proc
    bound = min(1.0, cores / total_dev)
    results = {
        "date": datetime.date.today().isoformat(),
        "platform": "cpu-multiprocess",
        "processes": args.procs,
        "devices_per_process": args.devices_per_proc,
        "batch_per_device": args.batch_per_device,
        "solves_per_s_1proc": round(one["solves_per_s"], 1),
        f"solves_per_s_{args.procs}proc": round(many["solves_per_s"], 1),
        "process_scaling_efficiency": round(eff, 4),
        "physical_cores": cores,
        "efficiency_upper_bound": round(bound, 4),
        "efficiency_vs_bound": round(eff / bound, 4) if bound else None,
    }
    out = ROOT / "SCALING.json"
    existing = json.loads(out.read_text()) if out.exists() else {}
    existing["cpu-multiprocess"] = results
    out.write_text(json.dumps(existing, indent=2) + "\n")
    md = ROOT / "SCALING.md"
    lines = [f"\n## {results['date']} — cpu multi-process "
             f"({args.procs} process(es) x {args.devices_per_proc} "
             f"device(s))\n"]
    for k, v in results.items():
        if k not in ("date", "platform"):
            lines.append(f"- {k}: {v}")
    with md.open("a") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
