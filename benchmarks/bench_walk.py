"""Walk-mode throughput: statically-stable walk closed-loop ticks/s/chip.

VERDICT r4 item 6: every recorded engine was trot (MPC bench, SRB
rollout, whole-body, WBC); walk — the reference's 1 kHz
position/velocity mode with the force-balance QP + pose-planner SQP
(qr_torque_stance_leg_controller.cpp:480-545) — had no performance
story. This measures the batched walk stack closed-loop on the 18-DoF
whole-body sim (the stair/gap-crossing configuration, flat ground),
with the round-5 production force-balance budget: qp_iters=40 COLD —
measured BIT-IDENTICAL to the cold-300 test-convenience budget on the
flat-walk closed loop (benchmarks/exp_walk_budget.py: the active-set
polish, not the ADMM stage, pins the exact minimizer; the warm-start
mechanism is shipped but unnecessary — warm runs differ by ~0.3 N mean
from the exact solution while cold-40 is exact).

    python benchmarks/bench_walk.py   [QTPU_BENCH_BATCH=256]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.walk_locomotion import (WalkConfig, walk_init,
                                                   walk_step)
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait.scheduler import _config
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import whole_body as wb

DT = 0.002
STEPS = 500   # 1 s of sim per timed call


def build(batch: int, qp_iters: int, warm: bool, use_sqp: bool = True):
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    config = WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=qp_iters, warm_start=warm),
        use_sqp_pose_planner=use_sqp)
    rng = np.random.default_rng(0)
    vx = jnp.asarray(0.02 + 0.05 * rng.random(batch), jnp.float32)

    def init_one(vxi):
        sim = wb.whole_body_init(params)
        obs = wb.observe(params, model, sim, cm)
        st = walk_init(config, params, obs)
        cmd = TwistCommand.constant(body_height=0.27).replace(
            linear=jnp.stack([vxi, jnp.zeros_like(vxi),
                              jnp.zeros_like(vxi)]))
        return sim, st, cmd

    sim0, st0, cmd = jax.vmap(init_one)(vx)

    def one(sim, st, cmd):
        def step(carry, i):
            s, w = carry
            obs = wb.observe(params, model, s, cm)
            command, forces, w = walk_step(
                config, params, w, obs, cmd,
                (i + 1).astype(jnp.float32) * DT)
            s, _ = wb.whole_body_step(params, model, s, command, cm, DT)
            return (s, w), None

        (s, w), _ = jax.lax.scan(step, (sim, st), jnp.arange(STEPS))
        return s.fb.position

    chunk = int(os.environ.get("QTPU_BENCH_CHUNK", "64"))
    if chunk > 0 and batch % chunk == 0 and batch > chunk:
        n_chunks = batch // chunk

        def fn(sim, st, cmd):
            rs = lambda a: a.reshape((n_chunks, chunk) + a.shape[1:])
            return jax.lax.map(
                lambda ch: jax.vmap(one)(*ch),
                jax.tree.map(rs, (sim, st, cmd)))
        return jax.jit(fn), (sim0, st0, cmd)
    return jax.jit(jax.vmap(one)), (sim0, st0, cmd)


def main():
    batch = int(os.environ.get("QTPU_BENCH_BATCH", "256"))
    qp_iters = int(os.environ.get("QTPU_BENCH_WALK_ITERS", "40"))
    warm = os.environ.get("QTPU_BENCH_WALK_WARM", "0") == "1"
    use_sqp = os.environ.get("QTPU_BENCH_WALK_SQP", "1") == "1"
    fn, args = build(batch, qp_iters, warm, use_sqp)
    out = fn(*args)
    jax.block_until_ready(out)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    pos = np.asarray(out).reshape(batch, 3)
    alive = float((pos[:, 2] > 0.15).mean())
    ticks = batch * STEPS
    print(json.dumps({
        "metric": f"walk-mode closed-loop ticks/s/chip (whole-body sim + "
                  f"force-balance QP iters={qp_iters} warm={int(warm)} + "
                  f"{'SQP' if use_sqp else 'centroid'} pose planner, "
                  f"batch={batch}, {jax.devices()[0].platform})",
        "value": round(ticks / dt, 1),
        "unit": "ticks/s",
        "alive_fraction": alive,
        "robot_seconds_per_wall_second": round(ticks / dt / 500.0, 1),
    }))


if __name__ == "__main__":
    main()
