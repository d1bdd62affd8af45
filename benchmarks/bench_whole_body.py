"""Whole-body fidelity-mode throughput: 18-DoF closed-loop ticks/s/chip.

The SRB rollout (bench_rollout.py) is the speed-of-light scenario-sweep
engine; this measures the FULL-fidelity path — batched 18-DoF
Featherstone forward dynamics + Hunt-Crossley contact + hybrid motor law
+ the same advanced-trot MPC controller — the batched replacement for one
Gazebo instance per robot (simulation/qr_gazebo; Gazebo targets
real-time factor ~1.0 for ONE robot at real_time_update_rate 1000).
ticks/s / 500 = simulated robot-seconds per wall second = "how many
Gazebos" one chip replaces at the reference's own real-time target.

    python benchmarks/bench_whole_body.py   [QTPU_BENCH_BATCH=1024]
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

import bench
from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import whole_body as wb

DT = 0.002
STEPS = 500   # 1 s of sim per timed call


def build(batch: int):
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT())
    rng = np.random.default_rng(0)
    vx = jnp.asarray(0.2 + 0.4 * rng.random(batch), jnp.float32)

    def init_one(vxi):
        sim = wb.whole_body_init(params)
        obs = wb.observe(params, model, sim, cm)
        ctrl = locomotion_init(config, params, obs)
        cmd = TwistCommand.constant(body_height=0.27).replace(
            linear=jnp.stack([vxi, jnp.zeros_like(vxi),
                              jnp.zeros_like(vxi)]))
        return sim, ctrl, cmd

    sim0, ctrl0, cmd = jax.vmap(init_one)(vx)

    def one(sim, ctrl, cmd):
        def step(carry, i):
            s, c = carry
            obs = wb.observe(params, model, s, cm)
            command, forces, c = locomotion_step(
                config, params, c, obs, cmd,
                (i + 1).astype(jnp.float32) * DT)
            s, _ = wb.whole_body_step(params, model, s, command, cm, DT)
            return (s, c), None

        (s, c), _ = jax.lax.scan(step, (sim, ctrl), jnp.arange(STEPS))
        return s.fb.position

    # Chunked vmap (same schedule as bench.py CHUNK).
    chunk = int(os.environ.get("QTPU_BENCH_CHUNK", "256"))
    return bench.chunked(jax.vmap(one), batch, chunk), (sim0, ctrl0, cmd)


def main():
    batch = int(os.environ.get("QTPU_BENCH_BATCH", "1024"))
    fn, args = build(batch)
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
        "metric": f"whole-body 18-DoF closed-loop ticks/s/chip (full "
                  f"Featherstone + contact + MPC trot, batch={batch}, "
                  f"{jax.devices()[0].platform})",
        "value": round(ticks / dt, 1),
        "unit": "ticks/s",
        "alive_fraction": alive,
        "robot_seconds_per_wall_second": round(ticks / dt / 500.0, 1),
        "gazebo_equivalents": round(ticks / dt / 500.0, 1),
    }))


if __name__ == "__main__":
    main()
