"""Secondary benchmark: end-to-end closed-loop control ticks/s/chip.

Measures the WHOLE framework in the loop — gait clocks, estimator-backed
observation, swing trajectories + IK, MPC at the reference's 15 ms
cadence (solve once per period, forces held between solves, exactly the
reference's multiplexing: qr_mpc_stance_leg_controller.cpp:342 — at the
500 Hz control_dt that is 8 ticks per solve, MpcConfig.ticks_per_solve),
hybrid command merge, and the SRB simulator step — batched over
independent scenarios. One "tick" = one 2 ms control step of one
scenario, so ticks/s/chip / 500 = simulated robot-seconds per wall
second.

    python benchmarks/bench_rollout.py   [QTPU_BENCH_BATCH=2048]
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
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim.rollout_cadenced import rollout_cadenced

N_PERIODS = 18


def build(batch: int):
    params = a1_params()
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT())
    rng = np.random.default_rng(0)
    vx = jnp.asarray(0.2 + 0.6 * rng.random(batch), jnp.float32)
    wz = jnp.asarray(rng.normal(size=batch) * 0.2, jnp.float32)

    def one(vx, wz):
        res = rollout_cadenced(config, params,
                               TwistCommand.constant(vx=vx, wz=wz),
                               n_periods=N_PERIODS)
        return res.alive, res.sim.position

    # Batch chunking (same schedule as bench.py CHUNK): lax.map over
    # vmapped chunks. 0 = monolithic vmap.
    chunk = int(os.environ.get("QTPU_BENCH_CHUNK", "256"))
    return bench.chunked(jax.vmap(one), batch, chunk), (vx, wz)


def main():
    batch = int(os.environ.get("QTPU_BENCH_BATCH", "2048"))
    fn, args = build(batch)
    out = fn(*args)
    jax.block_until_ready(out)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    ticks = batch * N_PERIODS * mpc_mod.MpcConfig().ticks_per_solve
    alive = float(jnp.mean(out[0]))
    print(json.dumps({
        "metric": f"closed-loop control ticks/s/chip (full stack, MPC "
                  f"H=10 @ 15 ms cadence, batch={batch}, "
                  f"{jax.devices()[0].platform})",
        "value": round(ticks / dt, 1),
        "unit": "ticks/s",
        "alive_fraction": alive,
        "robot_seconds_per_wall_second": round(ticks / dt / 500.0, 1),
    }))


if __name__ == "__main__":
    main()
