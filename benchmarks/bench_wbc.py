"""Secondary benchmark: whole-body control (WBC) ticks/s/chip.

The reference's hot loop #2 (SURVEY.md §3 ranking) is the WBC stack:
Featherstone model update (mass matrix, gravity/Coriolis, contact
Jacobians), the kinematic multitask projection, and the WBIC QP
(qr_wbc_locomotion_controller.cpp Run). One "tick" here is that full
pipeline for one robot at 4 contacts — the per-2-ticks work of the
reference's 500 Hz loop.

    python benchmarks/bench_wbc.py  [QTPU_BENCH_BATCH=1024]
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

from quadruped_jax.robots import a1_params
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.control import wbc
from quadruped_jax.control.types import RobotObservation


def build(batch: int):
    params = a1_params()
    model = fb.build_model(params)
    rng = np.random.default_rng(0)
    q = jnp.asarray(
        np.tile([0.0, 0.8, -1.6], (batch, 4)).reshape(batch, 12)
        + rng.normal(size=(batch, 12)) * 0.05, jnp.float32)
    obs = RobotObservation(
        base_position=jnp.zeros((batch, 3)).at[:, 2].set(0.27),
        base_rpy=jnp.zeros((batch, 3)),
        base_quat=jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (batch, 1)),
        base_vel_world=jnp.zeros((batch, 3)),
        base_omega_world=jnp.zeros((batch, 3)),
        base_omega_body=jnp.zeros((batch, 3)),
        joint_angles=q,
        joint_velocities=jnp.asarray(rng.normal(size=(batch, 12)) * 0.2,
                                     jnp.float32),
        foot_contact=jnp.ones((batch, 4)),
        foot_forces=jnp.full((batch, 4), 30.0))
    feet = np.tile([[0.17, -0.13, 0.0], [0.17, 0.13, 0.0],
                    [-0.17, -0.13, 0.0], [-0.17, 0.13, 0.0]], (batch, 1, 1))
    cmd = wbc.WbcCommand(
        p_body_des=jnp.zeros((batch, 3)).at[:, 2].set(0.28),
        v_body_des=jnp.zeros((batch, 3)).at[:, 0].set(0.3),
        a_body_des=jnp.zeros((batch, 3)),
        rpy_des=jnp.zeros((batch, 3)),
        omega_des_world=jnp.zeros((batch, 3)),
        p_foot_des=jnp.asarray(feet, jnp.float32),
        v_foot_des=jnp.zeros((batch, 4, 3)),
        a_foot_des=jnp.zeros((batch, 4, 3)),
        fr_des=jnp.zeros((batch, 4, 3)).at[:, :, 2].set(32.0),
        contact_state=jnp.ones((batch, 4)))
    config = wbc.WbcConfig()
    step = jax.jit(jax.vmap(
        lambda o, c: wbc.wbc_step(config, params, model, o, c)))
    return step, (obs, cmd)


def main():
    batch = int(os.environ.get("QTPU_BENCH_BATCH", "1024"))
    step, args = build(batch)
    out = step(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        out = step(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(json.dumps({
        "metric": f"WBC ticks/s/chip (full model update + projection + "
                  f"WBIC, batch={batch}, "
                  f"{jax.devices()[0].platform})",
        "value": round(batch / dt, 1),
        "unit": "ticks/s",
    }))


if __name__ == "__main__":
    main()
