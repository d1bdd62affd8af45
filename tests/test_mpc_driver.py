"""Unit tests for the MPC driver semantics (cadence, filters, yaw wrap)."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc as mpc_mod
from quadruped_jax.control.desired_state import (TwistCommand,
                                                 desired_state_init,
                                                 desired_state_update)
from quadruped_jax.gait import ADVANCED_TROT, gait_init, gait_update
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import srb_sim


def setup(horizon=5):
    params = a1_params()
    config = mpc_mod.MpcConfig(horizon=horizon, qp_iters=30,
                               iterations_per_mpc=30)
    sim = srb_sim.srb_sim_init(params)
    obs = srb_sim.observe(params, sim, jnp.ones(4))
    gait_config = ADVANCED_TROT()
    gait_state = gait_update(gait_config, gait_init(gait_config),
                             jnp.asarray(0.31), jnp.ones(4))
    des = desired_state_init(0.27)
    cmd = TwistCommand.constant(vx=0.3)
    for _ in range(400):  # converge the command low-pass
        des = desired_state_update(des, cmd)
    return params, config, gait_config, gait_state, obs, des


def test_solve_cadence():
    """In steady state (past any boot_solve_ticks), MPC solves on the reference's
    15 ms period (UpdateMPC :342: iterationsInaMPC/2 = 15 ticks of its
    1 kHz loop) — TIME-based here, so control_dt=2 ms solves every
    ticks_per_solve = 8 ticks instead of silently halving the rate."""
    params, config, gc, gs, obs, des = setup()
    tps = config.ticks_per_solve
    assert tps == max(1, round(0.015 / config.control_dt))
    state = mpc_mod.mpc_init(config, 0.27)
    state = state.replace(iteration=jnp.asarray(60, jnp.int32))
    solved = []
    step = jax.jit(lambda s: mpc_mod.mpc_step(config, params, gc, gs, s,
                                              obs, des))
    for _ in range(31):
        tau, forces, updated, state = step(state)
        solved.append(bool(updated))
    expected = [(60 + i) % tps == 0 for i in range(31)]
    assert solved == expected


def test_forces_held_between_solves():
    params, config, gc, gs, obs, des = setup()
    state = mpc_mod.mpc_init(config, 0.27).replace(
        iteration=jnp.asarray(60, jnp.int32))
    step = jax.jit(lambda s: mpc_mod.mpc_step(config, params, gc, gs, s,
                                              obs, des))
    prev_forces = None
    for i in range(16):
        tau, forces, updated, state = step(state)
        if prev_forces is not None and not bool(updated):
            np.testing.assert_allclose(np.asarray(forces), prev_forces)
        prev_forces = np.asarray(forces)


def test_velocity_filter_converges():
    params, config, gc, gs, obs, des = setup()
    state = mpc_mod.mpc_init(config, 0.27)
    for _ in range(600):
        state = mpc_mod.setup_command(config, state, obs, des)
    # x filter is 0.01/tick -> ~600 ticks to converge near 0.3.
    assert 0.25 < float(state.x_vel_des) <= 0.31


def test_yaw_wrap_unwraps_near_pi():
    params, config, gc, gs, obs, des = setup()
    # Robot facing just past +pi/2 with desired yaw slightly negative:
    # the unwrap pushes yaw_des above +pi instead of jumping sign.
    from quadruped_jax.core import se3

    rpy = jnp.asarray([0.0, 0.0, 2.9])
    obs2 = obs.replace(base_rpy=rpy, base_quat=se3.rpy_to_quat(rpy))
    state = mpc_mod.mpc_init(config, 0.27).replace(
        yaw_des=jnp.asarray(-3.1, jnp.float32))
    state = mpc_mod.setup_command(config, state, obs2, des)
    assert float(state.yaw_des) > 3.0  # wrapped up past +pi


def test_first_solve_balances_standing_weight():
    params, config, gc, gs, obs, des0 = setup()
    des = desired_state_update(desired_state_init(0.27),
                               TwistCommand.constant(vx=0.0))
    state = mpc_mod.mpc_init(config, 0.27)
    tau, forces, updated, state = mpc_mod.mpc_step(
        config, params, gc, gs, state, obs, des)
    assert bool(updated)
    total_fz = float(jnp.sum(forces[:, 2]))
    weight = float(params.total_mass) * 9.81
    # Within 25% of weight (swing-phase height compensation adds an upward
    # acceleration on top of gravity support).
    np.testing.assert_allclose(total_fz, weight, rtol=0.25)
    # Torques nonzero on stance legs, clipped within limits.
    assert float(jnp.max(jnp.abs(tau))) <= float(params.torque_limit) + 1e-5
    assert float(jnp.max(jnp.abs(tau))) > 0.5
