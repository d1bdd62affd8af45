"""Closed-loop stair climbing on the 18-DoF whole-body sim.

The capability the reference's qrFootStepper exists for
(quadruped/src/planner/qr_foot_stepper.cpp:339,:483 — terrain-constrained
foothold optimization): the statically-stable walk stack climbs one 8 cm
step using planner/foot_stepper.stair_foothold_adjust as the walk path's
foothold hook (hold short of the riser, climb when the leg pair
coordination allows) with terrain.stairs as the ground truth. Measured
trajectory: front feet climb by ~12 s, all four feet on the step by
~22 s, base rises the full step height, |pitch| < 0.08 throughout
(benchmarks/exp_stairs.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.walk_locomotion import (WalkConfig, walk_init,
                                                   walk_step)
from quadruped_jax.core import se3
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait.scheduler import _config
from quadruped_jax.gait.walk import SubLegState
from quadruped_jax.planner import foot_stepper
from quadruped_jax.robots import a1_params, kinematics
from quadruped_jax.sim import terrain, whole_body as wb

DT = 0.002
STEP_HEIGHT = 0.08
RISER_X = 0.25


def test_walk_climbs_one_step():
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    # terrain.stairs raises the ground at start_x + k*step_length (k>=1):
    # shifting the origin one 5 m tread back makes a SINGLE 8 cm step up
    # at RISER_X.
    terr = terrain.stairs(step_length=5.0, step_height=STEP_HEIGHT,
                          start_x=RISER_X - 5.0)
    stair = foot_stepper.StairParams(
        start_x=jnp.asarray(RISER_X), width=jnp.asarray(5.0),
        height=jnp.asarray(STEP_HEIGHT), count=jnp.asarray(1))

    def adjust(target, feet):
        x_adj, _ = foot_stepper.stair_foothold_adjust(
            feet[:, 0], stair, default_delta=0.1)
        return target.at[:, 0].set(x_adj)

    config = WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=40))
    cmd = TwistCommand.constant(vx=0.03, body_height=0.27)

    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm, terrain_height=terr)
    st0 = walk_init(config, params, obs0)
    steps = int(24.0 / DT)

    def step(carry, i):
        sim, st = carry
        obs = wb.observe(params, model, sim, cm, terrain_height=terr)
        command, forces, st = walk_step(
            config, params, st, obs, cmd,
            (i + 1).astype(jnp.float32) * DT,
            terrain_height=terr, foothold_adjust_fn=adjust)
        sim, _ = wb.whole_body_step(params, model, sim, command, cm, DT,
                                    terrain_height=terr)
        r = se3.quat_to_rotmat(obs.base_quat)
        feet_w = jnp.einsum("ij,lj->li", r,
                            kinematics.foot_positions_in_base_frame(
                                params, obs.joint_angles)) \
            + obs.base_position
        return (sim, st), (sim.fb.position[0], sim.fb.position[2],
                           obs.base_rpy[1], feet_w[:, 2])

    _, (xs, hs, pitch, fz) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    xs, hs, pitch, fz = (np.asarray(v) for v in (xs, hs, pitch, fz))

    assert np.isfinite(hs).all()
    assert hs.min() > 0.2, hs.min()
    assert np.abs(pitch).max() < 0.2, np.abs(pitch).max()
    # All four feet end ON the step (z within 2 cm of the tread) and the
    # base has risen most of the step height.
    assert (fz[-1] > STEP_HEIGHT - 0.02).all(), fz[-1]
    assert hs[-1] > 0.27 + STEP_HEIGHT / 2, hs[-1]
    assert xs[-1] > RISER_X, xs[-1]
