"""Closed-loop checks for the non-MPC locomotion modes (force-balance
stance paths: VELOCITY and POSITION)."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
from quadruped_jax.control.desired_state import ControlMode, TwistCommand
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.gait import TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim.rollout import rollout


def run_mode(mode, vx=0.25, steps=400):
    params = a1_params()
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
        swing=swing_mod.SwingConfig(mode=mode),
        gait=TROT(),
        mode=mode)
    cmd = TwistCommand.constant(vx=vx, body_height=0.27)
    return jax.jit(lambda: rollout(config, params, cmd, steps=steps))()


def test_velocity_mode_trot_stable():
    res = run_mode(ControlMode.VELOCITY)
    assert float(res.alive) == 1.0
    h = np.asarray(res.base_height_trace)
    assert np.all(np.isfinite(h))
    assert 0.2 < h[-1] < 0.35
    # Moves forward under the velocity command.
    vx = np.asarray(res.vel_trace)[:, 0]
    assert vx[-50:].mean() > 0.05


def test_position_mode_runs():
    res = run_mode(ControlMode.POSITION, vx=0.1, steps=300)
    assert float(res.alive) == 1.0
    assert np.all(np.isfinite(np.asarray(res.base_height_trace)))


def test_blocked_leg_probes_downward():
    """A leg in touchdown wait joins the swing set with a probe-down target
    2 cm below the current foot (swing.py blocked branch; reference
    ComputeHeuristicFootHold !allowSwitchLegState)."""
    from quadruped_jax.control.desired_state import desired_state_init
    from quadruped_jax.control.types import RobotObservation
    from quadruped_jax.core import se3
    from quadruped_jax import gait as gait_mod
    from quadruped_jax.robots import kinematics

    params = a1_params()
    config = swing_mod.SwingConfig()
    gait_config = gait_mod.ADVANCED_TROT()
    gait_state = gait_mod.gait_init(gait_config)
    # Leg 0 blocked mid-wait; others in stance.
    gait_state = gait_state.replace(
        allow_switch=jnp.asarray([0.0, 1.0, 1.0, 1.0]),
        leg_state=jnp.asarray([gait_mod.LegState.STANCE] * 4, jnp.int32),
        normalized_phase=jnp.full((4,), 0.99, jnp.float32))

    rpy = jnp.zeros(3, jnp.float32)
    obs = RobotObservation(
        base_position=jnp.asarray([0.0, 0.0, 0.27], jnp.float32),
        base_rpy=rpy, base_quat=se3.rpy_to_quat(rpy),
        base_vel_world=jnp.zeros(3), base_omega_world=jnp.zeros(3),
        base_omega_body=jnp.zeros(3),
        joint_angles=params.standup_angles,
        joint_velocities=jnp.zeros(12),
        foot_contact=jnp.asarray([0.0, 1.0, 1.0, 1.0]),
        foot_forces=jnp.asarray([0.0, 30.0, 30.0, 30.0]))
    des = desired_state_init()
    state = swing_mod.swing_init(params, obs)
    # Seed targets at the current feet so held targets are well-defined.
    feet = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    state = state.replace(foot_target_base=feet,
                          liftoff_pos_base=feet,
                          liftoff_pos_world=feet)

    q_des, dq_des, mask, new_state = swing_mod.swing_step(
        config, params, gait_config, gait_state, state, obs, des)
    # Blocked leg is commanded (mask on), others are not.
    assert float(mask[0]) == 1.0 and float(mask[3:].max()) == 0.0
    # Its target sits ~2 cm below the current foot.
    dz = float(new_state.foot_target_base[0, 2] - feet[0, 2])
    assert -0.03 < dz < -0.015, dz
    # IK target reachable: commanded joint angles map back near the target.
    p_cmd = kinematics.foot_positions_in_base_frame(params, q_des)
    assert float(jnp.abs(p_cmd[0] - new_state.foot_target_base[0]).max()) < 5e-3


def test_wbc_trot_through_rollout():
    """use_wbc=True must actually engage the WBC inside rollout() (it
    builds the whole-body model and passes it to locomotion_step — the
    reference builds the dynamic model in the locomotion FSM ctor) and the
    closed loop must stay up and track."""
    from quadruped_jax.control import wbc as wbc_mod
    from quadruped_jax.gait import ADVANCED_TROT

    params = a1_params()
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=40),
        swing=swing_mod.SwingConfig(),
        gait=ADVANCED_TROT(),
        wbc=wbc_mod.WbcConfig(),
        use_wbc=True)
    cmd = TwistCommand.constant(vx=0.25,
                                body_height=float(params.body_height))
    res = jax.jit(lambda: rollout(config, params, cmd, steps=400))()
    assert float(res.alive) == 1.0
    h = np.asarray(res.base_height_trace)
    assert np.all(np.isfinite(h)) and 0.2 < h[-1] < 0.35
    vx = np.asarray(res.vel_trace)[:, 0]
    assert vx[-100:].mean() > 0.1
