import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import fsm as fsm_mod, actions, safety
from quadruped_jax.control.types import HybridCommand, RobotObservation
from quadruped_jax.robots import a1_params


def make_obs(params, rpy=(0.0, 0.0, 0.0), height=0.28):
    from quadruped_jax.core import se3

    rpy = jnp.asarray(rpy, jnp.float32)
    return RobotObservation(
        base_position=jnp.asarray([0.0, 0.0, height], jnp.float32),
        base_rpy=rpy, base_quat=se3.rpy_to_quat(rpy),
        base_vel_world=jnp.zeros(3), base_omega_world=jnp.zeros(3),
        base_omega_body=jnp.zeros(3),
        joint_angles=params.sitdown_angles,
        joint_velocities=jnp.zeros(12),
        foot_contact=jnp.ones(4), foot_forces=jnp.full((4,), 30.0))


def loco_cmd():
    z = jnp.zeros(12, jnp.float32)
    return HybridCommand(q=z, kp=z, dq=z, kd=z, tau=z + 1.0)


def test_standup_then_locomotion():
    params = a1_params()
    obs = make_obs(params)
    state = fsm_mod.fsm_init(params.sitdown_angles)
    assert int(state.state) == fsm_mod.FsmState.STAND_UP

    # Mid-ramp: command blends toward standup angles.
    cmd, state, in_loco = fsm_mod.fsm_step(params, state, obs,
                                           jnp.asarray(1.5), loco_cmd())
    assert float(in_loco) == 0.0
    q = np.asarray(cmd.q)
    lo = np.minimum(np.asarray(params.sitdown_angles),
                    np.asarray(params.standup_angles)) - 1e-4
    hi = np.maximum(np.asarray(params.sitdown_angles),
                    np.asarray(params.standup_angles)) + 1e-4
    assert np.all((q >= lo) & (q <= hi))

    # After the ramp: transition to locomotion, uses locomotion command.
    cmd, state, in_loco = fsm_mod.fsm_step(params, state, obs,
                                           jnp.asarray(3.5), loco_cmd())
    assert int(state.state) == fsm_mod.FsmState.LOCOMOTION
    cmd, state, in_loco = fsm_mod.fsm_step(params, state, obs,
                                           jnp.asarray(3.6), loco_cmd())
    assert float(in_loco) == 1.0
    np.testing.assert_allclose(cmd.tau, 1.0)


def test_estop_on_bad_orientation():
    params = a1_params()
    state = fsm_mod.fsm_init(params.stand_angles).replace(
        state=jnp.asarray(fsm_mod.FsmState.LOCOMOTION, jnp.int32))
    obs = make_obs(params, rpy=(0.7, 0.0, 0.0))  # rolled over
    cmd, state, in_loco = fsm_mod.fsm_step(params, state, obs,
                                           jnp.asarray(5.0), loco_cmd())
    assert int(state.mode) == fsm_mod.FsmMode.ESTOP
    assert int(state.state) == fsm_mod.FsmState.PASSIVE
    # Pure damping command.
    np.testing.assert_allclose(cmd.tau, 0.0)
    np.testing.assert_allclose(cmd.kp, 0.0)
    assert np.all(np.asarray(cmd.kd) > 0)


def test_torque_clip():
    params = a1_params()
    obs = make_obs(params)
    big = HybridCommand(q=jnp.zeros(12), kp=jnp.zeros(12), dq=jnp.zeros(12),
                        kd=jnp.zeros(12), tau=jnp.full((12,), 100.0))
    clipped, safe = safety.safe_command(params, obs, big)
    assert float(safe) == 1.0
    np.testing.assert_allclose(clipped.tau, float(params.torque_limit))


def test_fsm_vmap_mixed_states():
    params = a1_params()
    states = jax.vmap(lambda s: fsm_mod.fsm_init(params.sitdown_angles).replace(
        state=s))(jnp.asarray([0, 1, 2, 3], jnp.int32))
    obs = jax.vmap(lambda _: make_obs(params))(jnp.arange(4))
    cmds = jax.vmap(lambda st, ob: fsm_mod.fsm_step(
        params, st, ob, jnp.asarray(0.5), loco_cmd()))(states, obs)
    assert cmds[0].q.shape == (4, 12)
