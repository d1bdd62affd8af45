import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import se3
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.robots import a1_params, kinematics as kin
from quadruped_jax.control import wbc
from quadruped_jax.control.types import RobotObservation


@pytest.fixture(scope="module")
def setup():
    params = a1_params()
    model = fb.build_model(params)
    return params, model


def make_obs(params, q=None, height=0.28):
    q = params.stand_angles if q is None else q
    quat = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    return RobotObservation(
        base_position=jnp.asarray([0.0, 0.0, height], jnp.float32),
        base_rpy=jnp.zeros(3), base_quat=quat,
        base_vel_world=jnp.zeros(3), base_omega_world=jnp.zeros(3),
        base_omega_body=jnp.zeros(3),
        joint_angles=q, joint_velocities=jnp.zeros(12),
        foot_contact=jnp.ones(4), foot_forces=jnp.full((4,), 30.0))


def stand_command(params, obs, contact=None):
    foot_base = kin.foot_positions_in_base_frame(params, obs.joint_angles)
    p_world = foot_base + obs.base_position
    weight = float(params.total_mass) * 9.81
    if contact is None:
        contact = jnp.ones(4)
    fr = jnp.tile(jnp.asarray([0.0, 0.0, weight / 4]), (4, 1)) \
        * contact[:, None]
    return wbc.WbcCommand(
        p_body_des=obs.base_position, v_body_des=jnp.zeros(3),
        a_body_des=jnp.zeros(3), rpy_des=jnp.zeros(3),
        omega_des_world=jnp.zeros(3),
        p_foot_des=p_world, v_foot_des=jnp.zeros((4, 3)),
        a_foot_des=jnp.zeros((4, 3)), fr_des=fr, contact_state=contact)


def test_stand_equilibrium_torques(setup):
    """Standing at the target with MPC forces exactly balancing gravity:
    WBIC torque must match the static tau = (G - Jc^T F)[6:] map."""
    params, model = setup
    obs = make_obs(params)
    cmd = stand_command(params, obs)
    config = wbc.WbcConfig()
    q_des, dq_des, tau = wbc.wbc_step(config, params, model, obs, cmd)
    assert np.all(np.isfinite(np.asarray(tau)))

    state = fb.FbState(quat=obs.base_quat, position=obs.base_position,
                       omega_body=jnp.zeros(3), vel_body=jnp.zeros(3),
                       q=obs.joint_angles, dq=jnp.zeros(12))
    grav = fb.gravity_force(model, state)
    jc, _, _ = fb.contact_jacobians(model, state)
    # Expected static torque if qddot ~ 0 (WBC may command small qddot from
    # residual task errors; allow a modest tolerance).
    tau_static = (grav - jnp.einsum("lji,lj->i", jc, cmd.fr_des))[6:]
    np.testing.assert_allclose(tau, tau_static, atol=2.5)


def test_swing_leg_gets_no_reaction_force(setup):
    params, model = setup
    obs = make_obs(params)
    contact = jnp.asarray([1.0, 0.0, 0.0, 1.0])  # FL, RR swing
    cmd = stand_command(params, obs, contact)
    config = wbc.WbcConfig()
    state = fb.FbState(quat=obs.base_quat, position=obs.base_position,
                       omega_body=jnp.zeros(3), vel_body=jnp.zeros(3),
                       q=obs.joint_angles, dq=jnp.zeros(12))
    jts, jdqds, errs, vels, accs, jc, jcdqd, _ = wbc.build_tasks(
        config, model, state, cmd)
    tau, qddot, fr_total = wbc.wbic_torque(config, params, model, state,
                                           cmd, jts, jdqds, accs, jc, jcdqd)
    fr = np.asarray(fr_total).reshape(4, 3)
    np.testing.assert_allclose(fr[1], 0.0, atol=1e-2)
    np.testing.assert_allclose(fr[2], 0.0, atol=1e-2)
    # Stance forces stay in the mu=0.4 pyramid and under m g.
    for leg in (0, 3):
        fz = fr[leg, 2]
        assert -1e-2 <= fz <= float(params.total_mass) * 9.81 + 1.0
        assert abs(fr[leg, 0]) <= 0.4 * fz + 0.05
        assert abs(fr[leg, 1]) <= 0.4 * fz + 0.05


def test_kinematic_pass_tracks_height_error(setup):
    """Body 2 cm below target: the kinematic cascade must extend the legs
    (knee/hip move so feet drop relative to base)."""
    params, model = setup
    obs = make_obs(params, height=0.26)
    cmd = stand_command(params, obs)
    cmd = cmd.replace(p_body_des=jnp.asarray([0.0, 0.0, 0.28]),
                      p_foot_des=kin.foot_positions_in_base_frame(
                          params, obs.joint_angles) + obs.base_position)
    config = wbc.WbcConfig()
    q_des, dq_des, tau = wbc.wbc_step(config, params, model, obs, cmd)
    p0 = kin.foot_positions_in_base_frame(params, obs.joint_angles)
    p1 = kin.foot_positions_in_base_frame(params, q_des)
    # Feet must move down in the base frame (base rises).
    assert np.all(np.asarray(p1[:, 2]) < np.asarray(p0[:, 2]) + 1e-5)


def test_flight_phase_tracks_body_accel(setup):
    """No contacts: qddot from the cascade must realize the body task
    accelerations through the floating base rows."""
    params, model = setup
    obs = make_obs(params, height=0.5)
    contact = jnp.zeros(4)
    cmd = stand_command(params, obs, contact)
    cmd = cmd.replace(p_body_des=obs.base_position + jnp.asarray([0., 0., 0.1]))
    config = wbc.WbcConfig()
    state = fb.FbState(quat=obs.base_quat, position=obs.base_position,
                       omega_body=jnp.zeros(3), vel_body=jnp.zeros(3),
                       q=obs.joint_angles, dq=jnp.zeros(12))
    jts, jdqds, errs, vels, accs, jc, jcdqd, _ = wbc.build_tasks(
        config, model, state, cmd)
    # The desired body-z acceleration is kp_pos * 0.1 = 10 (clipped at 10).
    a_mat = fb.mass_matrix(model, state.q)
    a_inv = jnp.linalg.inv(a_mat)
    jc_masked = jc.reshape(12, wbc.NDOF) * 0.0
    jc_bar = wbc._weighted_pinv(jc_masked, a_inv)
    qddot = jc_bar @ jnp.zeros(12)
    n_pre = jnp.eye(wbc.NDOF) - jc_bar @ jc_masked
    for i in range(jts.shape[0]):
        jt_pre = jts[i] @ n_pre
        jt_bar = wbc._weighted_pinv(jt_pre, a_inv)
        qddot = qddot + jt_bar @ (accs[i] - jdqds[i] - jts[i] @ qddot)
        if i < jts.shape[0] - 1:
            n_pre = n_pre @ (jnp.eye(wbc.NDOF) - jt_bar @ jt_pre)
    # Body position task: J qddot == commanded acceleration.
    realized = jts[1] @ qddot
    np.testing.assert_allclose(realized, accs[1], atol=0.05)
