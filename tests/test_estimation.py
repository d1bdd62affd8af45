import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.core import se3
from quadruped_jax.robots import a1_params, kinematics as kin
from quadruped_jax.estimation import velocity as vel_mod, ground as ground_mod
from quadruped_jax.estimation.contact import (contact_detection_init,
                                              contact_detection_update,
                                              phase_prior)
from quadruped_jax.estimation.container import (EstimatorConfig,
                                                RawSensors,
                                                estimator_init,
                                                estimator_update)
from quadruped_jax.estimation.velocity import VelocityEstimatorConfig


def test_velocity_estimator_converges_to_true_velocity():
    """Robot translating at constant velocity with stance feet: the EKF must
    converge to the true base velocity from the kinematic observations."""
    params = a1_params()
    config = VelocityEstimatorConfig(window_size=20, acc_filter_window=5)
    state = vel_mod.velocity_estimator_init(config)
    v_true = jnp.asarray([0.4, -0.1, 0.0])
    q = params.stand_angles
    # Stance feet: foot velocity in base = -v_true (base frame = world here).
    jac = kin.all_leg_jacobians(params, q)
    v_feet_base = jnp.tile(-v_true, (4, 1))
    dq = jnp.linalg.solve(jac, v_feet_base[..., None])[..., 0].reshape(12)

    for _ in range(100):
        state = vel_mod.velocity_estimator_update(
            config, params, state,
            acc_body=jnp.asarray([0.0, 0.0, 9.81]),  # gravity-compensated
            quat=jnp.asarray([1.0, 0, 0, 0]),
            omega_body=jnp.zeros(3),
            joint_angles=q, joint_velocities=dq,
            foot_contact=jnp.ones(4), dt=0.002)
    np.testing.assert_allclose(state.v_world, v_true, atol=0.02)


def test_ground_plane_fit_flat_and_slope():
    feet_flat = jnp.asarray([[0.17, -0.13, -0.3], [0.17, 0.13, -0.3],
                             [-0.17, -0.13, -0.3], [-0.17, 0.13, -0.3]])
    coefs = ground_mod.fit_plane(feet_flat)
    np.testing.assert_allclose(coefs, [-0.3, 0.0, 0.0], atol=1e-5)

    slope = 0.2  # z = -0.3 + 0.2 x
    feet_slope = feet_flat.at[:, 2].set(-0.3 + slope * feet_flat[:, 0])
    coefs = ground_mod.fit_plane(feet_slope)
    np.testing.assert_allclose(coefs, [-0.3, slope, 0.0], atol=1e-5)


def test_ground_estimator_updates_on_touchdown_only():
    state = ground_mod.ground_estimator_init()
    quat = jnp.asarray([1.0, 0, 0, 0])
    feet = jnp.asarray([[0.17, -0.13, -0.3], [0.17, 0.13, -0.3],
                        [-0.17, -0.13, -0.3], [-0.17, 0.13, -0.3]])
    # No touchdown event (already in contact at init state last_contact=0 ->
    # first full-contact tick IS an event).
    s1 = ground_mod.ground_estimator_update(state, feet, jnp.ones(4), quat)
    np.testing.assert_allclose(s1.plane_coefs, [-0.3, 0, 0], atol=1e-5)
    # Same contact persists -> no refit even if feet move.
    feet2 = feet.at[:, 2].set(-0.5)
    s2 = ground_mod.ground_estimator_update(s1, feet2, jnp.ones(4), quat)
    np.testing.assert_allclose(s2.plane_coefs, s1.plane_coefs, atol=1e-6)


def test_contact_phase_prior_windows():
    phi = jnp.asarray([0.5, 0.02, 0.5, 0.98])
    stance = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    prior = phase_prior(phi, stance)
    assert prior[0] > 0.99          # mid-stance
    assert 0.3 < prior[1] < 0.7     # stance edge
    assert prior[2] < 0.01          # mid-swing
    assert 0.3 < prior[3] < 0.7     # swing end


def test_contact_detector_tracks_forces():
    state = contact_detection_init()
    # Leg 1 swings: low force, nonzero vz, phase mid-swing.
    for _ in range(30):
        state = contact_detection_update(
            state,
            normalized_phase=jnp.full((4,), 0.5),
            in_stance=jnp.asarray([1.0, 0.0, 1.0, 1.0]),
            foot_height_above_ground=jnp.asarray([0.0, 0.08, 0.0, 0.0]),
            foot_velocities_base=jnp.zeros((4, 3)).at[1, 2].set(0.3),
            foot_forces=jnp.asarray([40.0, 0.0, 40.0, 40.0]),
            base_v_control=jnp.zeros(3))
    assert np.asarray(state.is_contact)[0] == 1.0
    assert np.asarray(state.is_contact)[1] == 0.0
    assert np.asarray(state.p_contact)[1] < 0.3


def test_full_estimator_pipeline_runs_and_is_finite():
    params = a1_params()
    config = EstimatorConfig(velocity=VelocityEstimatorConfig(
        window_size=20, acc_filter_window=5))
    state = estimator_init(config)
    sensors = RawSensors(
        quat=se3.rpy_to_quat(jnp.asarray([0.01, -0.02, 0.1])),
        acc_body=jnp.asarray([0.1, 0.0, 9.8]),
        omega_body=jnp.asarray([0.0, 0.0, 0.1]),
        joint_angles=params.stand_angles,
        joint_velocities=jnp.zeros(12),
        foot_forces=jnp.full((4,), 35.0))

    step = jax.jit(lambda s: estimator_update(
        config, params, s, sensors,
        normalized_phase=jnp.full((4,), 0.4),
        desired_stance=jnp.ones(4), dt=0.002))
    for _ in range(5):
        state, obs = step(state)
    flat = jax.tree.leaves((state, obs))
    assert all(bool(jnp.all(jnp.isfinite(x))) for x in flat)
    # Height estimate close to stand height.
    assert 0.2 < float(obs.base_position[2]) < 0.35


def test_external_knee_torque_zero_in_free_swing():
    # A calf following its own free dynamics (tau_knee exactly the inertia +
    # gravity terms) shows zero external torque; extra measured torque shows
    # up sign-flipped (qr_anomaly_detection.cpp:299-316).
    from quadruped_jax.estimation.contact import external_knee_torque

    params = a1_params()
    ddq = jnp.zeros(12).at[2::3].set(3.0)
    m, l = params.links_mass[2], params.lower_length
    iyy = params.links_inertia[2, 1, 1] + m * l * l
    tau_free = jnp.zeros(12).at[2::3].set(iyy * 3.0 + m * 9.8 * l)
    ext = external_knee_torque(params, tau_free, ddq)
    np.testing.assert_allclose(ext, np.zeros(4), atol=1e-5)
    ext2 = external_knee_torque(params, tau_free + 5.0, ddq)
    np.testing.assert_allclose(ext2, -5.0 * np.ones(4), atol=1e-4)


def test_workspace_clip_box():
    from quadruped_jax.estimation.contact import workspace_clip

    params = a1_params()
    allowed = jnp.asarray([0.2, 0.2, 0.35], jnp.float32)
    offset = np.asarray(
        params.default_hip_position.at[..., 2].set(-params.body_height))
    inside = jnp.asarray(offset + np.array([0.05, 0.0, 0.1]), jnp.float32)
    clipped, outside = workspace_clip(params, inside, allowed)
    np.testing.assert_allclose(clipped, inside, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(outside), np.zeros(4))
    # A foot 2x outside in x comes back to the box face, scaled radially.
    out_p = jnp.asarray(offset + np.array([0.4, 0.1, 0.1]), jnp.float32)
    clipped, outside = workspace_clip(params, out_p, allowed)
    rel = np.asarray(clipped) - offset
    np.testing.assert_allclose(rel[:, 0], 0.2, atol=1e-6)
    np.testing.assert_allclose(rel[:, 1], 0.05, atol=1e-6)  # scaled by 1/2
    np.testing.assert_array_equal(np.asarray(outside), np.ones(4))
    assert np.all(np.abs(rel) <= np.asarray(allowed) + 1e-6)
