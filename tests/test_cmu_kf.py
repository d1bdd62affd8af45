"""18-state CMU-lineage KF (estimation/cmu_kf.py).

The reference keeps this filter compiled but dormant
(qr_robot_estimator.cpp:108-269, outputs commented out); here it is a
first-class optional estimator, so it gets real tests: static convergence,
moving-base tracking against kinematically consistent synthetic sensors,
covariance sanity, and batched vmap equivalence.
"""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.core import se3
from quadruped_jax.estimation import cmu_kf
from quadruped_jax.robots import a1_params, kinematics

DT = 0.002


def _stand_angles(params):
    """Joint angles putting feet at a nominal stand (via IK)."""
    targets = jnp.asarray(
        [[0.0, 0.0, -0.27]] * 4, jnp.float32) \
        + jnp.concatenate([params.hip_offset[:, :2],
                           jnp.zeros((4, 1))], axis=-1)
    return kinematics.joint_angles_from_foot_positions(params, targets)


def _static_sensors(params, quat):
    r = se3.quat_to_rotmat(quat)
    q = _stand_angles(params)
    return dict(
        acc_body=r.T @ jnp.asarray([0.0, 0.0, 9.81], jnp.float32),
        quat=quat, omega_body=jnp.zeros(3, jnp.float32),
        joint_angles=q, joint_velocities=jnp.zeros(12, jnp.float32),
        foot_force=jnp.full((4,), 100.0, jnp.float32))


def test_static_convergence():
    """Standing still: v -> 0, base height -> FK height, feet pinned at
    z = 0 (flat-ground observation)."""
    params = a1_params()
    config = cmu_kf.CmuKfConfig()
    quat = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    sensors = _static_sensors(params, quat)
    state = cmu_kf.cmu_kf_init(params, quat=quat,
                               joint_angles=sensors["joint_angles"],
                               base_height=0.31)  # deliberately wrong seed

    step = jax.jit(lambda s: cmu_kf.cmu_kf_update(config, params, s,
                                                  dt=DT, **sensors))
    for _ in range(800):
        state = step(state)

    v = cmu_kf.base_velocity_world(state)
    p = cmu_kf.base_position(state)
    feet = cmu_kf.foot_positions_world(state)
    assert float(jnp.max(jnp.abs(v))) < 0.01
    # FK height: feet sit ~0.27 below base and foot z observes 0.
    assert abs(float(p[2]) - 0.27) < 0.02
    assert float(jnp.max(jnp.abs(feet[:, 2]))) < 0.01
    # Foot state consistent with FK measurement p_f - p = R fk.
    fk = kinematics.foot_positions_in_base_frame(params,
                                                 sensors["joint_angles"])
    assert float(jnp.max(jnp.abs((feet - p) - fk))) < 0.01


def test_tracks_constant_velocity():
    """Base translating at constant vx with feet in stance: joint velocities
    from the Jacobian make kinematics consistent; the filter should lock on
    to the true velocity (the IMU reports zero specific acceleration)."""
    params = a1_params()
    config = cmu_kf.CmuKfConfig()
    quat = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    v_true = jnp.asarray([0.4, 0.0, 0.0], jnp.float32)

    q = _stand_angles(params)
    state = cmu_kf.cmu_kf_init(params, quat=quat, joint_angles=q)

    def sensors_at(q):
        # Stance feet fixed in world; base moves at v_true => foot velocity
        # in base frame is -v_true. dq = J^+ v_foot per leg.
        jac = kinematics.all_leg_jacobians(params, q)  # [4, 3, 3]
        dq = jnp.linalg.solve(jac, jnp.broadcast_to(-v_true, (4, 3))[..., None])
        return dict(
            acc_body=jnp.asarray([0.0, 0.0, 9.81], jnp.float32),
            quat=quat, omega_body=jnp.zeros(3, jnp.float32),
            joint_angles=q, joint_velocities=dq[..., 0].reshape(12),
            foot_force=jnp.full((4,), 100.0, jnp.float32))

    step = jax.jit(lambda s, sens: cmu_kf.cmu_kf_update(config, params, s,
                                                        dt=DT, **sens))
    sens = sensors_at(q)
    for _ in range(600):
        state = step(state, sens)
    v = cmu_kf.base_velocity_world(state)
    assert float(jnp.max(jnp.abs(v - v_true))) < 0.03, v


def test_swing_legs_do_not_corrupt():
    """A swing leg (zero foot force) moving arbitrarily must not disturb the
    velocity estimate — its measurements are gated out."""
    params = a1_params()
    config = cmu_kf.CmuKfConfig()
    quat = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    base = _static_sensors(params, quat)
    state = cmu_kf.cmu_kf_init(params, quat=quat,
                               joint_angles=base["joint_angles"])
    step = jax.jit(lambda s, sens: cmu_kf.cmu_kf_update(config, params, s,
                                                        dt=DT, **sens))
    for _ in range(400):
        state = step(state, base)
    v_ref = cmu_kf.base_velocity_world(state)

    # Now leg 0 swings: big joint velocities, zero force.
    swing = dict(base)
    swing["joint_velocities"] = base["joint_velocities"].at[0:3].set(5.0)
    swing["foot_force"] = base["foot_force"].at[0].set(0.0)
    for _ in range(200):
        state = step(state, swing)
    v = cmu_kf.base_velocity_world(state)
    assert float(jnp.max(jnp.abs(v - v_ref))) < 0.02


def test_covariance_symmetric_and_batched():
    params = a1_params()
    config = cmu_kf.CmuKfConfig()
    quat = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    sensors = _static_sensors(params, quat)
    state = cmu_kf.cmu_kf_init(params, quat=quat,
                               joint_angles=sensors["joint_angles"])
    s1 = cmu_kf.cmu_kf_update(config, params, state, dt=DT, **sensors)
    assert float(jnp.max(jnp.abs(s1.cov - s1.cov.T))) < 1e-6
    eig = jnp.linalg.eigvalsh(s1.cov)
    assert float(eig.min()) > -1e-5

    # vmap over a batch of IMU noise realizations == per-sample updates.
    rng = np.random.default_rng(0)
    accs = jnp.asarray(rng.normal(size=(5, 3)) * 0.1
                       + np.array([0, 0, 9.81]), jnp.float32)

    def upd(acc):
        sens = dict(sensors, acc_body=acc)
        return cmu_kf.cmu_kf_update(config, params, state, dt=DT,
                                    **sens).x

    batched = jax.vmap(upd)(accs)
    single = jnp.stack([upd(a) for a in accs])
    np.testing.assert_allclose(np.asarray(batched), np.asarray(single),
                               atol=1e-6)
