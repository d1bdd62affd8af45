"""Base velocity estimator: 3-state Kalman filter + moving-window smoothing.

Capability parity with `qrRobotVelocityEstimator`
(quadruped/src/estimators/qr_robot_velocity_estimator.cpp:76-132): predict
the world-frame base velocity by integrating the calibrated IMU acceleration
(R a_imu - g), correct with the mean stance-leg kinematic velocity
observation  -R (v_foot_base + omega x p_foot_base), then smooth through a
moving-window filter. The reference's vendored C TinyEKF (extern/TinyEKF)
becomes ~15 lines of batched matrix arithmetic — identity state transition,
identity observation, scalar process/measurement variances.

When no foot is in contact the reference feeds the filter its own estimate
as the observation (flight phase); same here via a contact-count mask.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import linalg, se3
from quadruped_jax.core import struct
from quadruped_jax.core.filters import MovingWindowState, moving_window_init, moving_window_update
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams


@struct.dataclass
class VelocityEstimatorConfig:
    accel_variance: float = struct.field(pytree_node=False, default=0.1)
    sensor_variance: float = struct.field(pytree_node=False, default=0.1)
    initial_variance: float = struct.field(pytree_node=False, default=0.1)
    window_size: int = struct.field(pytree_node=False, default=120)
    acc_filter_window: int = struct.field(pytree_node=False, default=20)


@struct.dataclass
class VelocityEstimatorState:
    v_world: jnp.ndarray            # [3] filter state
    cov: jnp.ndarray                # [3, 3]
    acc_filter: MovingWindowState   # IMU acceleration smoothing
    vel_filter: MovingWindowState   # output smoothing
    smoothed_v_world: jnp.ndarray   # [3]


def velocity_estimator_init(config: VelocityEstimatorConfig) -> VelocityEstimatorState:
    return VelocityEstimatorState(
        v_world=jnp.zeros(3, jnp.float32),
        cov=jnp.eye(3, dtype=jnp.float32) * config.initial_variance,
        acc_filter=moving_window_init(config.acc_filter_window, (3,)),
        vel_filter=moving_window_init(config.window_size, (3,)),
        smoothed_v_world=jnp.zeros(3, jnp.float32),
    )


def velocity_estimator_update(
    config: VelocityEstimatorConfig,
    params: RobotParams,
    state: VelocityEstimatorState,
    *,
    acc_body: jnp.ndarray,        # [3] IMU linear acceleration, body frame
    quat: jnp.ndarray,            # [4] base orientation
    omega_body: jnp.ndarray,      # [3] gyro, body frame
    joint_angles: jnp.ndarray,    # [12]
    joint_velocities: jnp.ndarray,  # [12]
    foot_contact: jnp.ndarray,    # [4]
    dt,
) -> VelocityEstimatorState:
    r = se3.quat_to_rotmat(quat)

    acc_filter, acc_sm = moving_window_update(state.acc_filter, acc_body)
    acc_world = r @ acc_sm + jnp.asarray([0.0, 0.0, -9.81], acc_sm.dtype)

    # Predict.
    v_pred = state.v_world + acc_world * dt
    cov_pred = state.cov + jnp.eye(3, dtype=state.cov.dtype) \
        * config.accel_variance

    # Observe: -R (v_foot + omega x p_foot) averaged over contact feet.
    p_feet = kinematics.foot_positions_in_base_frame(params, joint_angles)
    v_feet = kinematics.foot_velocities_in_base_frame(params, joint_angles,
                                                      joint_velocities)
    v_obs_per_leg = -jnp.einsum(
        "ij,lj->li", r,
        v_feet + jnp.cross(jnp.broadcast_to(omega_body, (4, 3)), p_feet))
    n_contact = jnp.sum(foot_contact)
    mean_obs = jnp.sum(v_obs_per_leg * foot_contact[:, None], axis=0) \
        / jnp.maximum(n_contact, 1.0)
    z = jnp.where(n_contact > 0.5, mean_obs, v_pred)

    # Kalman update (H = I).
    s = cov_pred + jnp.eye(3, dtype=cov_pred.dtype) * config.sensor_variance
    # Closed-form SPD inverse — the innovation is 3x3 SPD; XLA's batched
    # LU (jnp.linalg.inv) is slow inside tick scans (see sim/srb_sim.py).
    k = cov_pred @ linalg.inv_spd(s)
    v_new = v_pred + k @ (z - v_pred)
    cov_new = (jnp.eye(3, dtype=k.dtype) - k) @ cov_pred
    cov_new = 0.5 * (cov_new + cov_new.T)

    vel_filter, v_smoothed = moving_window_update(state.vel_filter, v_new)
    return VelocityEstimatorState(
        v_world=v_new, cov=cov_new, acc_filter=acc_filter,
        vel_filter=vel_filter, smoothed_v_world=v_smoothed)
