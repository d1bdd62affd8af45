"""Base pose estimator: height from stance feet + planar odometry.

Capability parity with `qrRobotPoseEstimator`
(quadruped/src/estimators/qr_robot_pose_estimator.cpp:68-166): CoM height as
the mean of -z of the stance feet in world frame (with the control-frame
variant for slopes), and x/y/theta odometry by integrating the estimated
velocity in the yaw frame.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import se3
from quadruped_jax.core import struct


@struct.dataclass
class PoseEstimatorState:
    position: jnp.ndarray            # [3] world estimate
    yaw_odom: jnp.ndarray            # [] integrated heading
    height_in_control: jnp.ndarray   # [] height along ground normal


def pose_estimator_init(body_height: float = 0.27) -> PoseEstimatorState:
    return PoseEstimatorState(
        position=jnp.asarray([0.0, 0.0, body_height], jnp.float32),
        yaw_odom=jnp.zeros((), jnp.float32),
        height_in_control=jnp.asarray(body_height, jnp.float32))


def pose_estimator_update(state: PoseEstimatorState,
                          *,
                          quat: jnp.ndarray,
                          foot_positions_base: jnp.ndarray,  # [4, 3]
                          desired_stance: jnp.ndarray,       # [4] gait stance
                          v_base: jnp.ndarray,               # [3] est. velocity, base frame
                          yaw_rate: jnp.ndarray,
                          ground_rot: jnp.ndarray,           # [3, 3]
                          body_height,
                          dt) -> PoseEstimatorState:
    r = se3.quat_to_rotmat(quat)
    feet_world = jnp.einsum("ij,lj->li", r, foot_positions_base)
    n = jnp.sum(desired_stance)
    height = jnp.sum(-feet_world[:, 2] * desired_stance) / jnp.maximum(n, 1.0)
    height = jnp.where(n > 0.5, height, body_height)

    feet_control = jnp.einsum("ji,lj->li", ground_rot, feet_world)
    h_control = jnp.sum(-feet_control[:, 2] * desired_stance) \
        / jnp.maximum(n, 1.0)
    h_control = jnp.where(n > 0.5, h_control, body_height)

    # Planar odometry (ComputePose :137-166).
    theta = state.yaw_odom
    dx = (v_base[0] * jnp.cos(theta) - v_base[1] * jnp.sin(theta)) * dt
    dy = (v_base[0] * jnp.sin(theta) + v_base[1] * jnp.cos(theta)) * dt
    pos = jnp.stack([state.position[0] + dx, state.position[1] + dy, height])
    return PoseEstimatorState(position=pos,
                              yaw_odom=theta + yaw_rate * dt,
                              height_in_control=h_control)
