"""Estimator container: owns and sequences all estimators per tick.

Capability parity with `qrStateEstimatorContainer`
(quadruped/src/estimators/qr_state_estimator_container.cpp:30-51): ground
surface -> contact detection -> velocity -> pose, each feeding the next,
producing the full `RobotObservation` the controllers consume. In pure-sim
benchmarking the simulator can bypass this (perfect state); closed-loop
fidelity mode runs it against simulated noisy sensors to preserve the
reference's estimation-in-the-loop structure.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import se3
from quadruped_jax.core import struct
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.control.types import RobotObservation
from quadruped_jax.estimation.velocity import (VelocityEstimatorConfig,
                                               VelocityEstimatorState,
                                               velocity_estimator_init,
                                               velocity_estimator_update)
from quadruped_jax.estimation.pose import (PoseEstimatorState,
                                           pose_estimator_init,
                                           pose_estimator_update)
from quadruped_jax.estimation.ground import (GroundEstimatorState,
                                             ground_estimator_init,
                                             ground_estimator_update,
                                             height_in_plane)
from quadruped_jax.estimation.contact import (ContactDetectionState,
                                              contact_detection_init,
                                              contact_detection_update)


@struct.dataclass
class EstimatorConfig:
    velocity: VelocityEstimatorConfig


@struct.dataclass
class EstimatorState:
    velocity: VelocityEstimatorState
    pose: PoseEstimatorState
    ground: GroundEstimatorState
    contact: ContactDetectionState


@struct.dataclass
class RawSensors:
    """What a real robot actually measures (qrRobot::ReceiveObservation)."""

    quat: jnp.ndarray             # [4] IMU orientation
    acc_body: jnp.ndarray         # [3] IMU linear acceleration
    omega_body: jnp.ndarray       # [3] gyro
    joint_angles: jnp.ndarray     # [12]
    joint_velocities: jnp.ndarray  # [12]
    foot_forces: jnp.ndarray      # [4] foot force sensors


def estimator_init(config: EstimatorConfig,
                   body_height: float = 0.27) -> EstimatorState:
    return EstimatorState(
        velocity=velocity_estimator_init(config.velocity),
        pose=pose_estimator_init(body_height),
        ground=ground_estimator_init(),
        contact=contact_detection_init(),
    )


def estimator_update(config: EstimatorConfig, params: RobotParams,
                     state: EstimatorState, sensors: RawSensors,
                     *,
                     normalized_phase: jnp.ndarray,  # [4] from gait
                     desired_stance: jnp.ndarray,    # [4]
                     dt) -> tuple[EstimatorState, RobotObservation]:
    """One estimation tick -> (state', RobotObservation)."""
    r = se3.quat_to_rotmat(sensors.quat)
    p_feet = kinematics.foot_positions_in_base_frame(params,
                                                     sensors.joint_angles)
    v_feet = kinematics.foot_velocities_in_base_frame(
        params, sensors.joint_angles, sensors.joint_velocities)

    # Contact detection first (feeds everything downstream).
    dz = p_feet[:, 2] - height_in_plane(state.ground.plane_coefs,
                                        p_feet[:, :2])
    v_base_prev = state.velocity.smoothed_v_world @ r  # rough control frame
    contact_state = contact_detection_update(
        state.contact,
        normalized_phase=normalized_phase,
        in_stance=desired_stance,
        foot_height_above_ground=dz,
        foot_velocities_base=v_feet,
        foot_forces=sensors.foot_forces,
        base_v_control=v_base_prev)
    contact = contact_state.is_contact

    ground_state = ground_estimator_update(state.ground, p_feet, contact,
                                           sensors.quat)

    vel_state = velocity_estimator_update(
        config.velocity, params, state.velocity,
        acc_body=sensors.acc_body, quat=sensors.quat,
        omega_body=sensors.omega_body,
        joint_angles=sensors.joint_angles,
        joint_velocities=sensors.joint_velocities,
        foot_contact=contact, dt=dt)

    v_base = vel_state.smoothed_v_world @ r
    pose_state = pose_estimator_update(
        state.pose, quat=sensors.quat, foot_positions_base=p_feet,
        desired_stance=desired_stance, v_base=v_base,
        yaw_rate=sensors.omega_body[2], ground_rot=ground_state.ground_rot,
        body_height=params.body_height, dt=dt)

    obs = RobotObservation(
        base_position=pose_state.position,
        base_rpy=se3.quat_to_rpy(sensors.quat),
        base_quat=sensors.quat,
        base_vel_world=vel_state.smoothed_v_world,
        base_omega_world=r @ sensors.omega_body,
        base_omega_body=sensors.omega_body,
        joint_angles=sensors.joint_angles,
        joint_velocities=sensors.joint_velocities,
        foot_contact=contact,
        foot_forces=sensors.foot_forces)
    new_state = EstimatorState(velocity=vel_state, pose=pose_state,
                               ground=ground_state, contact=contact_state)
    return new_state, obs
