"""Shared control-stack types: observations and hybrid motor commands.

The hybrid command mirrors the reference's 5-tuple motor law
{q, Kp, dq, Kd, tau} (quadruped/include/quadruped/robots/qr_motor.h:109
`qrMotorCommand::convertToMatix`): the actuator applies
tau_out = Kp (q - q_meas) + Kd (dq - dq_meas) + tau. The observation pytree
replaces the reference's `qrRobot` state cache + `qrStateDataFlow`
blackboard (quadruped/include/quadruped/controllers/qr_state_dataflow.h)
with an explicit immutable struct, batched over scenarios.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import se3
from quadruped_jax.core import struct


@struct.dataclass
class RobotObservation:
    """Per-tick sensor/estimator view of one robot (batchable)."""

    base_position: jnp.ndarray       # [3] world
    base_rpy: jnp.ndarray            # [3]
    base_quat: jnp.ndarray           # [4] (w, x, y, z)
    base_vel_world: jnp.ndarray      # [3]
    base_omega_world: jnp.ndarray    # [3]
    base_omega_body: jnp.ndarray     # [3]
    joint_angles: jnp.ndarray        # [12]
    joint_velocities: jnp.ndarray    # [12]
    foot_contact: jnp.ndarray        # [4] measured contact (0/1)
    foot_forces: jnp.ndarray         # [4] vertical contact force magnitude

    @property
    def rot_body_to_world(self) -> jnp.ndarray:
        return se3.quat_to_rotmat(self.base_quat)


@struct.dataclass
class HybridCommand:
    """12-joint hybrid motor command (the reference's 5x12 matrix)."""

    q: jnp.ndarray     # [12] desired joint position
    kp: jnp.ndarray    # [12]
    dq: jnp.ndarray    # [12] desired joint velocity
    kd: jnp.ndarray    # [12]
    tau: jnp.ndarray   # [12] feed-forward torque

    @classmethod
    def zeros(cls, batch=()):
        z = jnp.zeros(batch + (12,), jnp.float32)
        return cls(q=z, kp=z, dq=z, kd=z, tau=z)

    def actuator_torque(self, q_meas: jnp.ndarray, dq_meas: jnp.ndarray) -> jnp.ndarray:
        """Apply the hybrid motor law (reference
        simulation/unitree_legged_control/src/joint_controller.cpp:134)."""
        return (self.kp * (self.q - q_meas) + self.kd * (self.dq - dq_meas)
                + self.tau)
