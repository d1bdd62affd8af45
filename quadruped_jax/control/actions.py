"""Open-loop maneuvers: stand-up, sit-down, keep-stand, foot control.

Capability parity with the reference `Action` namespace
(quadruped/src/action/qr_action.cpp:31-100+): the blocking while-loops that
ramp joint angles over time become pure phase-parameterized command
generators — `standup_command(params, phase)` etc. — that the FSM (or a
rollout scan) evaluates per tick. The blend profile matches the reference:
linear interpolation from the captured start pose to the target pose with a
smooth ramp.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.control.types import HybridCommand
from quadruped_jax.robots.params import RobotParams

STANDUP_DURATION = 3.0   # s (reference ~4 s position ramp)
SITDOWN_DURATION = 3.0


def _blend_command(params: RobotParams, q_start: jnp.ndarray,
                   q_target: jnp.ndarray, phase) -> HybridCommand:
    s = jnp.clip(phase, 0.0, 1.0)
    # Smoothstep for velocity-continuous boundaries.
    s = s * s * (3.0 - 2.0 * s)
    q = q_start + (q_target - q_start) * s
    return HybridCommand(q=q, kp=params.motor_kp,
                         dq=jnp.zeros_like(q), kd=params.motor_kd,
                         tau=jnp.zeros_like(q))


def standup_command(params: RobotParams, q_start: jnp.ndarray,
                    t_since_start) -> HybridCommand:
    """Stand up: blend from the captured pose to the stand angles
    (Action::StandUp, qr_action.cpp:31)."""
    return _blend_command(params, q_start, params.standup_angles,
                          t_since_start / STANDUP_DURATION)


def sitdown_command(params: RobotParams, q_start: jnp.ndarray,
                    t_since_start) -> HybridCommand:
    """Sit down to the folded pose (Action::SitDown)."""
    return _blend_command(params, q_start, params.sitdown_angles,
                          t_since_start / SITDOWN_DURATION)


def keep_stand_command(params: RobotParams) -> HybridCommand:
    """Hold the nominal stand pose (Action::KeepStand)."""
    q = params.stand_angles
    return HybridCommand(q=q, kp=params.motor_kp, dq=jnp.zeros_like(q),
                         kd=params.motor_kd, tau=jnp.zeros_like(q))


def control_foot_command(params: RobotParams, foot_targets_base: jnp.ndarray,
                         ) -> HybridCommand:
    """Drive feet to base-frame targets by IK (Action::ControlFoot)."""
    from quadruped_jax.robots import kinematics

    q = kinematics.joint_angles_from_foot_positions(params, foot_targets_base)
    return HybridCommand(q=q, kp=params.motor_kp, dq=jnp.zeros_like(q),
                         kd=params.motor_kd, tau=jnp.zeros_like(q))
