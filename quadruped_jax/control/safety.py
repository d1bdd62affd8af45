"""Safety checks: orientation guard + torque clipping, batched.

Capability parity with `qrSafetyChecker`
(quadruped/src/fsm/qr_safety_checker.cpp:28-69): |roll|, |pitch| < 0.5 rad
check and per-joint torque clip to +/-23 N*m (parameterized per robot), plus
the batched analogue of the example mains' tip-over guard
(examples/example_a1_sim/example_a1_sim.cpp:232-241) — a divergence mask
instead of a process exit.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.control.types import HybridCommand, RobotObservation
from quadruped_jax.robots.params import RobotParams

MAX_ROLL_PITCH = 0.5     # rad (qr_safety_checker.cpp:41)
HEIGHT_RANGE = (0.08, 0.45)


def check_safe_orientation(obs: RobotObservation) -> jnp.ndarray:
    """[...] 1.0 where |roll| and |pitch| are within limits."""
    rpy = obs.base_rpy
    ok = (jnp.abs(rpy[..., 0]) < MAX_ROLL_PITCH) \
        & (jnp.abs(rpy[..., 1]) < MAX_ROLL_PITCH)
    return ok.astype(jnp.float32)


def check_tip_over(obs: RobotObservation) -> jnp.ndarray:
    """[...] 1.0 where the base is inside the height envelope and finite."""
    z = obs.base_position[..., 2]
    ok = (z > HEIGHT_RANGE[0]) & (z < HEIGHT_RANGE[1]) & jnp.isfinite(z)
    return ok.astype(jnp.float32)


def clip_command(params: RobotParams, command: HybridCommand) -> HybridCommand:
    """Torque clip (CheckSafeTorque :55-60); position/velocity left as-is
    (the actuator model applies its own physical limits)."""
    return command.replace(
        tau=jnp.clip(command.tau, -params.torque_limit, params.torque_limit))


def safe_command(params: RobotParams, obs: RobotObservation,
                 command: HybridCommand) -> tuple[HybridCommand, jnp.ndarray]:
    """Clip torques and zero everything on unsafe orientation (the FSM's
    ESTOP behaviour: pure damping). Returns (command', safe_mask)."""
    safe = check_safe_orientation(obs) * check_tip_over(obs)
    cmd = clip_command(params, command)
    damped = HybridCommand(
        q=jnp.zeros_like(cmd.q), kp=jnp.zeros_like(cmd.kp),
        dq=jnp.zeros_like(cmd.dq),
        kd=jnp.full_like(cmd.kd, 2.0),
        tau=jnp.zeros_like(cmd.tau))
    pick = lambda a, b: jnp.where(safe[..., None] > 0.5, a, b)
    return HybridCommand(q=pick(cmd.q, damped.q), kp=pick(cmd.kp, damped.kp),
                         dq=pick(cmd.dq, damped.dq),
                         kd=pick(cmd.kd, damped.kd),
                         tau=pick(cmd.tau, damped.tau)), safe
