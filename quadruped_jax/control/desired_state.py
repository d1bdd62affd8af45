"""Desired-state command generation (the RC/teleop layer), batched.

Capability parity with `qrDesiredStateCommand`
(quadruped/src/controllers/qr_desired_state_command.cpp:66-265): command
modes (stand, trot, advanced trot, walk, body up/down), first-order low-pass
filtering of velocity commands, and the 12-D desired state
[pos(3), rpy(3), v(3), omega(3)] + desired acceleration build.

In the batched engine a "joystick" is an arbitrary per-scenario command
source: constant twists, command grids for sweeps, or recorded stick
traces — anything producing a `TwistCommand` per tick.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import struct
from quadruped_jax.core.filters import low_pass


class ControlMode:
    """Locomotion modes (reference qr_enum_types.h RC_MODE / LocomotionMode)."""

    VELOCITY = 0       # force-balance trot
    POSITION = 1       # position locomotion
    WALK = 2           # statically-stable walk
    ADVANCED_TROT = 3  # MPC + WBC


@struct.dataclass
class TwistCommand:
    """Raw per-tick command (pre-filter)."""

    linear: jnp.ndarray       # [3] body-frame vx, vy, vz
    angular_z: jnp.ndarray    # [] yaw rate
    body_height: jnp.ndarray  # [] desired CoM height
    # Gait-switch request channel (reference qrSwitchModeReceiver): a
    # rising edge asks the locomotion controller to run a gait transition
    # (control/gait_transition.py) when LocomotionConfig.gait_b is set.
    gait_switch: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((), jnp.float32))

    @classmethod
    def constant(cls, vx=0.0, vy=0.0, wz=0.0, body_height=0.27,
                 gait_switch=0.0):
        return cls(linear=jnp.asarray([vx, vy, 0.0], jnp.float32),
                   angular_z=jnp.asarray(wz, jnp.float32),
                   body_height=jnp.asarray(body_height, jnp.float32),
                   gait_switch=jnp.asarray(gait_switch, jnp.float32))


@struct.dataclass
class DesiredStateCommand:
    """Filtered desired state (the reference's `stateDes` 12-vector split
    into named fields), plus filter memory."""

    position: jnp.ndarray      # [3] world (z = body height)
    rpy: jnp.ndarray           # [3]
    velocity: jnp.ndarray      # [3] body frame
    omega: jnp.ndarray         # [3] body frame (z = yaw rate)
    filtered_linear: jnp.ndarray
    filtered_wz: jnp.ndarray


def desired_state_init(body_height=0.27) -> DesiredStateCommand:
    z3 = jnp.zeros(3, jnp.float32)
    return DesiredStateCommand(
        position=jnp.asarray([0.0, 0.0, body_height], jnp.float32),
        rpy=z3, velocity=z3, omega=z3,
        filtered_linear=z3, filtered_wz=jnp.zeros((), jnp.float32))


# Reference filter constant (qr_desired_state_command.cpp Update):
# stateDes blends with filterFactor 0.02 for twist commands.
FILTER_ALPHA = 0.98
VX_LIMIT = (-1.0, 2.0)
VY_LIMIT = (-0.6, 0.6)
WZ_LIMIT = (-1.2, 1.2)


def desired_state_update(state: DesiredStateCommand,
                         cmd: TwistCommand) -> DesiredStateCommand:
    """One command tick: low-pass + clip the raw twist into `stateDes`."""
    lin = low_pass(state.filtered_linear, cmd.linear, FILTER_ALPHA)
    wz = low_pass(state.filtered_wz, cmd.angular_z, FILTER_ALPHA)
    vx = jnp.clip(lin[0], *VX_LIMIT)
    vy = jnp.clip(lin[1], *VY_LIMIT)
    wz_c = jnp.clip(wz, *WZ_LIMIT)
    return state.replace(
        position=state.position.at[2].set(cmd.body_height),
        velocity=jnp.stack([vx, vy, jnp.zeros_like(vx)]),
        omega=jnp.stack([jnp.zeros_like(wz_c), jnp.zeros_like(wz_c), wz_c]),
        filtered_linear=lin,
        filtered_wz=wz,
    )
