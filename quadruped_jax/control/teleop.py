"""Teleop / command sources: host-side drivers producing TwistCommand ticks.

Capability parity with the reference's ROS command layer —
`qrTeleKeyboard` (raw termios keyboard -> Joy, quadruped/src/ros/
qr_telekeyboard.cpp), `qrCmdVelReceiver` and `qrSwitchModeReceiver` — with
array-native equivalents: a keyboard poller for interactive host sessions
and precomputed command *traces* (arrays of TwistCommand over time) that
batched rollouts consume; a trace per scenario is the batched analogue of a
joystick stream.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp

from quadruped_jax.control.desired_state import TwistCommand

VX_STEP = 0.1
WZ_STEP = 0.2
KEYMAP = {
    "w": (VX_STEP, 0.0, 0.0), "s": (-VX_STEP, 0.0, 0.0),
    "a": (0.0, VX_STEP, 0.0), "d": (0.0, -VX_STEP, 0.0),
    "q": (0.0, 0.0, WZ_STEP), "e": (0.0, 0.0, -WZ_STEP),
}


def apply_key(cmd: TwistCommand, key: str) -> TwistCommand:
    """Keyboard teleop increments (qr_telekeyboard key bindings)."""
    if key == " ":
        return TwistCommand.constant(body_height=float(cmd.body_height))
    dvx, dvy, dwz = KEYMAP.get(key, (0.0, 0.0, 0.0))
    lin = cmd.linear + jnp.asarray([dvx, dvy, 0.0], jnp.float32)
    return cmd.replace(linear=lin, angular_z=cmd.angular_z + dwz)


def keyboard_teleop_loop(callback, body_height: float = 0.27):
    """Blocking host loop: read single keys from stdin, emit commands.
    Requires a TTY; intended for hardware-in-the-loop sessions with the
    native bridge."""
    import termios
    import tty

    cmd = TwistCommand.constant(body_height=body_height)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            key = sys.stdin.read(1)
            if key in ("\x03", "x"):  # ctrl-c / x quits
                break
            cmd = apply_key(cmd, key)
            callback(cmd)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def step_trace(steps: int, vx_schedule, body_height: float = 0.27):
    """Precomputed command trace: [(tick, vx), ...] -> stacked TwistCommand
    with leading time axis (for scan-based rollouts with time-varying
    commands — the cmd_vel stream analogue)."""
    vx = jnp.zeros((steps,), jnp.float32)
    for tick, value in vx_schedule:
        vx = vx.at[tick:].set(value)
    zeros = jnp.zeros_like(vx)
    return TwistCommand(
        linear=jnp.stack([vx, zeros, zeros], axis=-1),
        angular_z=zeros,
        body_height=jnp.full((steps,), body_height, jnp.float32),
        gait_switch=zeros)


# --- RC/gamepad emulation on the keyboard -----------------------------------
# Key -> JoyInput button mapping (the reference pairs qrTeleKeyboard with
# the joy-message RC machine; here the same keys drive control/rc_mode):
#   j = A (toggle joy), k = X (locomotion / cycle gait), l = B (stop),
#   u = Y (exit), i = Rb (body up/down); wasdqe move the sticks.
RC_BUTTON_KEYS = {"j": "btn_joy", "k": "btn_gait", "l": "btn_stop",
                  "u": "btn_exit", "i": "btn_updown"}


def joy_from_key(key: str, sticks):
    """(JoyInput, new sticks) from one keypress; `sticks` is the held
    (vx, vy, wz) tuple (incremented by wasdqe, zeroed by space)."""
    from quadruped_jax.control.rc_mode import JoyInput

    vx, vy, wz = sticks
    if key == " ":
        vx = vy = wz = 0.0
    else:
        dvx, dvy, dwz = KEYMAP.get(key, (0.0, 0.0, 0.0))
        vx, vy, wz = vx + dvx, vy + dvy, wz + dwz
    buttons = {}
    name = RC_BUTTON_KEYS.get(key)
    if name:
        buttons[name] = 1.0
    return JoyInput.neutral(vx=vx, vy=vy, wz=wz, **buttons), (vx, vy, wz)
