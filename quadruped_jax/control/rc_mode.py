"""Joy/RC mode machine: gamepad buttons -> control-mode state -> commands.

Capability parity with `qrDesiredStateCommand::{JoyCallback, Update}`
(quadruped/src/controllers/qr_desired_state_command.cpp:66-265) and the
FSM-mode mapping in `qrControlFSM::RunFSM`
(quadruped/src/fsm/qr_control_fsm.cpp:72-94):

  * A toggles joy control, X requests locomotion / cycles the gait, B
    stops to MPC-stand (or re-arms after body-down), Rb toggles
    BODY_UP/BODY_DOWN while stopped, Y exits to passive when down;
  * the mode cycle in locomotion: STAND -> ADVANCED_TROT -> TROT ->
    ADVANCED_TROT -> ... (HARD_CODE skipped), matching Update :176-192;
  * stand modes zero the commanded twist; trot/walk modes pass the
    sticks through (the low-pass lives in desired_state_update, as the
    reference's filterFactor does);
  * backward-walk height compensation: body height * 0.85 when
    vx < -0.01 (Update :263-265);
  * each mode maps to an FSM request: trot modes -> LOCOMOTION (+ a
    gait-transition pulse, the reference's GAIT_TRANSITION fsmMode),
    BODY_UP -> STAND_UP, BODY_DOWN -> SIT_DOWN, JOY_STAND ->
    LOCOMOTION-stand (zero twist), EXIT -> PASSIVE.

Branch-free integer state machine on pytrees: a batch of scenarios can
each be mid-button-press independently. A "joystick" tick is a JoyInput;
host teleop (control/teleop.py) or recorded traces produce them.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.fsm import FsmState
from quadruped_jax.core import struct


class RcMode:
    """qr_enum_types.h RC_MODE."""

    HARD_CODE = 0
    JOY_TROT = 1
    JOY_ADVANCED_TROT = 2
    JOY_WALK = 3
    JOY_STAND = 4
    BODY_UP = 5
    BODY_DOWN = 6
    EXIT = 7


@struct.dataclass
class JoyInput:
    """One gamepad sample (level-triggered buttons; edges are detected
    inside rc_update, as the reference's callback effectively does at its
    message rate)."""

    vx: jnp.ndarray          # [] right stick vertical, already in m/s
    vy: jnp.ndarray          # [] right stick horizontal, m/s
    wz: jnp.ndarray          # [] left stick horizontal, rad/s
    btn_joy: jnp.ndarray     # [] A: toggle joy control
    btn_gait: jnp.ndarray    # [] X: start locomotion / cycle gait
    btn_stop: jnp.ndarray    # [] B: stop -> MPC stand
    btn_exit: jnp.ndarray    # [] Y: exit -> passive (only when down)
    btn_updown: jnp.ndarray  # [] Rb: body up/down toggle (when stopped)

    @classmethod
    def neutral(cls, vx=0.0, vy=0.0, wz=0.0, **buttons):
        z = lambda name: jnp.asarray(
            float(buttons.get(name, 0.0)), jnp.float32)
        return cls(vx=jnp.asarray(vx, jnp.float32),
                   vy=jnp.asarray(vy, jnp.float32),
                   wz=jnp.asarray(wz, jnp.float32),
                   btn_joy=z("btn_joy"), btn_gait=z("btn_gait"),
                   btn_stop=z("btn_stop"), btn_exit=z("btn_exit"),
                   btn_updown=z("btn_updown"))


@struct.dataclass
class RcState:
    mode: jnp.ndarray           # [] int32 RcMode (joyCtrlState)
    # Last locomotion mode (<= 3). WRITE-ONLY parity state: the
    # reference's prevJoyCtrlState (qr_desired_state_command.cpp:197) is
    # assigned but never read either — kept so a future resume-previous-
    # gait feature lands in the same slot the reference reserved.
    prev_mode: jnp.ndarray      # [] int32
    movement: jnp.ndarray       # [] int32 movementMode (0 stop, 1 move)
    body_up: jnp.ndarray        # [] int32 -1 down / 0 neutral / 1 up
    joy_on: jnp.ndarray         # [] float 1.0 when joy control enabled
    prev_buttons: jnp.ndarray   # [5] last tick's levels for edge detect


def rc_init(start_mode: int = RcMode.JOY_STAND) -> RcState:
    return RcState(
        mode=jnp.asarray(start_mode, jnp.int32),
        prev_mode=jnp.asarray(RcMode.JOY_ADVANCED_TROT, jnp.int32),
        movement=jnp.zeros((), jnp.int32),
        body_up=jnp.zeros((), jnp.int32),
        joy_on=jnp.ones(()),
        prev_buttons=jnp.zeros((5,)))


def _cycle_locomotion_mode(mode):
    """Update :176-192: the gait-cycling rules while moving."""
    nxt = jnp.where(
        (mode == RcMode.HARD_CODE) | (mode == RcMode.BODY_UP),
        RcMode.JOY_STAND,
        jnp.where(mode == RcMode.JOY_STAND, RcMode.JOY_ADVANCED_TROT,
                  jnp.where(mode + 1 > RcMode.JOY_ADVANCED_TROT,
                            RcMode.JOY_TROT, mode + 1)))
    return nxt.astype(jnp.int32)


def rc_update(state: RcState, joy: JoyInput, body_height):
    """One RC tick.

    Returns (new RcState, TwistCommand, fsm_request [] int32 FsmState,
    gait_switch pulse [] float). The fsm_request feeds
    ControlFsmState.desired_state; the pulse feeds
    TwistCommand.gait_switch (the GAIT_TRANSITION channel).
    """
    levels = jnp.stack([joy.btn_joy, joy.btn_gait, joy.btn_stop,
                        joy.btn_exit, joy.btn_updown])
    edges = (levels > 0.5) & (state.prev_buttons <= 0.5)
    e_joy, e_gait, e_stop, e_exit, e_updown = (edges[i] for i in range(5))

    joy_on = jnp.where(e_joy, 1.0 - state.joy_on, state.joy_on)

    # --- JoyCallback button logic (:86-160) ---
    movement = state.movement
    body_up = state.body_up
    request = e_gait  # X always raises the change request
    movement = jnp.where(e_gait, 1, movement)

    # B: stop if moving; re-arm body_up if stopped below.
    stop_moving = e_stop & (movement == 1)
    movement = jnp.where(stop_moving, 0, movement)
    rearm = e_stop & (state.movement == 0) & (state.body_up >= 0)
    body_up = jnp.where(rearm, 0, body_up)
    request = request | stop_moving | rearm

    # Y: exit only when stopped and down.
    exiting = e_exit & (movement == 0) & (body_up <= 0)
    request = request | exiting

    # Rb: body up/down toggle when stopped.
    updown = e_updown & (movement == 0)
    body_up = jnp.where(updown,
                        jnp.where(state.body_up == 0, 1, -state.body_up),
                        body_up)
    request = request | updown

    # --- Update mode machine (:173-210) ---
    moving_mode = _cycle_locomotion_mode(state.mode)
    prev_mode = jnp.where(state.mode <= 3, state.mode, state.prev_mode)
    stopped_mode = jnp.where(
        exiting, RcMode.EXIT,
        jnp.where(body_up == -1, RcMode.BODY_DOWN,
                  jnp.where(body_up == 1, RcMode.BODY_UP,
                            RcMode.JOY_STAND)))
    new_mode = jnp.where(request,
                         jnp.where(movement > 0, moving_mode, stopped_mode),
                         state.mode).astype(jnp.int32)

    # --- command build (:212-265) ---
    in_trot = ((new_mode == RcMode.JOY_TROT)
               | (new_mode == RcMode.JOY_ADVANCED_TROT)
               | (new_mode == RcMode.JOY_WALK))
    pass_sticks = in_trot & (joy_on > 0.5)
    vx = jnp.where(pass_sticks, joy.vx, 0.0)
    vy = jnp.where(pass_sticks, joy.vy, 0.0)
    wz = jnp.where(pass_sticks, joy.wz, 0.0)
    height = jnp.asarray(body_height, jnp.float32)
    height = jnp.where(vx < -0.01, height * 0.85, height)  # walk-back comp

    # Gait-transition pulse: a trot-mode request while already moving is
    # the reference's GAIT_TRANSITION fsmMode (RunFSM :76-80).
    gait_pulse = (request & in_trot
                  & (state.movement == 1)).astype(jnp.float32)
    cmd = TwistCommand(
        linear=jnp.stack([vx, vy, jnp.zeros_like(vx)]),
        angular_z=wz, body_height=height, gait_switch=gait_pulse)

    # --- FSM request mapping (qr_control_fsm.cpp:76-94) ---
    fsm_request = jnp.where(
        in_trot | (new_mode == RcMode.JOY_STAND)
        | (new_mode == RcMode.HARD_CODE),
        FsmState.LOCOMOTION,
        jnp.where(new_mode == RcMode.BODY_UP, FsmState.STAND_UP,
                  jnp.where(new_mode == RcMode.BODY_DOWN,
                            FsmState.SIT_DOWN,
                            FsmState.PASSIVE))).astype(jnp.int32)

    new_state = RcState(mode=new_mode, prev_mode=prev_mode.astype(jnp.int32),
                        movement=movement.astype(jnp.int32),
                        body_up=body_up.astype(jnp.int32),
                        joy_on=joy_on, prev_buttons=levels)
    return new_state, cmd, fsm_request, gait_pulse
