"""Control finite-state machine, batched and branch-free.

Capability parity with `qrControlFSM<T>`
(quadruped/src/fsm/qr_control_fsm.cpp:29-201) and its states
(qr_fsm_state_passive.cpp, qr_fsm_state_standup.cpp,
qr_fsm_state_locomotion.cpp): operating modes NORMAL / TRANSITIONING /
ESTOP, states PASSIVE / STAND_UP / LOCOMOTION / SIT_DOWN, per-state command
generation, timed transitions, and the safety post-check.

Batched redesign: per-scenario integer state + `lax.switch` over pure state
functions; transitions are mask updates on (state, transition timer). Every
scenario in a batch can be in a different FSM state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quadruped_jax.control.types import HybridCommand, RobotObservation
from quadruped_jax.control import actions, safety
from quadruped_jax.core import struct
from quadruped_jax.robots.params import RobotParams


class FsmState:
    PASSIVE = 0
    STAND_UP = 1
    LOCOMOTION = 2
    SIT_DOWN = 3


class FsmMode:
    NORMAL = 0
    TRANSITIONING = 1
    ESTOP = 2


@struct.dataclass
class ControlFsmState:
    state: jnp.ndarray           # [] int32 current FsmState
    mode: jnp.ndarray            # [] int32 FsmMode
    state_start_time: jnp.ndarray  # []
    q_at_entry: jnp.ndarray      # [12] captured pose for blends
    desired_state: jnp.ndarray   # [] int32 commanded next state


def fsm_init(q0: jnp.ndarray) -> ControlFsmState:
    return ControlFsmState(
        state=jnp.asarray(FsmState.STAND_UP, jnp.int32),
        mode=jnp.asarray(FsmMode.NORMAL, jnp.int32),
        state_start_time=jnp.zeros((), jnp.float32),
        q_at_entry=q0,
        desired_state=jnp.asarray(FsmState.LOCOMOTION, jnp.int32))


def fsm_step(params: RobotParams, fsm: ControlFsmState,
             obs: RobotObservation, t: jnp.ndarray,
             locomotion_command: HybridCommand,
             desired_state: jnp.ndarray | None = None):
    """One FSM tick (RunFSM :68-152).

    `locomotion_command` is the already-computed locomotion controller
    output for this tick (the FSM selects whether to use it).
    `desired_state` (optional [] int32 FsmState) is the RC/joy request
    channel (control/rc_mode.py -> RunFSM's fsmMode mapping :72-94).
    Returns (HybridCommand, new fsm state, in_locomotion mask).
    """
    if desired_state is not None:
        fsm = fsm.replace(desired_state=desired_state.astype(jnp.int32))
    elapsed = t - fsm.state_start_time

    def passive(_):
        z = jnp.zeros(12, jnp.float32)
        return HybridCommand(q=z, kp=z, dq=z,
                             kd=jnp.full((12,), 2.0, jnp.float32), tau=z)

    def stand_up(_):
        return actions.standup_command(params, fsm.q_at_entry, elapsed)

    def locomotion(_):
        return locomotion_command

    def sit_down(_):
        return actions.sitdown_command(params, fsm.q_at_entry, elapsed)

    command = jax.lax.switch(fsm.state,
                             [passive, stand_up, locomotion, sit_down], None)

    # Safety post-check (SafetyPostCheck :181-201): orientation guard always;
    # the tip-over height envelope only applies in LOCOMOTION (the reference
    # checks it in the run loop, where the robot is expected upright —
    # stand-up/sit-down legitimately pass through low heights).
    command = safety.clip_command(params, command)
    safe = safety.check_safe_orientation(obs)
    in_loco_now = fsm.state == FsmState.LOCOMOTION
    safe = safe * jnp.where(in_loco_now, safety.check_tip_over(obs), 1.0)
    damped = HybridCommand(
        q=jnp.zeros_like(command.q), kp=jnp.zeros_like(command.kp),
        dq=jnp.zeros_like(command.dq),
        kd=jnp.full_like(command.kd, 2.0), tau=jnp.zeros_like(command.tau))
    pick = lambda a, b: jnp.where(safe[..., None] > 0.5, a, b)
    command = HybridCommand(
        q=pick(command.q, damped.q), kp=pick(command.kp, damped.kp),
        dq=pick(command.dq, damped.dq), kd=pick(command.kd, damped.kd),
        tau=pick(command.tau, damped.tau))
    estop = safe < 0.5

    # Transitions: STAND_UP completes after the ramp -> desired state;
    # SIT_DOWN completes -> PASSIVE; ESTOP forces PASSIVE.
    standup_done = (fsm.state == FsmState.STAND_UP) \
        & (elapsed > actions.STANDUP_DURATION)
    sitdown_done = (fsm.state == FsmState.SIT_DOWN) \
        & (elapsed > actions.SITDOWN_DURATION)
    want_switch = (fsm.state != fsm.desired_state) \
        & (fsm.state == FsmState.LOCOMOTION) \
        & ((fsm.desired_state == FsmState.SIT_DOWN)
           | (fsm.desired_state == FsmState.PASSIVE))
    # BODY_UP from the RC machine: a resting robot commanded up stands up
    # (reference K_STAND_UP request from PASSIVE). ONLY an explicit
    # STAND_UP request leaves PASSIVE: the boot default desired_state is
    # LOCOMOTION, so accepting it here would let an e-stopped robot
    # re-arm itself the moment its orientation check passes (PASSIVE must
    # stay absorbing for non-RC callers).
    want_up = (fsm.state == FsmState.PASSIVE) \
        & (fsm.desired_state == FsmState.STAND_UP)

    new_state = fsm.state
    new_state = jnp.where(standup_done, fsm.desired_state, new_state)
    new_state = jnp.where(sitdown_done, FsmState.PASSIVE, new_state)
    new_state = jnp.where(want_switch, fsm.desired_state, new_state)
    new_state = jnp.where(want_up, FsmState.STAND_UP, new_state)
    new_state = jnp.where(estop, FsmState.PASSIVE, new_state)

    switched = new_state != fsm.state
    new_fsm = fsm.replace(
        state=new_state.astype(jnp.int32),
        mode=jnp.where(estop, FsmMode.ESTOP, FsmMode.NORMAL).astype(jnp.int32),
        state_start_time=jnp.where(switched, t, fsm.state_start_time),
        q_at_entry=jnp.where(switched, obs.joint_angles, fsm.q_at_entry))
    in_locomotion = (new_state == FsmState.LOCOMOTION).astype(jnp.float32)
    return command, new_fsm, in_locomotion
