"""Online gait switching: decelerate -> stand -> swap gait -> resume.

Capability parity with the reference's runtime gait transition
(qr_fsm_state_locomotion.cpp:271-340 `SwitchMode`/`StandLoop` + the
`qrSwitchModeReceiver` ROS hook): when a gait change is requested, the
commanded twist ramps to zero over ~1 s (jumping ahead the moment all four
feet are down, as the reference's `if (N == 4) iter = 1000` does), the
robot holds full stance for ~1 s with the gait clock frozen, then the
gait clock is re-initialized with the other gait table and the command
ramps back in. Each completed transition TOGGLES between the two
configured gaits, so trot -> walk -> trot round trips compose.

Where the reference blends to stand angles under position control during
the hold (SwitchMode :298-306), this engine holds stance through the MPC
("MPC standing", the reference's LOCOMOTION_STAND substate) — the gait
state is pinned to full stance and the solver balances; that keeps the
whole transition inside the one batched control path.

Because gait tables are pytrees of identical structure, "swapping the
gait" is a masked select between two configs — fully batchable, so every
scenario in a batch can transition at its own time. Wired into the
closed loop by control/locomotion.py (LocomotionConfig.gait_b) and driven
either by `TwistCommand.gait_switch` rising edges (the SwitchModeReceiver
channel) or `request_transition` (programmatic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quadruped_jax.core import struct
from quadruped_jax.gait.scheduler import (GaitConfig, GaitState, LegState,
                                          gait_init)
from quadruped_jax.control.desired_state import TwistCommand

DECEL_TIME = 1.0
STAND_TIME = 1.0


class TransitionPhase:
    NONE = 0
    DECEL = 1
    STAND = 2


@struct.dataclass
class GaitTransitionState:
    phase: jnp.ndarray        # [] int32 TransitionPhase
    phase_start: jnp.ndarray  # [] time the phase began
    active_idx: jnp.ndarray   # [] 0.0 = gait A, 1.0 = gait B
    prev_switch: jnp.ndarray  # [] last tick's switch-request level


def gait_transition_init() -> GaitTransitionState:
    return GaitTransitionState(
        phase=jnp.asarray(TransitionPhase.NONE, jnp.int32),
        phase_start=jnp.zeros((), jnp.float32),
        active_idx=jnp.zeros((), jnp.float32),
        prev_switch=jnp.zeros((), jnp.float32))


def request_transition(state: GaitTransitionState,
                       t: jnp.ndarray) -> GaitTransitionState:
    """Begin a transition (idempotent while one is active)."""
    idle = state.phase == TransitionPhase.NONE
    return state.replace(
        phase=jnp.where(idle, TransitionPhase.DECEL, state.phase)
        .astype(jnp.int32),
        phase_start=jnp.where(idle, t, state.phase_start))


def active_gait(state: GaitTransitionState, gait_a: GaitConfig,
                gait_b: GaitConfig) -> GaitConfig:
    """Masked select of the currently-active gait table."""
    pick = lambda a, b: jnp.where(state.active_idx > 0.5, b, a)
    return jax.tree.map(pick, gait_a, gait_b)


def _full_stance(gs: GaitState) -> GaitState:
    """Pin a gait state to full stance (the MPC-standing hold)."""
    stance4 = jnp.full((4,), LegState.STANCE, jnp.int32)
    z4 = jnp.zeros((4,), jnp.float32)
    return gs.replace(leg_state=stance4, cur_leg_state=stance4,
                      desired_leg_state=stance4, normalized_phase=z4,
                      phase_in_full_cycle=z4, first_swing=z4)


def gait_transition_step(state: GaitTransitionState,
                         gait_state: GaitState,
                         gait_a: GaitConfig, gait_b: GaitConfig,
                         cmd: TwistCommand, t: jnp.ndarray,
                         contact: jnp.ndarray | None = None):
    """One tick of the transition manager (call BEFORE `gait_update`).

    Returns (active GaitConfig, adjusted GaitState, scaled cmd, hold flag,
    new transition state). `hold` > 0.5 means the caller must pin the
    post-update gait state to full stance (`hold_stance_gait`).
    """
    # Rising edge on the command stream's switch channel.
    switch_level = getattr(cmd, "gait_switch", None)
    if switch_level is not None:
        rising = (switch_level > 0.5) & (state.prev_switch <= 0.5)
        state = state.replace(prev_switch=switch_level)
        idle = state.phase == TransitionPhase.NONE
        start = rising & idle
        state = state.replace(
            phase=jnp.where(start, TransitionPhase.DECEL, state.phase)
            .astype(jnp.int32),
            phase_start=jnp.where(start, t, state.phase_start))

    elapsed = t - state.phase_start
    in_decel = state.phase == TransitionPhase.DECEL
    in_stand = state.phase == TransitionPhase.STAND

    # DECEL -> STAND: after the ramp, or the moment all four feet are down
    # with the clock in its all-stance window (the reference's N == 4
    # early exit, SwitchMode :292-295 — gated on the clock too so the
    # frozen hold state is consistent).
    clock_stance = jnp.min(
        (gait_state.desired_leg_state == LegState.STANCE)
        .astype(jnp.float32))
    measured4 = (jnp.min(contact) > 0.5 if contact is not None
                 else jnp.asarray(True))
    can_jump = (clock_stance > 0.5) & measured4
    decel_done = in_decel & ((elapsed >= DECEL_TIME) | can_jump)
    stand_done = in_stand & (elapsed >= STAND_TIME)

    new_phase = jnp.where(decel_done, TransitionPhase.STAND, state.phase)
    new_phase = jnp.where(stand_done, TransitionPhase.NONE, new_phase)
    new_start = jnp.where(decel_done | stand_done, t, state.phase_start)
    new_idx = jnp.where(stand_done, 1.0 - state.active_idx,
                        state.active_idx)

    # Command scaling from the POST-advance phase: ramp to zero during
    # DECEL, zero through the STAND hold (including the early-exit tick).
    scale = jnp.where(new_phase == TransitionPhase.DECEL,
                      jnp.clip(1.0 - elapsed / DECEL_TIME, 0.0, 1.0),
                      jnp.where(new_phase == TransitionPhase.STAND,
                                0.0, 1.0))
    cmd_out = cmd.replace(linear=cmd.linear * scale,
                          angular_z=cmd.angular_z * scale)

    new_state = state.replace(phase=new_phase.astype(jnp.int32),
                              phase_start=new_start, active_idx=new_idx)
    active = active_gait(new_state, gait_a, gait_b)

    # STAND hold: freeze the gait clock (reset_time tracks t) so phases
    # stay put; `hold` tells the caller to pin the state to full stance.
    hold = (in_stand & ~stand_done) | decel_done
    dt = t - gait_state.last_time
    gait_out = gait_state.replace(
        reset_time=jnp.where(hold, gait_state.reset_time + dt,
                             gait_state.reset_time))
    # Swap instant: restart the new gait's clock from phase zero.
    fresh = gait_init(active).replace(
        reset_time=t + 0.0 * t, last_time=gait_state.last_time)
    gait_out = jax.tree.map(
        lambda new, old: jnp.where(stand_done, new, old), fresh, gait_out)

    return active, gait_out, cmd_out, hold.astype(jnp.float32), new_state


def hold_stance_gait(hold: jnp.ndarray, gs: GaitState) -> GaitState:
    """Apply the stance hold AFTER gait_update when `hold` is set."""
    pinned = _full_stance(gs)
    return jax.tree.map(
        lambda a, b: jnp.where(hold > 0.5, a, b), pinned, gs)
