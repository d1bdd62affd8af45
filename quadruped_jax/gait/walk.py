"""Statically-stable walk gait: swing-phase sub-state machine, batched.

Capability parity with `qrWalkGaitGenerator`
(quadruped/src/gait/qr_walk_gait_generator.cpp:33-292): the swing window of
each leg is split into the queue FULL_STANCE -> UNLOAD_FORCE -> TRUE_SWING
-> LOAD_FORCE by the `state_ratio` table (a1_sim openloop_gait_generator.yaml
walk: [0.2, 0.3, 0.3, 0.2]); the generator tracks per-leg sub-state,
sub-state-normalized phase, the `moveBasePhase` used by the pose planner,
and the detected EARLY_CONTACT / LOSE_CONTACT events.

Branch-free: the sub-state index is recovered from the swing phase by
comparing against the cumulative ratio table (a searchsorted over 4 static
breakpoints), so no per-leg mutable index is needed — phase is the single
source of truth, which also makes the generator trivially batchable and
restartable.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import struct
from quadruped_jax.gait.scheduler import GaitConfig, LegState


class SubLegState:
    """Walk sub-states (reference qr_enum_types.h SubLegState)."""

    FULL_STANCE = 5
    LOAD_FORCE = 6
    UNLOAD_FORCE = 7
    TRUE_SWING = 8


# state_switch_que from the reference walk config.
SUB_QUEUE = (SubLegState.FULL_STANCE, SubLegState.UNLOAD_FORCE,
             SubLegState.TRUE_SWING, SubLegState.LOAD_FORCE)
SUB_RATIOS = (0.2, 0.3, 0.3, 0.2)


@struct.dataclass
class WalkGaitState:
    leg_sub_state: jnp.ndarray       # [4] int (STANCE or a SubLegState)
    detected_leg_state: jnp.ndarray  # [4] int (STANCE/SWING/EARLY/LOSE)
    normalized_phase: jnp.ndarray    # [4] within the active (sub-)state
    phase_in_full_cycle: jnp.ndarray  # [4]
    move_base_phase: jnp.ndarray     # [] pose-planner progress 0..1
    true_swing_start: jnp.ndarray    # [] phase-in-full-cycle of swing start
    true_swing_end: jnp.ndarray      # []


def walk_gait_init(config: GaitConfig) -> WalkGaitState:
    ratios = jnp.asarray(SUB_RATIOS, jnp.float32)
    cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(ratios)])
    duty = config.duty_factor[0]
    swing_start = duty + (1 - duty) * cum[2]   # TRUE_SWING start
    swing_end = duty + (1 - duty) * cum[3]
    return WalkGaitState(
        leg_sub_state=jnp.full((4,), LegState.STANCE, jnp.int32),
        detected_leg_state=jnp.full((4,), LegState.STANCE, jnp.int32),
        normalized_phase=jnp.zeros(4, jnp.float32),
        phase_in_full_cycle=jnp.zeros(4, jnp.float32),
        move_base_phase=jnp.zeros((), jnp.float32),
        true_swing_start=swing_start,
        true_swing_end=swing_end)


def walk_gait_update(config: GaitConfig, state: WalkGaitState,
                     t: jnp.ndarray, contact: jnp.ndarray) -> WalkGaitState:
    """One walk-gait tick (Update :200-292)."""
    period = config.full_cycle_period
    duty = config.duty_factor
    phase = jnp.mod(config.init_phase * period + t, period) / period

    in_stance = phase <= duty
    phase_swing = jnp.clip((phase - duty) / jnp.maximum(1 - duty, 1e-6),
                           0.0, 1.0)

    ratios = jnp.asarray(SUB_RATIOS, phase.dtype)
    cum = jnp.concatenate([jnp.zeros(1, phase.dtype), jnp.cumsum(ratios)])
    # Sub-state index from the cumulative table (vectorized searchsorted).
    idx = jnp.sum((phase_swing[:, None] >= cum[None, 1:4]).astype(jnp.int32),
                  axis=1)  # 0..3
    sub_codes = jnp.asarray(SUB_QUEUE, jnp.int32)
    sub_state = sub_codes[idx]
    start = cum[idx]
    width = ratios[idx]
    norm_sub = (phase_swing - start) / jnp.maximum(width, 1e-6)

    leg_state = jnp.where(in_stance, LegState.STANCE, sub_state)
    norm_phase = jnp.where(in_stance,
                           phase / jnp.maximum(duty, 1e-6), norm_sub)

    # moveBasePhase: progress of the pre-swing window of the leg currently
    # approaching TRUE_SWING (the pose planner shifts the base then).
    tss = cum[2]  # true-swing start ratio within the swing window
    mbp_per_leg = jnp.where(phase_swing < tss,
                            phase_swing / jnp.maximum(tss, 1e-6), 1.0)
    active = ~in_stance
    move_base_phase = jnp.where(jnp.any(active),
                                jnp.min(jnp.where(active, mbp_per_leg, 1.0)),
                                1.0)

    # Detected states + contact events past the detection threshold.
    detected = jnp.where(in_stance, LegState.STANCE, LegState.SWING)
    past_thresh = norm_phase >= config.contact_detection_phase_threshold
    early = (sub_state == SubLegState.TRUE_SWING) & ~in_stance \
        & (contact > 0.5) & past_thresh
    lose = in_stance & (contact <= 0.5) & past_thresh
    detected = jnp.where(early, LegState.EARLY_CONTACT, detected)
    detected = jnp.where(lose, LegState.LOSE_CONTACT, detected)

    return state.replace(
        leg_sub_state=leg_state.astype(jnp.int32),
        detected_leg_state=detected.astype(jnp.int32),
        normalized_phase=norm_phase,
        phase_in_full_cycle=phase,
        move_base_phase=move_base_phase)


def load_ratios(state: WalkGaitState) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-leg (f_min_ratio, f_max_ratio) for the force-balance QP's walk
    load/unload ramps (TorqueStanceLegController::UpdateFRatio
    :89-172): UNLOAD_FORCE ramps the max force down toward zero, LOAD_FORCE
    ramps it back up; TRUE_SWING pins it to ~0."""
    s = state.leg_sub_state
    phi = state.normalized_phase
    full = jnp.full_like(phi, 10.0)
    f_max = jnp.where(s == SubLegState.UNLOAD_FORCE,
                      10.0 * jnp.maximum(1.0 - phi, 0.001), full)
    f_max = jnp.where(s == SubLegState.TRUE_SWING,
                      jnp.full_like(phi, 0.001), f_max)
    f_max = jnp.where(s == SubLegState.LOAD_FORCE,
                      10.0 * jnp.maximum(phi, 0.001), f_max)
    f_min = jnp.where((s == LegState.STANCE) | (s == SubLegState.FULL_STANCE),
                      jnp.full_like(phi, 0.01), jnp.zeros_like(phi))
    # Detected-event overrides (UpdateFRatio detected branch): an
    # EARLY_CONTACT leg (plan swing, actually standing) becomes a support
    # leg carrying only a sliver of force, ramping with distance from the
    # nominal touchdown phase.
    early = state.detected_leg_state == LegState.EARLY_CONTACT
    f_max = jnp.where(early, 10.0 * jnp.minimum(0.01, jnp.abs(phi - 0.8)),
                      f_max)
    f_min = jnp.where(early, jnp.full_like(phi, 0.001), f_min)
    return f_min, f_max
