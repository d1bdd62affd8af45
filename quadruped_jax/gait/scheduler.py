"""Phase-clock gait scheduler, batched and branch-free.

Capability parity with the reference's gait engine
(quadruped/src/gait/qr_openloop_gait_generator.cpp:77-249 and base
quadruped/include/quadruped/gait/qr_gait.h): per-leg full-cycle phase from
initial phase offsets + duty factor, leg states STANCE / SWING /
EARLY_CONTACT (+ LOSE_CONTACT, USERDEFINED_SWING), contact-triggered early
contact after a detection-phase threshold, and the advanced-trot
"don't switch to stance until touch-down" wait logic (`allowSwitchLegState`
+ `waitTime` clock freeze, Schedule :211-249).

Batch-first redesign: the reference mutates 10 member arrays under `if`s at
1 kHz; here the whole scheduler is one pure function
`gait_update(config, state, t, contact) -> state'` of masked arithmetic, so
thousands of independent gait clocks (different gaits / periods / offsets
per scenario) advance in a single fused XLA kernel, and `lax.scan` rolls
them through time.

Gait tables come from quadruped/config/a1_sim/openloop_gait_generator.yaml.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import struct


class LegState:
    """Leg-state codes (reference qr_enum_types.h LegState)."""

    SWING = 0
    STANCE = 1
    EARLY_CONTACT = 2
    LOSE_CONTACT = 3
    USERDEFINED_SWING = 4


@struct.dataclass
class GaitConfig:
    """Static gait table (batchable; one per scenario if desired)."""

    stance_duration: jnp.ndarray     # [4] s
    duty_factor: jnp.ndarray         # [4]
    init_phase: jnp.ndarray          # [4] initial full-cycle phase offset
    initial_leg_state: jnp.ndarray   # [4] int (STANCE/SWING)
    contact_detection_phase_threshold: jnp.ndarray  # []
    wait_time: jnp.ndarray           # [] advanced-trot touchdown wait cap (s)
    use_touchdown_wait: jnp.ndarray  # [] bool-like (advanced_trot only)

    @property
    def full_cycle_period(self) -> jnp.ndarray:
        return self.stance_duration / jnp.maximum(self.duty_factor, 1e-6)

    @property
    def swing_duration(self) -> jnp.ndarray:
        return self.full_cycle_period - self.stance_duration

    @property
    def stance_ratio(self) -> jnp.ndarray:
        """Fraction of the cycle each leg spends in its initial state
        (`initStateRadioInCycle` in the reference)."""
        init_stance = self.initial_leg_state == LegState.STANCE
        return jnp.where(init_stance, self.duty_factor, 1.0 - self.duty_factor)


def _config(stance, duty, phases, wait_time=0.3, threshold=0.5,
            touchdown_wait=False) -> GaitConfig:
    f = jnp.float32
    return GaitConfig(
        stance_duration=jnp.full((4,), stance, f),
        duty_factor=jnp.full((4,), duty, f),
        init_phase=jnp.asarray(phases, f),
        initial_leg_state=jnp.full((4,), LegState.STANCE, jnp.int32),
        contact_detection_phase_threshold=jnp.asarray(threshold, f),
        wait_time=jnp.asarray(wait_time, f),
        use_touchdown_wait=jnp.asarray(1.0 if touchdown_wait else 0.0, f),
    )


# Named gait tables (reference openloop_gait_generator.yaml; bound/pace are
# new batch-sweep configs with the standard phase offsets).
TROT = lambda: _config(0.3, 0.6, [0.5, 0.0, 0.0, 0.5])
ADVANCED_TROT = lambda: _config(0.5, 0.6, [0.5, 0.0, 0.0, 0.5],
                                touchdown_wait=True)
# High-speed trot (0.4 s cycle). The stride ceiling is set by the gait:
# with the reference's +/-0.2 m foothold clip, achievable speed is roughly
# 2 * clip / cycle — 0.48 m/s cycle-limited at the 0.833 s advanced trot,
# ~1.2 m/s here. Measured on the whole-body sim (benchmarks/
# exp_high_speed_trot.py): 1.06 m/s at cmd 1.5, stable, |pitch| < 0.17.
FAST_TROT = lambda: _config(0.24, 0.6, [0.5, 0.0, 0.0, 0.5])
WALK = lambda: _config(7.5, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1)
STAND = lambda: _config(0.3, 1.0, [0.0, 0.0, 0.0, 0.0], threshold=0.1)
BOUND = lambda: _config(0.25, 0.55, [0.0, 0.0, 0.5, 0.5])
PACE = lambda: _config(0.3, 0.6, [0.0, 0.5, 0.0, 0.5])


def THREESTAND():
    """Three-legged stand (reference openloop_gait_generator.yaml
    `threestand`): RR is held in USERDEFINED_SWING, the others stand."""
    cfg = _config(0.3, 1.0, [0.0, 0.0, 0.0, 0.0], threshold=0.1)
    return cfg.replace(
        duty_factor=cfg.duty_factor.at[2].set(1e-6),
        stance_duration=cfg.stance_duration.at[2].set(0.0),
        initial_leg_state=cfg.initial_leg_state.at[2].set(
            LegState.USERDEFINED_SWING))


_NAMED = {"trot": TROT, "advanced_trot": ADVANCED_TROT,
          "fast_trot": FAST_TROT, "walk": WALK,
          "stand": STAND, "bound": BOUND, "pace": PACE,
          "threestand": THREESTAND}


def named_gait(name: str) -> GaitConfig:
    return _NAMED[name]()


@struct.dataclass
class GaitState:
    """Dynamic per-scenario scheduler state."""

    leg_state: jnp.ndarray           # [4] int current (possibly EARLY_CONTACT)
    cur_leg_state: jnp.ndarray       # [4] int clock-driven state
    last_leg_state: jnp.ndarray      # [4] int previous clock state
    desired_leg_state: jnp.ndarray   # [4] int state the clock wants
    normalized_phase: jnp.ndarray    # [4] phase within current sub-state
    phase_in_full_cycle: jnp.ndarray  # [4]
    first_swing: jnp.ndarray         # [4] 1.0 on the tick entering swing
    swing_time_remaining: jnp.ndarray  # [4] s
    allow_switch: jnp.ndarray        # [4] 0.0 while a leg is in touchdown
                                     # wait (blocked from entering stance)
    reset_time: jnp.ndarray          # [] clock freeze accumulator
    cum_wait: jnp.ndarray            # [] advanced-trot wait accumulator
    last_time: jnp.ndarray           # []


def gait_init(config: GaitConfig) -> GaitState:
    i4 = jnp.asarray([LegState.STANCE] * 4, jnp.int32)
    z4 = jnp.zeros((4,), jnp.float32)
    return GaitState(
        leg_state=config.initial_leg_state.astype(jnp.int32),
        cur_leg_state=i4,
        last_leg_state=i4,
        desired_leg_state=i4,
        normalized_phase=z4,
        phase_in_full_cycle=z4,
        first_swing=z4,
        swing_time_remaining=z4,
        allow_switch=jnp.ones((4,), jnp.float32),
        reset_time=jnp.zeros((), jnp.float32),
        cum_wait=jnp.zeros((), jnp.float32),
        last_time=jnp.zeros((), jnp.float32),
    )


def gait_update(config: GaitConfig, state: GaitState, t: jnp.ndarray,
                contact: jnp.ndarray) -> GaitState:
    """One scheduler tick.

    t: [] absolute time since gait reset; contact: [4] measured foot contact
    (bool-like). Returns the updated state. Pure masked arithmetic —
    vmap/scan safe.
    """
    dt = t - state.last_time
    period = config.full_cycle_period
    ratio = config.stance_ratio

    # ---- advanced-trot touchdown wait (Schedule :211-249) ----
    # A leg whose clock wants STANCE but which has not touched down blocks
    # the state switch; while blocked, the gait clock is frozen by advancing
    # reset_time, for at most wait_time seconds.
    wants_stance = ((state.cur_leg_state == LegState.SWING)
                    & (state.desired_leg_state == LegState.STANCE)
                    & (contact <= 0.5))
    any_blocked = (jnp.max(wants_stance.astype(jnp.float32))
                   * config.use_touchdown_wait)
    cum_wait = jnp.where(any_blocked > 0, state.cum_wait + dt, 0.0)
    still_waiting = (any_blocked > 0) & (cum_wait <= config.wait_time)
    reset_time = jnp.where(still_waiting, state.reset_time + dt,
                           state.reset_time)
    allow_switch = ~still_waiting
    # Per-leg exposure (reference allowSwitchLegState): the blocked legs,
    # while the wait is active. The swing controller keeps these legs in
    # the swing set and probes them toward the ground.
    allow_switch_leg = jnp.where(wants_stance & still_waiting, 0.0, 1.0)

    t_eff = t - reset_time

    # ---- phase clocks ----
    aug = config.init_phase * period + t_eff
    phase = jnp.mod(aug, period) / period
    in_stance = phase < ratio
    desired = jnp.where(in_stance, LegState.STANCE, LegState.SWING)
    norm_phase = jnp.where(
        in_stance, phase / jnp.maximum(ratio, 1e-6),
        (phase - ratio) / jnp.maximum(1.0 - ratio, 1e-6))

    # ---- state latching (Update :126-208), applied when switching allowed --
    new_last = jnp.where(allow_switch, state.cur_leg_state,
                         state.last_leg_state)
    new_cur = jnp.where(allow_switch, state.desired_leg_state,
                        state.cur_leg_state)

    entering_swing = ((desired == LegState.SWING)
                      & (new_cur == LegState.STANCE) & allow_switch)
    first_swing = entering_swing.astype(jnp.float32)
    swing_remaining = jnp.where(
        desired == LegState.SWING,
        jnp.where(entering_swing, config.swing_duration,
                  config.swing_duration * (1.0 - norm_phase)),
        state.swing_time_remaining)

    # leg_state follows desired, except EARLY_CONTACT latches through the
    # remainder of the swing window.
    keep_early = ((state.leg_state == LegState.EARLY_CONTACT)
                  & (desired == LegState.SWING))
    leg_state = jnp.where(keep_early, state.leg_state, desired)

    # Contact-triggered EARLY_CONTACT after the detection threshold.
    detect = norm_phase >= config.contact_detection_phase_threshold
    early = ((leg_state == LegState.SWING) & (contact > 0.5) & detect
             & allow_switch)
    leg_state = jnp.where(early, LegState.EARLY_CONTACT, leg_state)

    # USERDEFINED_SWING legs are pinned by config (the reference `continue`s
    # them in Update; threestand holds one leg raised).
    user = config.initial_leg_state == LegState.USERDEFINED_SWING
    leg_state = jnp.where(user, LegState.USERDEFINED_SWING, leg_state)
    desired = jnp.where(user, LegState.USERDEFINED_SWING, desired)

    return state.replace(
        leg_state=leg_state.astype(jnp.int32),
        cur_leg_state=new_cur.astype(jnp.int32),
        last_leg_state=new_last.astype(jnp.int32),
        desired_leg_state=desired.astype(jnp.int32),
        normalized_phase=norm_phase,
        phase_in_full_cycle=phase,
        first_swing=first_swing,
        swing_time_remaining=swing_remaining,
        allow_switch=allow_switch_leg,
        reset_time=reset_time,
        cum_wait=cum_wait,
        last_time=t,
    )


def predicted_contact_table(config: GaitConfig, state: GaitState,
                            dt_mpc, horizon: int) -> jnp.ndarray:
    """[H, 4] future stance prediction for the MPC contact schedule.

    Pure phase arithmetic (reference builds `mpcTable` at
    qr_mpc_stance_leg_controller.cpp:282-303 from gait phases the same way).
    Batched configs/states broadcast to [..., H, 4].
    """
    period = config.full_cycle_period
    ratio = config.stance_ratio
    k = jnp.arange(horizon, dtype=period.dtype)
    future = (state.phase_in_full_cycle[..., None, :]
              + k[:, None] * dt_mpc / period[..., None, :])
    future = jnp.mod(future, 1.0)
    return (future < ratio[..., None, :]).astype(period.dtype)


def stance_contact_mask(state: GaitState) -> jnp.ndarray:
    """[..., 4] 1.0 where the leg should bear load (STANCE, EARLY_CONTACT,
    LOSE_CONTACT are treated as load-bearing by the stance controllers)."""
    s = state.leg_state
    return ((s == LegState.STANCE) | (s == LegState.EARLY_CONTACT)
            | (s == LegState.LOSE_CONTACT)).astype(jnp.float32)
