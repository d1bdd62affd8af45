import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.gait import WALK, LegState
from quadruped_jax.gait.walk import (SubLegState, WalkGaitState,
                                     walk_gait_init, walk_gait_update,
                                     load_ratios)


def rollout(steps=3000, dt=0.01, contact_fn=None):
    config = WALK()

    def step(state, t):
        contact = (contact_fn(state) if contact_fn
                   else (state.detected_leg_state == LegState.STANCE)
                   .astype(jnp.float32))
        new = walk_gait_update(config, state, t, contact)
        return new, new

    ts = jnp.arange(1, steps + 1, dtype=jnp.float32) * dt
    _, states = jax.jit(lambda s: jax.lax.scan(step, s, ts))(
        walk_gait_init(config))
    return config, states


def test_substate_sequence():
    """Each leg must cycle STANCE -> FULL_STANCE -> UNLOAD -> TRUE_SWING ->
    LOAD -> STANCE in order."""
    config, states = rollout()
    seq = np.asarray(states.leg_sub_state[:, 0])
    # Collapse repeats.
    changes = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
    # Find one full cycle starting at STANCE.
    s = list(changes)
    order = [LegState.STANCE, SubLegState.FULL_STANCE,
             SubLegState.UNLOAD_FORCE, SubLegState.TRUE_SWING,
             SubLegState.LOAD_FORCE]
    # Search the pattern in the observed sequence.
    found = False
    for i in range(len(s) - 4):
        if s[i:i + 5] == order:
            found = True
            break
    assert found, f"sub-state order wrong: {s[:12]}"


def test_one_leg_swings_at_a_time():
    """Statically-stable walk: at most one leg in TRUE_SWING at any tick."""
    config, states = rollout()
    swinging = np.asarray(states.leg_sub_state == SubLegState.TRUE_SWING)
    assert swinging.sum(axis=1).max() <= 1
    # And every leg does swing at some point.
    assert np.all(swinging.any(axis=0))


def test_stance_fraction_matches_duty():
    config, states = rollout(steps=4000)
    frac = np.mean(np.asarray(
        states.leg_sub_state == LegState.STANCE), axis=0)
    np.testing.assert_allclose(frac, 0.75, atol=0.04)


def test_move_base_phase_range():
    config, states = rollout()
    mbp = np.asarray(states.move_base_phase)
    assert mbp.min() >= 0.0 and mbp.max() <= 1.0


def test_load_ratios_ramp():
    config = WALK()
    state = walk_gait_init(config)
    # Force a leg into UNLOAD at phase 0.5: f_max halves.
    state = state.replace(
        leg_sub_state=jnp.asarray([SubLegState.UNLOAD_FORCE, LegState.STANCE,
                                   SubLegState.TRUE_SWING,
                                   SubLegState.LOAD_FORCE], jnp.int32),
        normalized_phase=jnp.asarray([0.5, 0.2, 0.5, 0.25]))
    f_min, f_max = load_ratios(state)
    np.testing.assert_allclose(f_max[0], 5.0, atol=1e-5)   # unloading
    np.testing.assert_allclose(f_max[1], 10.0, atol=1e-5)  # full stance
    np.testing.assert_allclose(f_max[2], 0.001, atol=1e-5)  # swing
    np.testing.assert_allclose(f_max[3], 2.5, atol=1e-5)   # loading
    assert float(f_min[1]) > 0


def test_early_and_lose_contact_detection():
    config = WALK()

    def all_contact(state):
        return jnp.ones(4)

    _, states = rollout(steps=3000, contact_fn=all_contact)
    det = np.asarray(states.detected_leg_state)
    assert (det == LegState.EARLY_CONTACT).any()

    def no_contact(state):
        return jnp.zeros(4)

    _, states = rollout(steps=3000, contact_fn=no_contact)
    det = np.asarray(states.detected_leg_state)
    assert (det == LegState.LOSE_CONTACT).any()


def test_early_contact_overrides_load_ratio():
    """A leg detected EARLY_CONTACT during TRUE_SWING becomes a support leg
    with a tiny force budget (UpdateFRatio detected branch)."""
    import jax.numpy as jnp
    from quadruped_jax.gait import walk as walk_mod
    from quadruped_jax.gait.scheduler import LegState, WALK

    config = WALK()
    state = walk_mod.walk_gait_init(config)
    # Mid TRUE_SWING with contact already detected.
    state = state.replace(
        leg_sub_state=jnp.asarray(
            [walk_mod.SubLegState.TRUE_SWING, LegState.STANCE,
             LegState.STANCE, LegState.STANCE], jnp.int32),
        detected_leg_state=jnp.asarray(
            [LegState.EARLY_CONTACT, LegState.STANCE, LegState.STANCE,
             LegState.STANCE], jnp.int32),
        normalized_phase=jnp.asarray([0.5, 0.1, 0.1, 0.1]))
    f_min, f_max = walk_mod.load_ratios(state)
    # Early-contact leg: loaded but barely (10 * min(0.01, |0.5-0.8|) = 0.1).
    assert abs(float(f_max[0]) - 0.1) < 1e-6
    assert abs(float(f_min[0]) - 0.001) < 1e-6
    # Stance legs keep full budget.
    assert float(f_max[1]) == 10.0
