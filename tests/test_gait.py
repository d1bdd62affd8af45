import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax import gait


def rollout(config, steps=2000, dt=0.001, contact_fn=None):
    """Scan the scheduler through `steps` ticks; returns stacked states."""

    def step(state, t):
        contact = (contact_fn(state, t) if contact_fn
                   else gait.stance_contact_mask(state))
        new = gait.gait_update(config, state, t, contact)
        return new, new

    ts = jnp.arange(1, steps + 1, dtype=jnp.float32) * dt
    _, states = jax.jit(lambda s0: jax.lax.scan(step, s0, ts))(
        gait.gait_init(config))
    return states  # pytree with leading [steps] axis

def test_trot_duty_factor():
    config = gait.TROT()
    states = rollout(config, steps=3000)
    stance = np.asarray(states.desired_leg_state == 1, np.float32)[500:]
    np.testing.assert_allclose(stance.mean(axis=0), 0.6, atol=0.03)


def test_trot_diagonal_pairs_in_phase():
    config = gait.TROT()
    states = rollout(config, steps=1500)
    p = np.asarray(states.phase_in_full_cycle)[100:]
    # FR(0)+RL(3) together, FL(1)+RR(2) together, half-cycle apart.
    assert np.max(np.abs(p[:, 0] - p[:, 3])) < 1e-4
    assert np.max(np.abs(p[:, 1] - p[:, 2])) < 1e-4
    assert np.max(np.abs((p[:, 0] - p[:, 1]) % 1.0 - 0.5)) < 1e-3


def test_phases_normalized():
    config = gait.ADVANCED_TROT()
    states = rollout(config)
    p = np.asarray(states.phase_in_full_cycle)
    n = np.asarray(states.normalized_phase)
    assert np.all((p >= 0) & (p <= 1))
    assert np.all((n >= -1e-6) & (n <= 1 + 1e-6))


def test_early_contact_latched():
    config = gait.TROT()

    def early_touch(state, t):
        # Feet always report contact -> swing legs past threshold flip to
        # EARLY_CONTACT.
        return jnp.ones(4)

    states = rollout(config, steps=1200, contact_fn=early_touch)
    assert np.any(np.asarray(states.leg_state) == gait.LegState.EARLY_CONTACT)


def test_touchdown_wait_freezes_clock():
    config = gait.ADVANCED_TROT()

    def no_touch(state, t):
        return jnp.zeros(4)

    states = rollout(config, steps=1500, contact_fn=no_touch)
    # Clock freeze accumulates reset_time while waiting for touchdown.
    assert float(states.reset_time[-1]) > 0.0
    # But waits are capped by wait_time (cum_wait resets after cap).
    assert float(np.max(np.asarray(states.cum_wait))) <= float(config.wait_time) + 2e-3


def test_contact_table_matches_rollforward():
    config = gait.TROT()
    states = rollout(config, steps=700)
    state = jax.tree.map(lambda x: x[-1], states)
    dt_mpc = 0.03
    table = gait.predicted_contact_table(config, state, dt_mpc, 10)
    # Step 0 of the table == current desired stance.
    np.testing.assert_array_equal(
        np.asarray(table[0]), np.asarray(state.desired_leg_state == 1, np.float32))
    # Check step k against analytically advanced phase.
    period = np.asarray(config.full_cycle_period)
    ratio = np.asarray(config.stance_ratio)
    p0 = np.asarray(state.phase_in_full_cycle)
    for k in range(10):
        pk = (p0 + k * dt_mpc / period) % 1.0
        np.testing.assert_array_equal(np.asarray(table[k]),
                                      (pk < ratio).astype(np.float32))


def test_vmap_over_gaits():
    configs = jax.tree.map(lambda *xs: jnp.stack(xs), gait.TROT(), gait.BOUND(),
                           gait.PACE())
    states = jax.vmap(gait.gait_init)(configs)
    update = jax.jit(jax.vmap(gait.gait_update, in_axes=(0, 0, None, 0)))
    contact = jnp.ones((3, 4))
    for i in range(1, 50):
        states = update(configs, states, jnp.asarray(i * 0.001), contact)
    assert states.phase_in_full_cycle.shape == (3, 4)


def test_touchdown_wait_exposes_blocked_legs():
    """During a touchdown wait, allow_switch flags exactly the legs whose
    clock wants stance but which have not touched down (reference
    allowSwitchLegState, Schedule :222-247)."""
    config = gait.ADVANCED_TROT()

    def no_touch(state, t):
        return jnp.zeros(4)

    states = rollout(config, steps=1500, contact_fn=no_touch)
    allow = np.asarray(states.allow_switch)
    assert allow.min() == 0.0 and allow.max() == 1.0
    # Blocked ticks coincide with frozen-clock ticks (reset_time grows).
    rt = np.asarray(states.reset_time)
    growing = np.diff(rt) > 0
    blocked_any = (allow[1:] < 0.5).any(axis=1)
    np.testing.assert_array_equal(growing, blocked_any)
    # With full contact, never blocked.
    states_ok = rollout(config, steps=1500)
    assert np.all(np.asarray(states_ok.allow_switch) == 1.0)
