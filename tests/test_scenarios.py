"""Multi-robot / multi-gait batched closed-loop rollouts (BASELINE config 4
capability: heterogeneous fleets through one compiled step)."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.sim.scenario import scenario_grid
from quadruped_jax.sim.rollout import rollout


def test_heterogeneous_fleet_rollout():
    params, gaits, cmds, n = scenario_grid(
        robots=("a1", "go1", "lite3"), gaits=("trot",),
        vx_range=(0.0, 0.3))
    assert n == 6

    base_config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
        swing=swing_mod.SwingConfig(),
        gait=jax.tree.map(lambda x: x[0], gaits))

    def one(p, g, c):
        config = base_config.replace(gait=g)
        return rollout(config, p, c, steps=150)

    res = jax.jit(jax.vmap(one))(params, gaits, cmds)
    alive = np.asarray(res.alive)
    heights = np.asarray(res.base_height_trace)
    assert alive.shape == (6,)
    # All scenarios remain upright for the 0.3 s window.
    assert alive.min() == 1.0, f"dead scenarios: {alive}"
    assert np.all(np.isfinite(heights))
    # Robots hold heights near their own body height.
    final_h = heights[:, -1]
    expected = np.asarray(params.body_height)
    np.testing.assert_allclose(final_h, expected, atol=0.06)


def test_multi_gait_batch():
    params, gaits, cmds, n = scenario_grid(
        robots=("a1",), gaits=("trot", "bound", "pace"),
        vx_range=(0.2,))
    base_config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
        swing=swing_mod.SwingConfig(),
        gait=jax.tree.map(lambda x: x[0], gaits))

    def one(p, g, c):
        return rollout(base_config.replace(gait=g), p, c, steps=150)

    res = jax.jit(jax.vmap(one))(params, gaits, cmds)
    assert np.asarray(res.alive).min() == 1.0
