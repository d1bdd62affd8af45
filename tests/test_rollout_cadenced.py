import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim.rollout_cadenced import rollout_cadenced


def test_cadenced_rollout_stable_trot():
    params = a1_params()
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=40),
        swing=swing_mod.SwingConfig(),
        gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=0.3, body_height=0.27)
    res = jax.jit(lambda: rollout_cadenced(config, params, cmd,
                                           n_periods=40))()
    assert float(res.alive) == 1.0
    h = np.asarray(res.base_height_trace)
    assert np.all(np.isfinite(h))
    assert 0.2 < h[-1] < 0.35
    vx = np.asarray(res.vel_trace)[:, 0]
    assert vx[-10:].mean() > 0.1
