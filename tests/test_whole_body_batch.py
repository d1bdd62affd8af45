"""Batched whole-body simulation: the fidelity mode also vmaps (SURVEY
config 4 at the 18-DoF level)."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control.types import HybridCommand
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import whole_body as wb


def test_batched_whole_body_settle():
    params = a1_params()
    model = fb.build_model(params)
    contact = wb.ContactModel()
    batch = 4

    def init_one(h):
        s = wb.whole_body_init(params, body_height=h)
        return s

    heights = jnp.asarray([0.30, 0.32, 0.34, 0.36], jnp.float32)
    states = jax.vmap(init_one)(heights)
    cmd = HybridCommand(
        q=jnp.tile(params.stand_angles, (batch, 1)),
        kp=jnp.full((batch, 12), 100.0), dq=jnp.zeros((batch, 12)),
        kd=jnp.full((batch, 12), 2.0), tau=jnp.zeros((batch, 12)))

    def step(ss, _):
        def one(s, c):
            s2, flags = wb.whole_body_step(params, model, s, c, contact,
                                           0.002)
            return s2

        ss = jax.vmap(one)(ss, cmd)
        return ss, ss.fb.position[:, 2]

    states, hs = jax.jit(lambda s: jax.lax.scan(step, s, None, length=400))(
        states)
    h = np.asarray(hs)
    assert h.shape == (400, batch)
    assert np.all(np.isfinite(h))
    # All four scenarios settle into standing.
    assert np.all(h[-1] > 0.2) and np.all(h[-1] < 0.33)
    assert np.all(np.abs(h[-1] - h[-50]) < 0.01)
