"""core.struct: frozen pytree dataclasses with static fields and .replace."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import struct


@struct.dataclass
class _State:
    pos: jnp.ndarray
    vel: jnp.ndarray
    horizon: int = struct.field(pytree_node=False, default=10)
    gains: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.ones(3, jnp.float32))


def _state(h=10):
    return _State(pos=jnp.arange(3.0), vel=jnp.zeros(3), horizon=h)


def test_tree_roundtrip_keeps_static_fields_out_of_leaves():
    s = _state()
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == 3                 # pos, vel, gains — not horizon
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _State) and back.horizon == 10
    for a, b in zip(jax.tree.leaves(back), leaves):
        np.testing.assert_array_equal(a, b)
    # Static values live in the treedef: a different horizon is a
    # different structure (and a different jit cache key).
    assert jax.tree_util.tree_structure(_state(12)) != treedef


def test_key_paths_name_the_fields():
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(_state())[0]]
    assert paths == [".pos", ".vel", ".gains"]


def test_replace_under_jit_and_vmap():
    s = _state()

    @jax.jit
    def step(st):
        return st.replace(pos=st.pos + st.vel + 1.0)

    out = step(s)
    np.testing.assert_allclose(out.pos, np.arange(3.0) + 1.0)
    assert out.horizon == 10

    batch = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), s)
    out_b = jax.vmap(lambda st: st.replace(vel=st.pos * st.horizon))(batch)
    np.testing.assert_allclose(out_b.vel[1], 2 * np.arange(3.0) * 10)
    assert out_b.horizon == 10


def test_frozen_and_defaults():
    s = _state()
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.pos = jnp.ones(3)
    np.testing.assert_array_equal(s.gains, np.ones(3))
    assert s.replace(horizon=5).horizon == 5 and s.horizon == 10
