"""Checkpoint/resume (utils/checkpoint.py): exactness and crash recovery.

The reference has no checkpointing (SURVEY.md §5); these tests pin the
guarantees our replacement makes: segmenting a rollout is bitwise-exact,
save/restore round-trips the carry, and re-invoking after an interrupted
sweep resumes instead of restarting.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim.rollout import rollout, rollout_init, rollout_segment
from quadruped_jax.utils import checkpoint as ckpt


def _config():
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=12),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT())


def _tree_equal(a, b):
    return all(bool(jnp.all(x == y))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    carry = rollout_init(_config(), a1_params())
    path = str(tmp_path / "c.npz")
    ckpt.save(path, carry)
    back = ckpt.restore(path, jax.tree.map(jnp.zeros_like, carry))
    assert _tree_equal(carry, back)
    assert back.step.dtype == jnp.int32


def test_restore_rejects_structure_mismatch(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": jnp.ones(3)})
    with pytest.raises(KeyError):
        ckpt.restore(path, {"a": jnp.zeros(3), "b": jnp.zeros(1)})


def test_segments_match_single_rollout():
    """One-shot vs segmented rollout.

    Since the boot cold-start solve landed in locomotion_init
    (mpc_cold_start), rollout_init carries real compute; XLA fuses it
    differently when inlined into jit(rollout) than when compiled
    standalone, so cross-GRAPH equality is roundoff-tight rather than
    bitwise (~1e-5 after 80 ticks). Bitwise exactness within the SAME
    graph — resume-from-checkpoint vs uninterrupted segmented run — is
    what checkpointing needs and is pinned below and in
    test_checkpointed_rollout_resumes_after_interrupt."""
    config, params = _config(), a1_params()
    cmd = TwistCommand.constant(vx=0.3, body_height=0.27)
    whole = jax.jit(lambda: rollout(config, params, cmd, steps=80))()
    carry0 = rollout_init(config, params)
    seg = jax.jit(lambda c: rollout_segment(config, params, cmd, c, 40))
    carry, _ = seg(carry0)
    carry, last = seg(carry)
    assert int(carry.step) == 80
    np.testing.assert_allclose(np.asarray(whole.sim.position),
                               np.asarray(carry.sim.position), atol=1e-3)
    np.testing.assert_allclose(np.asarray(whole.base_height_trace[-40:]),
                               np.asarray(last.base_height_trace),
                               atol=1e-3)
    assert float(whole.alive) == float(1.0 - carry.dead)

    # Same-graph bitwise exactness: re-running the segmented path from the
    # same carry reproduces it exactly.
    carry_b, _ = seg(carry0)
    carry_b, last_b = seg(carry_b)
    np.testing.assert_array_equal(np.asarray(last.base_height_trace),
                                  np.asarray(last_b.base_height_trace))
    assert _tree_equal(carry.sim, carry_b.sim)


def test_checkpointed_rollout_resumes_after_interrupt(tmp_path):
    config, params = _config(), a1_params()
    cmd = TwistCommand.constant(vx=0.3, body_height=0.27)
    d = str(tmp_path / "ckpts")
    # "Crash" after the first 2 of 4 segments...
    ckpt.checkpointed_rollout(config, params, cmd, total_steps=40,
                              segment_steps=20, directory=d)
    assert ckpt.latest(d)[1] == 40
    # ...then re-invoke asking for the full sweep: it must resume at 40.
    carry, _ = ckpt.checkpointed_rollout(config, params, cmd,
                                         total_steps=80, segment_steps=20,
                                         directory=d)
    assert int(carry.step) == 80
    # Equal to an uninterrupted SEGMENTED run (bitwise — same graph), and
    # within cross-graph roundoff of the one-shot rollout (see
    # test_segments_match_single_rollout for why those differ).
    carry_u = rollout_init(config, params)
    seg = jax.jit(lambda c: rollout_segment(config, params, cmd, c, 20))
    for _ in range(4):
        carry_u, _ = seg(carry_u)
    np.testing.assert_array_equal(np.asarray(carry_u.sim.position),
                                  np.asarray(carry.sim.position))
    whole = jax.jit(lambda: rollout(config, params, cmd, steps=80))()
    np.testing.assert_allclose(np.asarray(whole.sim.position),
                               np.asarray(carry.sim.position), atol=1e-3)
    # Retention: only `keep` newest checkpoints remain.
    names = sorted(os.listdir(d))
    assert len(names) == 2 and names[-1].endswith("80.npz".rjust(16, "0"))


def test_total_steps_must_divide():
    with pytest.raises(ValueError):
        ckpt.checkpointed_rollout(_config(), a1_params(),
                                  TwistCommand.constant(vx=0.0),
                                  total_steps=50, segment_steps=20,
                                  directory="/tmp/unused")


def test_restore_rejects_shape_mismatch(tmp_path):
    """ADVICE r2: resuming with a different batch shape/config must fail
    loudly at restore time, not deep inside jit."""
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": jnp.ones((3, 4))})
    with pytest.raises(ValueError, match="shape/dtype"):
        ckpt.restore(path, {"a": jnp.zeros((5, 4))})
    with pytest.raises(ValueError, match="shape/dtype"):
        ckpt.restore(path, {"a": jnp.zeros((3, 4), jnp.int32)})
