"""Checkpoint/resume for long batched rollouts.

The reference has no checkpointing at all — its control loop is stateless
between boots and a crash means re-running Gazebo from StandUp
(SURVEY.md §5 "Checkpoint / resume: None"). At fleet scale that is not
acceptable: a terrain/command grid sweep is hours of device time, so the
engine checkpoints the exact scan carry (`sim.rollout.RolloutCarry`)
between segments and resumes bitwise-exactly (segmenting a scan does not
change its arithmetic — tests/test_checkpoint.py).

Format: one `.npz` per checkpoint, leaves keyed by their pytree key-path
string (`jax.tree_util.keystr`). No pickle anywhere — restoring requires a
template pytree (`like`) with the same structure, so a checkpoint can never
smuggle objects, and structure mismatches fail loudly with the offending
key paths. Writes are atomic (temp file + os.replace) so a crash mid-write
never corrupts the latest good checkpoint.
"""

from __future__ import annotations

import os
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _flatten(tree):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in leaves}, \
        treedef


def save(path: str, tree) -> None:
    """Atomically write `tree`'s leaves to `path` (.npz, key-path keyed)."""
    named, _ = _flatten(tree)
    arrays = {k: np.asarray(v) for k, v in named.items()}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def restore(path: str, like):
    """Load a checkpoint written by `save` into the structure of `like`.

    `like` supplies the pytree structure AND leaf shapes/dtypes; its leaf
    values are ignored. Raises KeyError listing missing/extra key paths,
    or ValueError on any shape/dtype mismatch — catching the
    resumed-the-wrong-sweep mistake up front instead of deep inside jit.
    """
    named, treedef = _flatten(like)
    with np.load(path) as data:
        saved_keys = set(data.files)
        want_keys = set(named.keys())
        if saved_keys != want_keys:
            raise KeyError(
                f"checkpoint {path} does not match template: "
                f"missing={sorted(want_keys - saved_keys)} "
                f"extra={sorted(saved_keys - want_keys)}")
        bad = []
        for k, tmpl in named.items():
            want = jnp.asarray(tmpl)
            got = data[k]
            if tuple(got.shape) != tuple(want.shape) \
                    or got.dtype != want.dtype:
                bad.append(f"{k}: saved {got.dtype}{got.shape} "
                           f"!= template {want.dtype}{tuple(want.shape)}")
        if bad:
            raise ValueError(
                f"checkpoint {path} shape/dtype mismatch (different batch "
                f"size, config, or command?):\n  " + "\n  ".join(bad))
        leaves = [jnp.asarray(data[k]) for k in named.keys()]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:012d}.npz")


def latest(directory: str):
    """(path, step) of the newest checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(directory, name), step)
    return best


def checkpointed_rollout(config, params, cmd, total_steps: int,
                         segment_steps: int, directory: str,
                         control_dt: float = 0.002, *,
                         keep: int = 2):
    """Run a (batched) closed-loop rollout in checkpointed segments.

    Resumes from the newest checkpoint in `directory` if one exists (the
    elastic-recovery path: just re-invoke after a crash), otherwise starts
    fresh. Returns the final `RolloutCarry` plus the last segment's
    `RolloutResult` (traces of earlier segments live in their checkpoints'
    epochs, not in memory). `keep` bounds how many old checkpoints are
    retained.
    """
    from quadruped_jax.sim.rollout import rollout_init, rollout_segment

    if total_steps % segment_steps != 0:
        raise ValueError("total_steps must be a multiple of segment_steps "
                         "(segments are one fixed-shape compiled scan)")
    carry = rollout_init(config, params)
    resumed = latest(directory)
    if resumed is not None:
        carry = restore(resumed[0], carry)
    segment = jax.jit(
        lambda c: rollout_segment(config, params, cmd, c, segment_steps,
                                  control_dt))
    result = None
    while int(carry.step) < total_steps:
        carry, result = segment(carry)
        jax.block_until_ready(carry)
        save(checkpoint_path(directory, int(carry.step)), carry)
        if keep > 0:
            names = sorted(n for n in os.listdir(directory)
                           if _CKPT_RE.match(n))
            for stale in names[:-keep]:
                os.remove(os.path.join(directory, stale))
    return carry, result
