"""Stateless-functional signal filters.

Replaces the reference's `qrMovingWindowFilter` (Neumaier-compensated moving
average, quadruped/include/quadruped/estimators/qr_moving_window_filter.hpp)
and the first-order low-passes sprinkled through the controllers
(e.g. qr_desired_state_command.cpp:164-265) with explicit-state pure
functions, so filter state lives in the batched control-state pytree and the
whole loop stays jit/vmap/scan friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MovingWindowState(NamedTuple):
    """Ring buffer state for a moving-window mean over axis 0 of `buf`.

    buf:   [window, ...] samples (initialized to the first sample or zeros)
    idx:   [] int32 next write position
    count: [] int32 number of valid samples (saturates at window)
    """

    buf: jnp.ndarray
    idx: jnp.ndarray
    count: jnp.ndarray


def moving_window_init(window: int, sample_shape, dtype=jnp.float32) -> MovingWindowState:
    return MovingWindowState(
        buf=jnp.zeros((window,) + tuple(sample_shape), dtype),
        idx=jnp.zeros((), jnp.int32),
        count=jnp.zeros((), jnp.int32),
    )


def moving_window_update(state: MovingWindowState, x: jnp.ndarray):
    """Push a sample; returns (new_state, windowed mean).

    The reference uses a Neumaier-compensated running sum for O(1) updates;
    on an accelerator a dense mean over the (small, static) window vectorizes and
    is exactly compensated by construction.
    """
    window = state.buf.shape[0]
    buf = state.buf.at[state.idx].set(x)
    idx = (state.idx + 1) % window
    count = jnp.minimum(state.count + 1, window)
    # Mean over valid entries only (before the window fills up).
    denom = jnp.maximum(count, 1).astype(buf.dtype)
    mean = jnp.sum(buf, axis=0) / denom
    return MovingWindowState(buf, idx, count), mean


def low_pass(prev: jnp.ndarray, x: jnp.ndarray, alpha) -> jnp.ndarray:
    """First-order low-pass: alpha*prev + (1-alpha)*x (reference's command
    smoothing in qr_desired_state_command.cpp)."""
    return alpha * prev + (1.0 - alpha) * x
