"""CoM adjuster for position-mode locomotion, batched.

Capability parity with `qrComAdjuster`
(quadruped/src/planner/qr_com_adjuster.cpp:61-110): contact-probability
weights per leg via erf windows on the gait phase, a virtual support polygon
blending each foot toward its clockwise/counter-clockwise neighbors by those
weights, and the desired CoM in base frame as the polygon centroid — the
static-stability shift the position-mode stance controller tracks.

Leg adjacency (reference ADJEST_LEG, leg order FR FL RR RL):
  FR: cw=FL, ccw=RR;  FL: cw=RL, ccw=FR;  RR: cw=FR, ccw=RL;  RL: cw=RR, ccw=FL
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.special as sps

from quadruped_jax.gait.scheduler import GaitState, LegState

DELTA = 0.1
CW = (1, 3, 0, 2)    # clockwise neighbor per leg
CCW = (2, 0, 3, 1)   # counter-clockwise neighbor per leg


def contact_weights(gait_state: GaitState) -> jnp.ndarray:
    """[..., 4] erf-window contact probability (Update :67-80)."""
    phi = gait_state.normalized_phase
    s = DELTA * jnp.sqrt(2.0)
    stance_like = ((gait_state.leg_state == LegState.STANCE)
                   | (gait_state.leg_state == LegState.LOSE_CONTACT))
    contact_k = 0.5 * (sps.erf(phi / s) + sps.erf((1.0 - phi) / s))
    swing_k = 0.5 * (2.0 + sps.erf(-phi / s) + sps.erf((phi - 1.0) / s))
    return jnp.where(stance_like, contact_k, swing_k)


def com_position_in_base_frame(gait_state: GaitState,
                               foot_positions_base: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] desired CoM shift (Update :82-108)."""
    w = contact_weights(gait_state)                 # [..., 4]
    p = foot_positions_base                          # [..., 4, 3]
    cw = jnp.asarray(CW)
    ccw = jnp.asarray(CCW)
    p_cw = p[..., cw, :]
    p_ccw = p[..., ccw, :]
    w_cw = w[..., cw]
    w_ccw = w[..., ccw]
    phi = w[..., None]
    # Virtual points blend each foot toward its neighbors by its own weight.
    v_cw = phi * p + (1 - phi) * p_cw
    v_ccw = phi * p + (1 - phi) * p_ccw
    denom = (w + w_cw + w_ccw)[..., None]
    vertices = (phi * p + w_ccw[..., None] * v_ccw
                + w_cw[..., None] * v_cw) / jnp.maximum(denom, 1e-6)
    return jnp.mean(vertices, axis=-2)
