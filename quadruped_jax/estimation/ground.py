"""Ground-surface estimator: plane fit through stance feet + control frame.

Capability parity with `qrGroundSurfaceEstimator`
(quadruped/src/estimators/qr_ground_surface_estimator.cpp:40-210): on
four-contact touch-down events, least-squares fit the plane
z = a0 + a1 x + a2 y through the four base-frame foot positions, derive the
surface normal, and maintain the "control frame" — a yaw-aligned frame whose
z axis matches the (low-passed, factor 0.8) ground normal, used by the
stance controllers on slopes. Terrain typing (plane/slope/stairs/gaps from
terrain.yaml) lives in sim/terrain.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import linalg, se3
from quadruped_jax.core import struct

RPY_LOWPASS = 0.8


@struct.dataclass
class GroundEstimatorState:
    plane_coefs: jnp.ndarray       # [3] (a0, a1, a2) in base frame
    normal_world: jnp.ndarray      # [3]
    control_rpy: jnp.ndarray       # [3] low-passed ground orientation
    ground_rot: jnp.ndarray        # [3, 3] world->control ("groundRMat")
    base_r_in_control: jnp.ndarray  # [3, 3]
    last_contact: jnp.ndarray      # [4]


def ground_estimator_init() -> GroundEstimatorState:
    return GroundEstimatorState(
        plane_coefs=jnp.zeros(3, jnp.float32),
        normal_world=jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
        control_rpy=jnp.zeros(3, jnp.float32),
        ground_rot=jnp.eye(3, dtype=jnp.float32),
        base_r_in_control=jnp.eye(3, dtype=jnp.float32),
        last_contact=jnp.zeros(4, jnp.float32),
    )


def fit_plane(foot_positions: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 3] base-frame feet -> [..., 3] (a0, a1, a2) for
    z = a0 + a1 x + a2 y (least squares over the 4 feet)."""
    ones = jnp.ones_like(foot_positions[..., 0:1])
    w = jnp.concatenate([ones, foot_positions[..., 0:1],
                         foot_positions[..., 1:2]], axis=-1)  # [..., 4, 3]
    wt = jnp.swapaxes(w, -1, -2)
    ww = wt @ w
    rhs = jnp.einsum("...ij,...i->...j", w, foot_positions[..., 2])
    # 3x3 SPD normal equations: closed-form inverse, not XLA's batched LU
    # (slow inside tick scans — see sim/srb_sim.py).
    return jnp.einsum("...ij,...j->...i", linalg.inv_spd(ww), rhs)


def ground_estimator_update(state: GroundEstimatorState,
                            foot_positions_base: jnp.ndarray,  # [4, 3]
                            contact: jnp.ndarray,              # [4]
                            quat: jnp.ndarray) -> GroundEstimatorState:
    """One tick; refits only on 4-contact touch-down events (:40-70)."""
    new_touch = jnp.max(contact * (1.0 - state.last_contact))
    all_contact = jnp.sum(contact) > 3.5
    should_update = (new_touch > 0.5) & all_contact

    coefs = fit_plane(foot_positions_base)
    coefs = jnp.where(should_update, coefs, state.plane_coefs)

    # Normal in base frame: normalize([-a1, -a2, 1]); rotate to world.
    r = se3.quat_to_rotmat(quat)
    n_base = jnp.stack([-coefs[1], -coefs[2], jnp.ones_like(coefs[0])])
    n_base = n_base / jnp.linalg.norm(n_base)
    n_world = r @ n_base
    n_world = jnp.where(n_world[2] < 0, -n_world, n_world)
    n_world = jnp.where(should_update, n_world, state.normal_world)

    # Control frame: yaw from base, roll/pitch from the ground normal,
    # low-passed (ComputeControlFrame :163-210).
    yaw = se3.quat_to_rpy(quat)[2]
    pitch_g = jnp.arctan2(n_world[0] * jnp.cos(yaw) + n_world[1] * jnp.sin(yaw),
                          n_world[2])
    roll_g = jnp.arctan2(n_world[1] * jnp.cos(yaw) - n_world[0] * jnp.sin(yaw),
                         n_world[2])
    target_rpy = jnp.stack([-roll_g, pitch_g, yaw])
    control_rpy = RPY_LOWPASS * state.control_rpy \
        + (1 - RPY_LOWPASS) * target_rpy
    ground_rot = se3.rpy_to_rotmat(control_rpy)
    base_r_in_control = ground_rot.T @ r
    return GroundEstimatorState(
        plane_coefs=coefs, normal_world=n_world, control_rpy=control_rpy,
        ground_rot=ground_rot, base_r_in_control=base_r_in_control,
        last_contact=contact)


def height_in_plane(coefs: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """z of the fitted plane at base-frame (x, y) (GetZInControlFrame)."""
    return coefs[..., 0] + coefs[..., 1] * xy[..., 0] + coefs[..., 2] * xy[..., 1]
