"""CMU/A1-lineage 18-state Kalman filter (position + velocity + foot odometry).

Capability parity with the reference's dormant `CMUInitState`/`CMUUpdate`
(quadruped/src/estimators/qr_robot_estimator.cpp:108-269; the reference keeps
it compiled but never wires its outputs — we expose it as an OPTIONAL
estimator, off by default, matching that status).

State (world frame, 18):
    x = [p(3), v(3), p_foot_FR(3), p_foot_FL(3), p_foot_RR(3), p_foot_RL(3)]

Process: constant-velocity base driven by the IMU specific force
(u = R a_body + g), random-walk foot positions whose process noise is gated
by a per-leg contact probability (stance feet are pinned, swing feet float).

Measurements (28):
    [0:12)   per-leg foot position relative to base, from leg FK:  p_f - p
    [12:24)  per-leg base velocity from stance-leg kinematics:
             -R (v_foot_body + omega x p_foot_body)
    [24:28)  stance-foot height z = 0 (flat-ground assumption, optional)

Contact gating follows the reference exactly: measurement/process variances
for leg i scale by (1 + (1 - c_i) * 1e3) with c_i = clip((f_i + 20)/100, 0, 1)
from the foot force sensor, and swing legs observe the filter's own
prediction (zero-information residual) instead of kinematics.

Batching notes: the whole update is fixed-shape dense linear algebra
([18,18] / [28,18] / [28,28]) — one `jnp.linalg.solve` on the innovation
covariance per tick, fully batchable with `vmap` over scenarios. C/A/B are
static module constants; only the noise diagonals are data-dependent.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from quadruped_jax.core import se3
from quadruped_jax.core import struct
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams

NX = 18
NZ = 28
_GRAV = np.asarray([0.0, 0.0, -9.81], np.float32)

# Reference noise constants (qr_robot_estimator.h "CMU parameters").
PROCESS_NOISE_PIMU = 0.01
PROCESS_NOISE_VIMU = 0.01
PROCESS_NOISE_PFOOT = 0.01
SENSOR_NOISE_PIMU_REL_FOOT = 0.001
SENSOR_NOISE_VIMU_REL_FOOT = 0.1
SENSOR_NOISE_ZFOOT = 0.001
SWING_GATE = 1e3  # variance multiplier on non-contact legs


def _build_c() -> np.ndarray:
    """Static [28, 18] observation matrix (reference CMUInitState)."""
    c = np.zeros((NZ, NX), np.float32)
    eye3 = np.eye(3, dtype=np.float32)
    for i in range(4):
        c[i * 3:i * 3 + 3, 0:3] = -eye3             # -p
        c[i * 3:i * 3 + 3, 6 + i * 3:9 + i * 3] = eye3  # + p_foot
        c[12 + i * 3:15 + i * 3, 3:6] = eye3        # v
        c[24 + i, 6 + i * 3 + 2] = 1.0              # foot z
    return c


_C = jnp.asarray(_build_c())


@struct.dataclass
class CmuKfConfig:
    assume_flat_ground: bool = struct.field(pytree_node=False, default=True)


@struct.dataclass
class CmuKfState:
    x: jnp.ndarray    # [18]
    cov: jnp.ndarray  # [18, 18]


def contact_probability(foot_force: jnp.ndarray) -> jnp.ndarray:
    """clip((f + 20) / 100, 0, 1) — the reference's force->contact ramp."""
    return jnp.clip((foot_force + 20.0) / 100.0, 0.0, 1.0)


def cmu_kf_init(
    params: RobotParams,
    *,
    quat: jnp.ndarray,          # [4]
    joint_angles: jnp.ndarray,  # [12]
    base_height: float = 0.27,
) -> CmuKfState:
    """Seed base at (0, 0, h) and feet from FK (reference CMUInitState)."""
    r = se3.quat_to_rotmat(quat)
    p0 = jnp.asarray([0.0, 0.0, base_height], jnp.float32)
    feet_base = kinematics.foot_positions_in_base_frame(params, joint_angles)
    feet_world = jnp.einsum("ij,lj->li", r, feet_base) + p0
    x = jnp.concatenate([p0, jnp.zeros(3, jnp.float32),
                         feet_world.reshape(12)])
    return CmuKfState(x=x, cov=3.0 * jnp.eye(NX, dtype=jnp.float32))


def cmu_kf_update(
    config: CmuKfConfig,
    params: RobotParams,
    state: CmuKfState,
    *,
    acc_body: jnp.ndarray,          # [3] IMU linear acceleration (body)
    quat: jnp.ndarray,              # [4]
    omega_body: jnp.ndarray,        # [3]
    joint_angles: jnp.ndarray,      # [12]
    joint_velocities: jnp.ndarray,  # [12]
    foot_force: jnp.ndarray,        # [4] vertical foot forces (N)
    dt,
) -> CmuKfState:
    dtype = state.x.dtype
    r = se3.quat_to_rotmat(quat)
    contact = contact_probability(foot_force).astype(dtype)
    gate = 1.0 + (1.0 - contact) * SWING_GATE  # [4]

    # A, B with the live dt; u = R a + g.
    a_mat = jnp.eye(NX, dtype=dtype).at[0:3, 3:6].set(
        dt * jnp.eye(3, dtype=dtype))
    u = r @ acc_body + jnp.asarray(_GRAV, dtype)
    xbar = a_mat @ state.x
    xbar = xbar.at[3:6].add(dt * u)

    # Process noise (reference CMUUpdate gains).
    q_diag = jnp.concatenate([
        jnp.full((3,), PROCESS_NOISE_PIMU * dt / 20.0, dtype),
        jnp.full((3,), PROCESS_NOISE_VIMU * dt * 9.8 / 20.0, dtype),
        jnp.repeat(gate * (dt * PROCESS_NOISE_PFOOT), 3),
    ])
    cov_bar = a_mat @ state.cov @ a_mat.T + jnp.diag(q_diag)

    # Measurements.
    feet_base = kinematics.foot_positions_in_base_frame(params, joint_angles)
    vfeet_base = kinematics.foot_velocities_in_base_frame(
        params, joint_angles, joint_velocities)
    fk_world = jnp.einsum("ij,lj->li", r, feet_base)        # [4, 3]
    leg_v = -vfeet_base - jnp.cross(
        jnp.broadcast_to(omega_body, (4, 3)), feet_base)
    v_kin_world = jnp.einsum("ij,lj->li", r, leg_v)          # [4, 3]
    # Swing legs observe the prediction itself (no-information residual).
    v_obs = contact[:, None] * v_kin_world \
        + (1.0 - contact[:, None]) * xbar[3:6]
    z_obs = (1.0 - contact) * (xbar[2] + fk_world[:, 2])     # foot z
    y = jnp.concatenate([fk_world.reshape(12), v_obs.reshape(12), z_obs])

    r_diag = jnp.concatenate([
        jnp.repeat(gate * SENSOR_NOISE_PIMU_REL_FOOT, 3),
        jnp.repeat(gate * SENSOR_NOISE_VIMU_REL_FOOT, 3),
        (gate * SENSOR_NOISE_ZFOOT if config.assume_flat_ground
         else jnp.full((4,), 1e5, dtype)),
    ])

    # Kalman update via one solve on the innovation covariance.
    s = _C @ cov_bar @ _C.T + jnp.diag(r_diag)
    s = 0.5 * (s + s.T)
    resid = y - _C @ xbar
    pct = cov_bar @ _C.T                       # [18, 28]
    x_new = xbar + pct @ jnp.linalg.solve(s, resid)
    cov_new = cov_bar - pct @ jnp.linalg.solve(s, _C) @ cov_bar
    cov_new = 0.5 * (cov_new + cov_new.T)

    # Reference's xy-drift reduction: when planar-position variance grows,
    # decouple it from the rest and shrink it (branch -> smooth mask).
    det_xy = (cov_new[0, 0] * cov_new[1, 1]
              - cov_new[0, 1] * cov_new[1, 0])
    reduce_mask = (det_xy > 1e-6).astype(dtype)
    keep = jnp.ones((NX, NX), dtype)
    keep = keep.at[0:2, 2:].set(0.0).at[2:, 0:2].set(0.0)
    keep = keep.at[0:2, 0:2].set(0.1)
    keep = keep.at[2:, 2:].set(1.0)
    cov_reduced = cov_new * keep
    cov_new = reduce_mask * cov_reduced + (1.0 - reduce_mask) * cov_new

    return CmuKfState(x=x_new, cov=cov_new)


def base_position(state: CmuKfState) -> jnp.ndarray:
    return state.x[..., 0:3]


def base_velocity_world(state: CmuKfState) -> jnp.ndarray:
    return state.x[..., 3:6]


def foot_positions_world(state: CmuKfState) -> jnp.ndarray:
    return state.x[..., 6:18].reshape(state.x.shape[:-1] + (4, 3))
