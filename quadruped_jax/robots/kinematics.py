"""Analytic 3-DoF leg kinematics, batched over legs and scenarios.

Capability parity with the reference's analytic leg kinematics
(quadruped/src/robots/qr_robot.cpp:106 `FootPositionInHipFrameToJointAngle`,
`FootPositionInHipFrame`, `AnalyticalLegJacobian`,
`FootPositionsInBaseFrame`, `ComputeJacobian`,
`MapContactForceToJointTorques`), re-derived in closed form for the shared
quadruped morphology: abduction about +x, hip and knee about +y, with a
signed hip link y-offset per leg.

Frames: hip frame sits at the abad joint, axes parallel to the body frame
(x forward, y left, z up). Joint vector per leg: (q_abad, q_hip, q_knee).
All functions broadcast over arbitrary leading batch axes; the per-leg axis
is explicit ([..., 4, 3]) so one call covers the whole robot.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import linalg
from quadruped_jax.robots.params import RobotParams, SIDE_SIGN


def foot_position_in_hip_frame(q: jnp.ndarray, l_hip: jnp.ndarray,
                               l_up, l_low) -> jnp.ndarray:
    """FK: [..., 3] joint angles -> [..., 3] foot position in hip frame.

    l_hip is the *signed* hip length (negative for right legs).
    """
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    s2, c2 = jnp.sin(q2), jnp.cos(q2)
    s23, c23 = jnp.sin(q2 + q3), jnp.cos(q2 + q3)
    x0 = -(l_up * s2 + l_low * s23)
    z0 = -(l_up * c2 + l_low * c23)
    x = x0
    y = c1 * l_hip - s1 * z0
    z = s1 * l_hip + c1 * z0
    return jnp.stack([x, y, z], axis=-1)


def foot_position_to_joint_angles(p: jnp.ndarray, l_hip: jnp.ndarray,
                                  l_up, l_low) -> jnp.ndarray:
    """Analytic IK: [..., 3] hip-frame foot position -> [..., 3] joint angles.

    Mirrors the reference's closed-form solution (qr_robot.cpp:106): knee from
    the law of cosines (always the bent-backward branch, q_knee <= 0), hip
    from the sagittal projection, abad from the frontal-plane geometry.
    Inputs outside the workspace are clamped, never NaN (reference has an
    explicit NaN guard at qr_swing_leg_controller.cpp:408-423; here the
    formula itself is made total).
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d2 = x * x + y * y + z * z
    # Knee angle via law of cosines on the (upper, lower) triangle.
    cos_knee = (d2 - l_hip * l_hip - l_up * l_up - l_low * l_low) / (2 * l_up * l_low)
    cos_knee = jnp.clip(cos_knee, -1.0, 1.0)
    q_knee = -jnp.arccos(cos_knee)
    # Effective sagittal leg length.
    l_eff = jnp.sqrt(jnp.maximum(
        l_up * l_up + l_low * l_low + 2 * l_up * l_low * cos_knee, 1e-9))
    # Hip pitch: x0 = -l_eff*sin(q_hip + theta) with theta the knee-bend
    # offset angle; exact for asymmetric upper/lower lengths (e.g. Lite3).
    theta = jnp.arctan2(l_low * jnp.sin(q_knee), l_up + l_low * jnp.cos(q_knee))
    q_hip = jnp.arcsin(jnp.clip(-x / l_eff, -1.0, 1.0)) - theta
    # Abad roll from frontal plane: rotate (y, z) by -q1 must land on
    # (l_hip, z0<0).
    yz = jnp.sqrt(jnp.maximum(y * y + z * z - l_hip * l_hip, 1e-9))
    q_abad = jnp.arctan2(z, y) + jnp.arctan2(yz, l_hip * jnp.ones_like(yz))
    # Wrap to (-pi, pi].
    q_abad = q_abad - 2 * jnp.pi * jnp.round(q_abad / (2 * jnp.pi))
    return jnp.stack([q_abad, q_hip, q_knee], axis=-1)


def leg_jacobian(q: jnp.ndarray, l_hip: jnp.ndarray, l_up, l_low) -> jnp.ndarray:
    """Analytic Jacobian d(foot pos in hip frame)/dq: [..., 3] -> [..., 3, 3].

    Closed form (matches the reference `AnalyticalLegJacobian`); verified
    against jax.jacfwd of `foot_position_in_hip_frame` in tests.
    """
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    s2, c2 = jnp.sin(q2), jnp.cos(q2)
    s23, c23 = jnp.sin(q2 + q3), jnp.cos(q2 + q3)
    x0 = -(l_up * s2 + l_low * s23)           # foot x
    z0 = -(l_up * c2 + l_low * c23)           # sagittal drop (<0)
    dx_dq2 = -(l_up * c2 + l_low * c23)
    dx_dq3 = -l_low * c23
    dz0_dq2 = l_up * s2 + l_low * s23
    dz0_dq3 = l_low * s23
    zero = jnp.zeros_like(q1)
    # y = c1*l_hip - s1*z0 ; z = s1*l_hip + c1*z0
    j = jnp.stack([
        jnp.stack([zero, dx_dq2, dx_dq3], axis=-1),
        jnp.stack([-s1 * l_hip - c1 * z0, -s1 * dz0_dq2, -s1 * dz0_dq3], axis=-1),
        jnp.stack([c1 * l_hip - s1 * z0, c1 * dz0_dq2, c1 * dz0_dq3], axis=-1),
    ], axis=-2)
    return j


# --- whole-robot wrappers ([..., 4, 3] legs axis) ---------------------------

def _signed_hip(params: RobotParams, like: jnp.ndarray) -> jnp.ndarray:
    return jnp.asarray(SIDE_SIGN, dtype=like.dtype) * params.hip_length


def foot_positions_in_base_frame(params: RobotParams, q: jnp.ndarray) -> jnp.ndarray:
    """[..., 12] joint angles -> [..., 4, 3] foot positions in base frame."""
    ql = q.reshape(q.shape[:-1] + (4, 3))
    l_hip = _signed_hip(params, q)
    p_hip = foot_position_in_hip_frame(
        ql, l_hip, params.upper_length, params.lower_length)
    return p_hip + params.hip_offset


def joint_angles_from_foot_positions(params: RobotParams, p_base: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 3] base-frame foot positions -> [..., 12] joint angles."""
    p_hip = p_base - params.hip_offset
    l_hip = _signed_hip(params, p_base)
    q = foot_position_to_joint_angles(
        p_hip, l_hip, params.upper_length, params.lower_length)
    return q.reshape(q.shape[:-2] + (12,))


def all_leg_jacobians(params: RobotParams, q: jnp.ndarray) -> jnp.ndarray:
    """[..., 12] joint angles -> [..., 4, 3, 3] per-leg Jacobians."""
    ql = q.reshape(q.shape[:-1] + (4, 3))
    l_hip = _signed_hip(params, q)
    return leg_jacobian(ql, l_hip, params.upper_length, params.lower_length)


def foot_velocities_in_base_frame(params: RobotParams, q: jnp.ndarray,
                                  dq: jnp.ndarray) -> jnp.ndarray:
    """[..., 12] q, dq -> [..., 4, 3] foot velocities in base frame."""
    j = all_leg_jacobians(params, q)
    dql = dq.reshape(dq.shape[:-1] + (4, 3))
    return jnp.einsum("...lij,...lj->...li", j, dql)


def damped_jacobian_solve(jac: jnp.ndarray, v: jnp.ndarray,
                          damping: float = 1e-3) -> jnp.ndarray:
    """Damped least-squares J^-1 v for [..., 3, 3] leg Jacobians.

    Near-singular configurations (fully extended leg) return bounded joint
    velocities instead of NaN — the batched analogue of the reference's NaN
    guard (qr_swing_leg_controller.cpp:408-423).
    """
    jt = jnp.swapaxes(jac, -1, -2)
    m = jac @ jt + damping * jnp.eye(3, dtype=jac.dtype)
    # Closed-form 3x3 SPD inverse (core/linalg adjugate): jnp.linalg.solve
    # takes XLA's batched LU, which is slow inside the vmapped tick scan
    # (see sim/srb_sim.py).
    return jnp.einsum("...ij,...j->...i", jt,
                      jnp.einsum("...ij,...j->...i", linalg.inv_spd(m), v))


def map_contact_forces_to_torques(params: RobotParams, q: jnp.ndarray,
                                  forces_base: jnp.ndarray) -> jnp.ndarray:
    """tau = J^T f per leg (reference `MapContactForceToJointTorques`).

    forces_base: [..., 4, 3] contact forces on the feet, base frame
    (forces the *foot applies to the ground* are the negative; this takes the
    reaction convention used by the stance controllers: tau = J^T (-f_ground),
    with the caller handling the sign as the reference does).
    Returns [..., 12] joint torques.
    """
    j = all_leg_jacobians(params, q)
    tau = jnp.einsum("...lji,...lj->...li", j, forces_base)
    return tau.reshape(tau.shape[:-2] + (12,))


def estimate_foot_forces_from_torques(params: RobotParams, q: jnp.ndarray,
                                      tau: jnp.ndarray,
                                      damping: float = 1e-4) -> jnp.ndarray:
    """Per-leg contact force estimated from measured joint torques:
    F = J^{-T} tau (reference `qrRobot::ComputeMoment`, qr_robot.cpp:74-85,
    which runs every tick in `UpdateDataFlow`).

    The reference uses a raw 3x3 inverse; here the transpose system is
    solved damped so fully-extended legs return bounded forces instead of
    NaN (same policy as damped_jacobian_solve). tau: [..., 12].
    Returns [..., 4, 3] base-frame forces.
    """
    j = all_leg_jacobians(params, q)                        # [..., 4, 3, 3]
    taul = tau.reshape(tau.shape[:-1] + (4, 3))
    # Solve J^T F = tau  <=>  damped LS on J^T.
    return damped_jacobian_solve(jnp.swapaxes(j, -1, -2), taul, damping)


def estimate_moment(params: RobotParams, q: jnp.ndarray,
                    tau: jnp.ndarray) -> jnp.ndarray:
    """Reference `ComputeMoment` body (qr_robot.cpp:76-85): the net foot
    moment Sum_l p_l x F_l, normalized elementwise by the summed estimated
    foot force (the reference's cwiseQuotient — a lever-arm estimate, not a
    physical torque). Returns [..., 3]."""
    f = estimate_foot_forces_from_torques(params, q, tau)   # [..., 4, 3]
    p = foot_positions_in_base_frame(params, q)             # [..., 4, 3]
    moment = jnp.sum(jnp.cross(p, f), axis=-2)
    fsum = jnp.sum(f, axis=-2)
    # Denominator clamped to a physically meaningful floor (1 N): the
    # reference divides by the raw sum and explodes near zero force; a
    # tiny-eps guard merely moves the explosion to ~1e6. Below 1 N the
    # lever-arm estimate is meaningless anyway, so saturate instead.
    sign = jnp.where(fsum < 0, -1.0, 1.0)
    denom = sign * jnp.maximum(jnp.abs(fsum), 1.0)
    return moment / denom
