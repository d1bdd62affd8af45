"""SE(3)/SO(3) math as pure batched JAX ops.

Capability parity with the reference's `robotics::math` utilities
(reference: quadruped/include/quadruped/utils/qr_se3.h:72-300) — quaternion /
RPY / rotation-matrix conversions, skew operators, coordinate rotations —
re-designed as shape-polymorphic functions that broadcast over arbitrary
leading batch axes so the whole control stack can be vmapped/sharded.

Conventions:
  * Quaternions are (w, x, y, z), unit norm.
  * RPY is intrinsic Z-Y-X yaw-pitch-roll stored as (roll, pitch, yaw);
    `rpy_to_rotmat(rpy) = Rz(yaw) @ Ry(pitch) @ Rx(roll)` maps body -> world.
  * All functions are f32-polymorphic and jit/vmap-safe (no data-dependent
    control flow).
"""

from __future__ import annotations

import jax.numpy as jnp


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] cross-product matrix: skew(v) @ u == v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = [
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices.

    Batched tiny inverses through `jnp.linalg.inv` take XLA's LU path,
    a sequential micro-loop per matrix; the cofactor formula is nine FMAs and
    a divide, exact in f32 up to roundoff.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    co_d = f * g - d * i
    co_e = a * i - c * g
    co_f = c * d - a * f
    co_g = d * h - e * g
    co_h = b * g - a * h
    co_i = a * e - b * d
    det = a * co_a + b * co_d + c * co_g
    rows = [
        jnp.stack([co_a, co_b, co_c], axis=-1),
        jnp.stack([co_d, co_e, co_f], axis=-1),
        jnp.stack([co_g, co_h, co_i], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) / det[..., None, None]


def unskew(m: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3]; inverse of `skew` (antisymmetric part)."""
    return jnp.stack(
        [m[..., 2, 1] - m[..., 1, 2],
         m[..., 0, 2] - m[..., 2, 0],
         m[..., 1, 0] - m[..., 0, 1]],
        axis=-1,
    ) * 0.5


def rot_x(theta: jnp.ndarray) -> jnp.ndarray:
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero, one = jnp.zeros_like(c), jnp.ones_like(c)
    rows = [
        jnp.stack([one, zero, zero], axis=-1),
        jnp.stack([zero, c, -s], axis=-1),
        jnp.stack([zero, s, c], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rot_y(theta: jnp.ndarray) -> jnp.ndarray:
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero, one = jnp.zeros_like(c), jnp.ones_like(c)
    rows = [
        jnp.stack([c, zero, s], axis=-1),
        jnp.stack([zero, one, zero], axis=-1),
        jnp.stack([-s, zero, c], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rot_z(theta: jnp.ndarray) -> jnp.ndarray:
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero, one = jnp.zeros_like(c), jnp.ones_like(c)
    rows = [
        jnp.stack([c, -s, zero], axis=-1),
        jnp.stack([s, c, zero], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def matmul3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched product of small matrices, elementwise.

    XLA lowers batched [..., 3, 3] `@` to dot kernels padded to
    matrix-unit tiles, far off roofline for 3x3 operands. Broadcasting +
    a 3-length reduction is elementwise and fuses with neighbours. Use
    for any m,k,n <= ~8 matrices on the hot
    path; plain `@` is fine for 13x13 and larger.
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def rpy_to_rotmat(rpy: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] (roll, pitch, yaw) -> [..., 3, 3] body->world rotation.

    Closed-form Rz(yaw) Ry(pitch) Rx(roll) — identical to the matrix chain
    but elementwise (no batched tiny matmuls; see `matmul3`).
    """
    cr, sr = jnp.cos(rpy[..., 0]), jnp.sin(rpy[..., 0])
    cp, sp = jnp.cos(rpy[..., 1]), jnp.sin(rpy[..., 1])
    cy, sy = jnp.cos(rpy[..., 2]), jnp.sin(rpy[..., 2])
    rows = [
        jnp.stack([cy * cp, cy * sp * sr - sy * cr,
                   cy * sp * cr + sy * sr], axis=-1),
        jnp.stack([sy * cp, sy * sp * sr + cy * cr,
                   sy * sp * cr - cy * sr], axis=-1),
        jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotmat_to_rpy(r: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3] (roll, pitch, yaw); pitch in (-pi/2, pi/2)."""
    roll = jnp.arctan2(r[..., 2, 1], r[..., 2, 2])
    pitch = jnp.arctan2(-r[..., 2, 0],
                        jnp.sqrt(r[..., 2, 1] ** 2 + r[..., 2, 2] ** 2))
    yaw = jnp.arctan2(r[..., 1, 0], r[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] (w, x, y, z) unit quaternion -> [..., 3, 3] rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    rows = [
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotmat_to_quat(r: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), branch-free Shepperd variant.

    Computes all four candidate quaternions and selects per-element by the
    largest pivot, so it is vmap/jit safe and numerically stable for any
    rotation (no data-dependent branching).
    """
    m00, m11, m22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    # Four pivot magnitudes (4q_i^2 = 1 + 2 m_ii - tr, 4q_w^2 = 1 + tr).
    qw2 = jnp.maximum(1.0 + tr, 0.0)
    qx2 = jnp.maximum(1.0 + 2 * m00 - tr, 0.0)
    qy2 = jnp.maximum(1.0 + 2 * m11 - tr, 0.0)
    qz2 = jnp.maximum(1.0 + 2 * m22 - tr, 0.0)

    def safe_div(a, b):
        return a / jnp.maximum(b, 1e-12)

    sw = jnp.sqrt(qw2)
    sx = jnp.sqrt(qx2)
    sy = jnp.sqrt(qy2)
    sz = jnp.sqrt(qz2)

    # Candidate from w pivot.
    cw = jnp.stack([
        0.5 * sw,
        safe_div(r[..., 2, 1] - r[..., 1, 2], 2 * sw),
        safe_div(r[..., 0, 2] - r[..., 2, 0], 2 * sw),
        safe_div(r[..., 1, 0] - r[..., 0, 1], 2 * sw),
    ], axis=-1)
    cx = jnp.stack([
        safe_div(r[..., 2, 1] - r[..., 1, 2], 2 * sx),
        0.5 * sx,
        safe_div(r[..., 0, 1] + r[..., 1, 0], 2 * sx),
        safe_div(r[..., 0, 2] + r[..., 2, 0], 2 * sx),
    ], axis=-1)
    cy = jnp.stack([
        safe_div(r[..., 0, 2] - r[..., 2, 0], 2 * sy),
        safe_div(r[..., 0, 1] + r[..., 1, 0], 2 * sy),
        0.5 * sy,
        safe_div(r[..., 1, 2] + r[..., 2, 1], 2 * sy),
    ], axis=-1)
    cz = jnp.stack([
        safe_div(r[..., 1, 0] - r[..., 0, 1], 2 * sz),
        safe_div(r[..., 0, 2] + r[..., 2, 0], 2 * sz),
        safe_div(r[..., 1, 2] + r[..., 2, 1], 2 * sz),
        0.5 * sz,
    ], axis=-1)

    pivots = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([cw, cx, cy, cz], axis=-2)  # [..., 4cand, 4]
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)
    q = q[..., 0, :]
    # Canonicalize sign (w >= 0) and normalize.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rpy(q: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] -> [..., 3] (roll, pitch, yaw).

    Same convention as the reference `quatToRPY` (qr_se3.h:210).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = jnp.clip(2 * (w * y - x * z), -1.0, 1.0)
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = jnp.arcsin(as_)
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def rpy_to_quat(rpy: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 4] (w, x, y, z)."""
    half = rpy * 0.5
    cr, cp, cy = jnp.cos(half[..., 0]), jnp.cos(half[..., 1]), jnp.cos(half[..., 2])
    sr, sp, sy = jnp.sin(half[..., 0]), jnp.sin(half[..., 1]), jnp.sin(half[..., 2])
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return jnp.stack([w, x, y, z], axis=-1)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of (w, x, y, z) quaternions, broadcasting."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate [..., 3] vector(s) by quaternion(s) q (body->world)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_integrate(q: jnp.ndarray, omega: jnp.ndarray, dt) -> jnp.ndarray:
    """Integrate body-frame angular velocity over dt: q' = q * exp(omega dt/2).

    Exact exponential-map update (not a first-order Euler step), used by the
    SRB/whole-body simulators.
    """
    angle = jnp.linalg.norm(omega, axis=-1, keepdims=True) * dt
    half = angle * 0.5
    # sinc-safe axis * sin(half)
    axis_sin = omega * dt * 0.5 * jnp.where(
        angle > 1e-8, jnp.sin(half) / jnp.maximum(half, 1e-12), 1.0)
    dq = jnp.concatenate([jnp.cos(half), axis_sin], axis=-1)
    out = quat_mul(q, dq)
    return out / jnp.linalg.norm(out, axis=-1, keepdims=True)


def so3_log(r: jnp.ndarray) -> jnp.ndarray:
    """SO(3) log map: [..., 3, 3] -> [..., 3] rotation vector."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = unskew(r)  # = axis * sin(theta)
    scale = jnp.where(theta > 1e-6,
                      theta / jnp.maximum(jnp.sin(theta), 1e-12), 1.0)
    return w * scale[..., None]


def quat_error_so3(q_des: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Orientation error as a body-frame rotation vector (so3).

    Mirrors the WBC body-orientation task error (reference:
    quadruped/src/controllers/wbc/task_set/qr_task_body_orientation.cpp:29-97):
    err = log(R(q)^T R(q_des)) expressed in the current body frame.
    """
    dq = quat_mul(quat_conj(q), q_des)
    dq = dq * jnp.where(dq[..., :1] < 0, -1.0, 1.0)
    # For unit dq = (cos h, u sin h): log = 2 h u.
    s = jnp.linalg.norm(dq[..., 1:], axis=-1, keepdims=True)
    half = jnp.arctan2(s[..., 0], dq[..., 0])[..., None]
    axis = dq[..., 1:] / jnp.maximum(s, 1e-12)
    return jnp.where(s > 1e-12, 2.0 * half * axis, jnp.zeros_like(axis))


def wrap_angle(a: jnp.ndarray) -> jnp.ndarray:
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * jnp.pi * jnp.round(a / (2.0 * jnp.pi))
