"""Swing-foot trajectory splines as closed-form batched JAX ops.

Capability parity with the reference's three spline families
(quadruped/src/controllers/qr_foot_trajectory_generator.cpp):
  * `qrFootParabolaPatternGenerator` (:166-215)  — XY linear + Z parabola
  * `qrFootCubicPatternGenerator`    (:218-278)  — cubic XY + two-segment Z
  * `qrFootBSplinePatternGenerator`  (:30-163)   — 9-control-point cubic
    B-spline template, reshaped per swing (tinynurbs in the reference;
    closed-form De Boor basis evaluation here)
plus the cubic Hermite `qrSpline` from utils/qr_geometry.h:234-343.

All evaluators take a normalized phase in [0, 1] and broadcast over leading
batch axes. No data-dependent control flow — everything is `where`-masked —
so they vmap and scan cleanly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def phase_remap(phi: jnp.ndarray) -> jnp.ndarray:
    """Reference swing-phase warp: phi' = 0.8*sin(pi*phi) blended as in
    qr_foot_trajectory_generator.cpp (the '0.8 sin(pi phi)' remap keeps foot
    velocity continuous at lift-off/touch-down)."""
    return 0.8 * jnp.sin(jnp.pi * phi) * (1 - phi) + phi


def cubic_hermite(p0, v0, p1, v1, phi):
    """Cubic Hermite on [0,1]: returns (pos, vel_per_unit_phase).

    Matches the boundary-conditioned `qrSpline::getPoint` semantics.
    phi broadcasts against p0/v0/p1/v1.
    """
    t = phi
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    pos = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
    d00 = 6 * t2 - 6 * t
    d10 = 3 * t2 - 4 * t + 1
    d01 = -6 * t2 + 6 * t
    d11 = 3 * t2 - 2 * t
    vel = d00 * p0 + d10 * v0 + d01 * p1 + d11 * v1
    return pos, vel


def swing_parabola(start, end, max_height, phi):
    """XY linear + Z parabola swing (reference parabola pattern :166-215).

    start, end: [..., 3] foot positions; max_height: scalar or [...] apex
    height above the line start->end; phi: [...] normalized swing phase.
    Returns (pos [..., 3], vel-per-unit-phase [..., 3]).
    """
    phi = phi[..., None]
    xy = start[..., :2] + (end[..., :2] - start[..., :2]) * phi
    vxy = end[..., :2] - start[..., :2]
    # Z: parabola through (0, z0), (0.5, max(z0,z1)+h), (1, z1).
    z0 = start[..., 2:3]
    z1 = end[..., 2:3]
    mid = jnp.maximum(z0, z1) + max_height
    # Lagrange quadratic through the three points.
    t = phi
    l0 = 2 * (t - 0.5) * (t - 1.0)
    l1 = -4 * t * (t - 1.0)
    l2 = 2 * t * (t - 0.5)
    z = l0 * z0 + l1 * mid + l2 * z1
    dz = (4 * t - 3) * z0 + (-8 * t + 4) * mid + (4 * t - 1) * z1
    pos = jnp.concatenate([xy, z], axis=-1)
    vel = jnp.concatenate([jnp.broadcast_to(vxy, xy.shape), dz], axis=-1)
    return pos, vel


def swing_cubic(start, end, max_height, phi):
    """Cubic XY + two-segment Z swing (reference cubic pattern :218-278).

    XY follow a zero-end-velocity cubic; Z rises to apex in the first half and
    descends in the second, each half a cubic with zero boundary velocities.
    """
    phib = phi[..., None]
    xy, vxy = cubic_hermite(start[..., :2], jnp.zeros_like(start[..., :2]),
                            end[..., :2], jnp.zeros_like(end[..., :2]), phib)
    z0 = start[..., 2:3]
    z1 = end[..., 2:3]
    apex = jnp.maximum(z0, z1) + max_height
    # First half: z0 -> apex over phi in [0, 0.5]; second: apex -> z1.
    t_up = jnp.clip(phib * 2.0, 0.0, 1.0)
    t_dn = jnp.clip(phib * 2.0 - 1.0, 0.0, 1.0)
    z_up, vz_up = cubic_hermite(z0, jnp.zeros_like(z0), apex, jnp.zeros_like(z0), t_up)
    z_dn, vz_dn = cubic_hermite(apex, jnp.zeros_like(z0), z1, jnp.zeros_like(z0), t_dn)
    up = phib < 0.5
    z = jnp.where(up, z_up, z_dn)
    vz = jnp.where(up, vz_up, vz_dn) * 2.0
    pos = jnp.concatenate([xy, z], axis=-1)
    vel = jnp.concatenate([vxy, vz], axis=-1)
    return pos, vel


# --- Cubic B-spline template (reference B-spline pattern :30-163) -----------
#
# The reference builds a clamped cubic B-spline with 9 control points shaping
# a normalized swing profile, then scales it per swing. We precompute the
# basis on a static phase grid transformation: for a clamped uniform cubic
# B-spline with n control points the basis functions are piecewise cubic;
# evaluating them with lax-friendly arithmetic means computing all basis
# values densely — with only 9 control points that is a [9]-vector dot.

_NUM_CTRL = 9
_DEGREE = 3


def _open_uniform_knots(n_ctrl: int, degree: int) -> np.ndarray:
    interior = n_ctrl - degree - 1
    return np.concatenate([
        np.zeros(degree + 1),
        (np.arange(1, interior + 1)) / (interior + 1),
        np.ones(degree + 1),
    ])


_KNOTS = _open_uniform_knots(_NUM_CTRL, _DEGREE)


def bspline_basis(phi: jnp.ndarray) -> jnp.ndarray:
    """Dense clamped cubic B-spline basis: [...] -> [..., 9].

    Cox–de Boor recursion evaluated branch-free over the static knot vector.
    """
    knots = jnp.asarray(_KNOTS, dtype=phi.dtype)
    u = jnp.clip(phi, 0.0, 1.0 - 1e-6)[..., None]
    n_knots = knots.shape[0]
    # Degree 0 basis: indicator of [t_i, t_{i+1}).
    t_lo = knots[: n_knots - 1]
    t_hi = knots[1:]
    basis = jnp.where((u >= t_lo) & (u < t_hi), 1.0, 0.0)
    for d in range(1, _DEGREE + 1):
        m = n_knots - d - 1
        t_i = knots[:m]
        t_id = knots[d : d + m]
        t_i1 = knots[1 : m + 1]
        t_id1 = knots[d + 1 : d + m + 1]
        left_den = t_id - t_i
        right_den = t_id1 - t_i1
        left = jnp.where(left_den > 1e-9, (u - t_i) / jnp.where(left_den > 1e-9, left_den, 1.0), 0.0)
        right = jnp.where(right_den > 1e-9, (t_id1 - u) / jnp.where(right_den > 1e-9, right_den, 1.0), 0.0)
        basis = left * basis[..., :m] + right * basis[..., 1 : m + 1]
    return basis


def default_swing_ctrl_z(clearance: float = 1.0) -> np.ndarray:
    """Normalized 9-point Z swing template: 0 -> apex(=clearance) -> 0,
    mirroring the reference's hand-tuned control polygon shape."""
    return np.array([0.0, 0.0, 0.35, 0.8, 1.0, 0.8, 0.35, 0.05, 0.0]) * clearance


def swing_bspline(start, end, max_height, phi, ctrl_z=None):
    """B-spline swing: XY via smooth basis blend, Z via 9-point template.

    start, end: [..., 3]; phi: [...]. Returns (pos, vel-per-unit-phase).
    """
    basis = bspline_basis(phi)  # [..., 9]
    if ctrl_z is None:
        ctrl_z = default_swing_ctrl_z()
    ctrl_z = jnp.asarray(ctrl_z, dtype=basis.dtype)
    # XY control points: linear ramp start->end (clamped spline reproduces
    # the straight line with eased velocity profile).
    ramp = jnp.asarray(np.linspace(0.0, 1.0, _NUM_CTRL), dtype=basis.dtype)
    sxy = basis @ ramp  # [...] eased progress
    xy = start[..., :2] + (end[..., :2] - start[..., :2]) * sxy[..., None]
    z_rel = basis @ ctrl_z  # [...] normalized height
    z0 = start[..., 2]
    z1 = end[..., 2]
    z = z0 + (z1 - z0) * sxy + max_height * z_rel
    pos = jnp.concatenate([xy, z[..., None]], axis=-1)
    # Finite-difference velocity (per unit phase) — smooth enough for the
    # hybrid command's dq target; analytic derivative available if needed.
    eps = 1e-3
    basis2 = bspline_basis(jnp.clip(phi + eps, 0.0, 1.0))
    sxy2 = basis2 @ ramp
    z_rel2 = basis2 @ ctrl_z
    vxy = (end[..., :2] - start[..., :2]) * ((sxy2 - sxy) / eps)[..., None]
    vz = ((z1 - z0) * (sxy2 - sxy) + max_height * (z_rel2 - z_rel)) / eps
    vel = jnp.concatenate([vxy, vz[..., None]], axis=-1)
    return pos, vel
