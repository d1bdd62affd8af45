"""Small-matrix batched linear algebra, as elementwise math.

XLA's batched LAPACK-style paths (batched SVD by Jacobi iterations,
Cholesky, triangular solves) are iterative micro-loops that ran far off
roofline for the tiny matrices robotics code lives on (3x3 ... 18x18 at
batch ~1k) on the accelerator this was first tuned on; whether that holds
on the GPU is to be re-measured. Everything here lowers to fusible
elementwise ops instead:

  * `matmul_small` — broadcast-multiply-reduce product (no padded
    batched dots);
  * `inv_spd` — recursive 2x2-block Schur inverse on top of the
    closed-form 3x3 adjugate: SPD principal blocks and Schur complements
    stay SPD, so the recursion is well-posed wherever Cholesky is;
  * `damped_pinv` — right pseudo-inverse of wide [m, n] task Jacobians via
    damped normal equations J^T (J J^T + lam^2 I)^{-1}. This replaces the
    reference's SVD pseudo-inverse with absolute singular-value threshold
    (utils/qr_algebra.h:119): the damped filter 1/(s + lam^2/s) matches
    1/s for s >> lam and rolls off to 0 below it, and rows that are
    exactly zero (contact-masked tasks) produce exactly zero columns.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core.se3 import inv3x3, matmul3 as matmul_small


def _split(n: int) -> int:
    """Leading-block size for the Schur recursion (multiples of 3 when
    possible so the base case is the closed-form 3x3)."""
    if n % 3 == 0:
        return 3 * max(1, (n // 3) // 2)
    return n // 2


def inv_spd(m: jnp.ndarray, refine: int = 1) -> jnp.ndarray:
    """[..., n, n] SPD inverse by recursive block-Schur elimination.

    inv([[A, B], [B^T, D]]) with S = D - B^T A^{-1} B:
        [[A^{-1} + W S^{-1} W^T,  -W S^{-1}],
         [-S^{-1} W^T,             S^{-1}  ]],   W = A^{-1} B.

    Three stabilizers wrap the raw recursion:
      * Jacobi pre-scaling to unit diagonal — the ill-conditioning of the
        matrices this serves (ADMM M with 1000x-rho equality rows, mass
        matrices mixing base and leg inertia scales, contact-masked
        Lambda blocks padded with tiny damping) lives mostly in the
        diagonal, and the unpivoted elimination is only f32-trustworthy
        up to kappa ~ 1e3 of the *scaled* matrix;
      * a branch-free residual guard: where the Schur seed's Newton
        residual ||I - M X|| exceeds the convergence radius (kappa
        beyond the f32 envelope), the seed is replaced per batch element
        by the always-convergent SPD start I/||M||_inf, so the
        refinement below can never diverge — accuracy degrades
        gracefully instead of exploding;
      * `refine` Newton steps X <- X (2I - M X), squaring away the
        remaining roundoff (~1e-4 -> ~1e-8) for two elementwise matmuls
        each.
    """
    n = m.shape[-1]
    if n <= 3:
        return _inv_spd_schur(m)
    d = jnp.sqrt(jnp.abs(
        jnp.diagonal(m, axis1=-2, axis2=-1)) + 1e-30)       # [..., n]
    s = 1.0 / d
    ms = s[..., :, None] * m * s[..., None, :]
    inv = _inv_spd_schur(ms)
    eye = jnp.eye(n, dtype=m.dtype)
    eye2 = 2.0 * eye
    # Residual guard (one extra matmul): Newton contracts iff
    # ||I - M X0|| < 1; fall back to X0 = I/||M||_inf where the Schur
    # seed is outside that radius (NaN compares false -> falls back too).
    resid = jnp.max(jnp.sum(jnp.abs(eye - matmul_small(ms, inv)),
                            axis=-1), axis=-1)              # [...]
    norminf = jnp.max(jnp.sum(jnp.abs(ms), axis=-1), axis=-1)
    safe = eye / norminf[..., None, None]
    inv = jnp.where((resid < 0.9)[..., None, None], inv, safe)
    for _ in range(refine):
        inv = matmul_small(inv, eye2 - matmul_small(ms, inv))
    return s[..., :, None] * inv * s[..., None, :]


def _inv_spd_schur(m: jnp.ndarray) -> jnp.ndarray:
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        a = m[..., 0, 0]
        b = m[..., 0, 1]
        c = m[..., 1, 0]
        d = m[..., 1, 1]
        det = a * d - b * c
        rows = [jnp.stack([d, -b], axis=-1), jnp.stack([-c, a], axis=-1)]
        return jnp.stack(rows, axis=-2) / det[..., None, None]
    if n == 3:
        return inv3x3(m)
    n1 = _split(n)
    a = m[..., :n1, :n1]
    b = m[..., :n1, n1:]
    d = m[..., n1:, n1:]
    a_inv = _inv_spd_schur(a)
    w = matmul_small(a_inv, b)                                  # [.., n1, n2]
    s = d - matmul_small(jnp.swapaxes(b, -1, -2), w)
    s_inv = _inv_spd_schur(s)
    ws = matmul_small(w, s_inv)                                 # [.., n1, n2]
    tl = a_inv + matmul_small(ws, jnp.swapaxes(w, -1, -2))
    tr = -ws
    top = jnp.concatenate([tl, tr], axis=-1)
    bottom = jnp.concatenate([jnp.swapaxes(tr, -1, -2), s_inv], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def damped_pinv(j: jnp.ndarray, lam: float = 1e-3) -> jnp.ndarray:
    """[..., m, n] wide-matrix right pseudo-inverse, damped: [..., n, m]."""
    m = j.shape[-2]
    jjt = matmul_small(j, jnp.swapaxes(j, -1, -2)) \
        + (lam * lam) * jnp.eye(m, dtype=j.dtype)
    return matmul_small(jnp.swapaxes(j, -1, -2), inv_spd(jjt))


def onesided_jacobi_svd(a: jnp.ndarray, sweeps: int = 10):
    """Thin SVD of a tall [..., m, n] matrix (n small, static) by
    one-sided Jacobi: returns (u [..., m, n], s [..., n]) with
    a ~= u * s[..., None, :] @ v^T for some orthogonal v (not returned).

    Why not XLA's jnp.linalg.svd: it lowers to an iterative
    batched-Jacobi loop (core/linalg.py module docstring). One-sided
    Jacobi over a STATIC
    pair schedule is pure elementwise math, and — unlike forming
    a^T a and eigendecomposing — computes SMALL singular values to high
    RELATIVE accuracy (Demmel-Veselic), which the whitened-QP transform
    (solvers/polish.py) depends on: its smallest singular value is
    sqrt(reg) ~ 1e-2 against sigma_max ~ 1e2.

    Each sweep rotates every column pair (p, q) to orthogonality; a few
    sweeps converge (quadratically at the end). Rotations are branch-free
    (the identity rotation is recovered continuously as the off-diagonal
    correlation -> 0).
    """
    n = a.shape[-1]
    u = a
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                up = u[..., :, p]
                uq = u[..., :, q]
                app = jnp.sum(up * up, axis=-1)
                aqq = jnp.sum(uq * uq, axis=-1)
                apq = jnp.sum(up * uq, axis=-1)
                # Rutishauser rotation zeroing the (p, q) correlation;
                # branch-free: as apq -> 0, tau -> +-inf, t -> 0 and the
                # rotation degrades continuously to the identity (the 0/0
                # corner is guarded by the tiny denominator floor).
                denom = 2.0 * apq
                denom = jnp.where(jnp.abs(denom) < 1e-30,
                                  jnp.full_like(denom, 1e-30), denom)
                tau = (aqq - app) / denom
                t = jnp.sign(tau) / (jnp.abs(tau)
                                     + jnp.sqrt(1.0 + tau * tau))
                t = jnp.where(jnp.abs(apq) < 1e-30, jnp.zeros_like(t), t)
                c = 1.0 / jnp.sqrt(1.0 + t * t)
                s = t * c
                new_p = c[..., None] * up - s[..., None] * uq
                new_q = s[..., None] * up + c[..., None] * uq
                u = u.at[..., :, p].set(new_p).at[..., :, q].set(new_q)
    s = jnp.sqrt(jnp.sum(u * u, axis=-2))
    u = u / (s[..., None, :] + 1e-30)
    return u, s
