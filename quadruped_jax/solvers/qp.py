"""Batched dense QP solver (ADMM, OSQP-style splitting) in pure JAX.

Replaces the reference's three CPU active-set solvers — qpOASES for the
convex MPC (quadruped/src/controllers/mpc/qr_mpc_interface.cpp:428-442),
QuadProg++ for force-balance (qr_qp_torque_optimizer.cpp:274) and for the
WBIC (qr_wholebody_impulse_ctrl.cpp:113) — with ONE batched first-order
solver. Active-set methods are branchy and sequential (they do not batch or
vectorize); ADMM iterations are pure matmuls + clips, which batch
perfectly, and a fixed iteration budget gives static shapes and
deterministic latency.

Problem form (OSQP):   min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u
Equalities are rows with l == u. All operands carry arbitrary leading batch
axes; one `jit(vmap)`'d instance solves the whole scenario batch.

Method notes:
  * One factorization per solve: M = P + sigma I + A^T diag(rho) A is SPD;
    we precompute M^{-1} once (batched Cholesky inverse) so each of the
    `iters` ADMM steps is a single [n x n] matmul — the ReLU-QP insight that
    fixed-matrix ADMM iterations are an affine map + projection.
  * Per-row rho (higher on equality rows) as in OSQP.
  * Over-relaxation alpha = 1.6.
  * Optional polish: one extra KKT solve on the detected active set would
    sharpen solutions; parity tests pass without it at iters ~ 50-100.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadruped_jax.core import linalg

DEFAULT_SIGMA = 1e-6
DEFAULT_ALPHA = 1.6
EQ_RHO_SCALE = 1e3
RUIZ_ITERS = 10
BIG_BOUND = 1e7


class QPSolution(NamedTuple):
    x: jnp.ndarray          # [..., n] primal solution
    z: jnp.ndarray          # [..., m] constraint values (projected)
    y: jnp.ndarray          # [..., m] dual solution
    prim_res: jnp.ndarray   # [...] final primal residual (inf-norm)
    dual_res: jnp.ndarray   # [...] final dual residual (inf-norm)


def _spd_inverse(m: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD inverse via recursive block-Schur elimination
    (core/linalg.py): XLA's batched Cholesky + triangular solves are
    iterative micro-loops (far off roofline on the accelerator this was
    first tuned on; to re-check on the GPU), while the Schur form is pure
    elementwise math.

    refine=2: M here carries 1000x-rho equality rows (scaled kappa up to
    ~1e3) and its inverse error shifts the ADMM fixed point 1:1; two
    Newton polish steps (4 small matmuls, once per solve, outside the
    iteration loop) hold the solution within ~2e-3 of the f64 optimum on
    the equality-row stress test, vs ~8e-3 at refine=1."""
    return linalg.inv_spd(m, refine=2)


def default_rho(l: jnp.ndarray, u: jnp.ndarray, rho: float = 0.1) -> jnp.ndarray:
    """Per-row rho: `rho` for inequalities, EQ_RHO_SCALE*rho for equalities."""
    is_eq = (u - l) < 1e-9
    return jnp.where(is_eq, rho * EQ_RHO_SCALE, rho)


def ruiz_equilibrate(p, q, a, l, u, iters: int = RUIZ_ITERS):
    """Symmetric Ruiz equilibration of the KKT data (OSQP 'scaling').

    Returns (p', q', a', l', u', d, e, c): x = d * x', y = e * y' / c.
    Infinite bounds are preserved. Essential for the MPC QP, whose raw data
    mixes 1e-6 force regularization with 1e2 state weights — plain ADMM
    stalls on it, equilibrated ADMM converges in tens of iterations.
    """
    n = p.shape[-1]
    m = a.shape[-2]
    d = jnp.ones(p.shape[:-2] + (n,), p.dtype)
    e = jnp.ones(a.shape[:-2] + (m,), p.dtype)
    c = jnp.ones(p.shape[:-2], p.dtype)
    ps, qs, as_ = p, q, a

    def safe_inv_sqrt(x):
        # Zero rows/columns (masked-out constraints) keep scale 1 — clipping
        # alone would compound 1e4 per sweep into inf over the iterations.
        return jnp.where(x > 1e-12,
                         1.0 / jnp.sqrt(jnp.clip(x, 1e-12, 1e12)), 1.0)

    for _ in range(iters):
        # Column norms of the stacked [P; A] for variable scaling.
        col_p = jnp.max(jnp.abs(ps), axis=-2)
        col_a = jnp.max(jnp.abs(as_), axis=-2)
        dd = safe_inv_sqrt(jnp.maximum(col_p, col_a))
        row_a = jnp.max(jnp.abs(as_), axis=-1)
        ee = safe_inv_sqrt(row_a)
        ps = dd[..., :, None] * ps * dd[..., None, :]
        qs = qs * dd
        as_ = ee[..., :, None] * as_ * dd[..., None, :]
        d = d * dd
        e = e * ee
        # Cost normalization: mean column norm of P' and norm of q'.
        gamma = 1.0 / jnp.clip(
            jnp.maximum(jnp.mean(jnp.max(jnp.abs(ps), axis=-2), axis=-1),
                        jnp.max(jnp.abs(qs), axis=-1)), 1e-8, 1e8)
        ps = ps * gamma[..., None, None]
        qs = qs * gamma[..., None]
        c = c * gamma

    ls = e * l
    us = e * u
    # Keep one-sided rows one-sided.
    ls = jnp.where(l <= -BIG_BOUND, l, ls)
    us = jnp.where(u >= BIG_BOUND, u, us)
    return ps, qs, as_, ls, us, d, e, c


def admm_solve(
    p: jnp.ndarray,     # [..., n, n] SPD(ish) cost matrix
    q: jnp.ndarray,     # [..., n]
    a: jnp.ndarray,     # [..., m, n]
    l: jnp.ndarray,     # [..., m]  (use -BIG for one-sided rows)
    u: jnp.ndarray,     # [..., m]
    *,
    rho: jnp.ndarray | float | None = None,
    sigma: float = DEFAULT_SIGMA,
    alpha: float = DEFAULT_ALPHA,
    iters: int = 60,
    x0: jnp.ndarray | None = None,
    y0: jnp.ndarray | None = None,
    scale: bool = True,
) -> QPSolution:
    """Solve a batch of dense QPs with a fixed ADMM iteration budget.

    Static-shape, branch-free: safe under jit/vmap/scan/shard_map.
    Warm starting via (x0, y0) mirrors qpOASES' hot-start role in the MPC
    cadence (reference re-solves every 15 ticks from the previous solution).
    With scale=True (default) the data is Ruiz-equilibrated first; residuals
    are reported in the original (unscaled) problem.
    """
    if scale:
        p0_, q0_, a0_, l0_, u0_ = p, q, a, l, u
        p, q, a, l, u, d_s, e_s, c_s = ruiz_equilibrate(p, q, a, l, u)
        if x0 is not None:
            x0 = x0 / d_s
        if y0 is not None:
            y0 = y0 * c_s[..., None] / e_s

    n = p.shape[-1]
    if rho is None:
        rho_vec = default_rho(l, u)
    else:
        rho_vec = jnp.broadcast_to(jnp.asarray(rho, p.dtype), l.shape)
    rho_inv = 1.0 / rho_vec

    at = jnp.swapaxes(a, -1, -2)
    m_mat = (p + sigma * jnp.eye(n, dtype=p.dtype)
             + at @ (rho_vec[..., :, None] * a))
    m_inv = _spd_inverse(m_mat)

    x = jnp.zeros_like(q) if x0 is None else x0
    z = jnp.einsum("...mn,...n->...m", a, x)
    z = jnp.clip(z, l, u)
    y = jnp.zeros_like(l) if y0 is None else y0

    def body(carry, _):
        x, z, y = carry
        rhs = sigma * x - q + jnp.einsum(
            "...nm,...m->...n", at, rho_vec * z - y)
        x_t = jnp.einsum("...nm,...m->...n", m_inv, rhs)
        z_t = jnp.einsum("...mn,...n->...m", a, x_t)
        x_new = alpha * x_t + (1 - alpha) * x
        z_prev = z
        z_relaxed = alpha * z_t + (1 - alpha) * z_prev
        z_new = jnp.clip(z_relaxed + rho_inv * y, l, u)
        y_new = y + rho_vec * (z_relaxed - z_new)
        return (x_new, z_new, y_new), None

    (x, z, y), _ = jax.lax.scan(body, (x, z, y), None, length=iters)

    if scale:
        # Unscale: x = D x', y = E y' / c.
        x = x * d_s
        y = y * e_s / c_s[..., None]
        p, q, a, l, u = p0_, q0_, a0_, l0_, u0_
        z = jnp.clip(jnp.einsum("...mn,...n->...m", a, x), l, u)
        at = jnp.swapaxes(a, -1, -2)

    ax = jnp.einsum("...mn,...n->...m", a, x)
    prim = jnp.max(jnp.abs(ax - jnp.clip(ax, l, u)), axis=-1)
    dual_vec = (jnp.einsum("...nm,...m->...n", jnp.swapaxes(p, -1, -2), x) + q
                + jnp.einsum("...nm,...m->...n", at, y))
    dual = jnp.max(jnp.abs(dual_vec), axis=-1)
    return QPSolution(x=x, z=z, y=y, prim_res=prim, dual_res=dual)


def kkt_residuals(p, q, a, l, u, sol: QPSolution):
    """Diagnostic KKT residuals (stationarity, feasibility, complementarity)."""
    ax = jnp.einsum("...mn,...n->...m", a, sol.x)
    stationarity = (jnp.einsum("...ij,...j->...i", p, sol.x) + q
                    + jnp.einsum("...ji,...j->...i", a, sol.y))
    prim = jnp.maximum(ax - u, 0.0) + jnp.maximum(l - ax, 0.0)
    comp = jnp.minimum(jnp.abs(ax - l), jnp.abs(u - ax)) * jnp.abs(sol.y)
    return (jnp.max(jnp.abs(stationarity), -1), jnp.max(prim, -1),
            jnp.max(comp, -1))
