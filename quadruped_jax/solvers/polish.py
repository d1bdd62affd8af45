"""Exact batched solver for near-singular factored QPs.

    min 1/2 x^T (C^T C + reg I) x + q^T x   s.t.  l <= A x <= u

The force-balance stance QP has exactly this shape (stance_force_balance:
C = [Q^1/2 M ; sqrt(reg) 1^T], so P = M^T Q M + reg (ones + I), matching
the reference's ComputeObjectiveMatrix :154 + ComputeWeightMatrix :183),
with kappa(P) ~ 1e8: the cost has full curvature only on the rank-k
wrench subspace, and the tiny regularizer decides the per-leg force
distribution along the ~(n-k)-dim "internal force" modes. First-order
methods stall there (measured: 10k ADMM iterations to reach the
QuadProg++ minimizer, benchmarks/exp_fb_polish.py), and a direct f32
factorization is hopeless at that kappa. This solver is exact in plain
f32 by construction:

1.  WHITEN. One-sided Jacobi SVD of C^T (core/linalg.py — high RELATIVE
    accuracy on the sqrt(reg)-sized singular values, which an eigensolve
    of C^T C would destroy) gives the exact closed forms
        P^{-1/2} = V [(s^2+reg)^{-1/2} - reg^{-1/2}] V^T + reg^{-1/2} I
    (and P^{1/2} likewise). In xi = P^{1/2} x coordinates the Hessian is
    the IDENTITY and constraint rows are normalized to unit norm — every
    quantity downstream is O(1)-conditioned.
2.  ADMM in the whitened frame (solvers/qp.py, scale=False) converges
    fast to medium accuracy and identifies the geometry.
3.  POLISH: a batched single-pivot primal-dual active-set iteration
    (add the most violated row / drop the worst wrong-sign multiplier,
    one per pass — the all-at-once Kunisch-Rendl update cycles on ~1/3
    of trot cases, measured) solves the masked range-space KKT system
    per pass with the block-Schur inverse and keeps the best-KKT
    iterate. On the golden force-balance cases this lands within 0.4 N
    of the reference's f64 QuadProg++ solution (tests/test_golden_parity
    force-balance block).

Everything is branch-free and static-shape: jit/vmap/scan safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from quadruped_jax.core import linalg
from quadruped_jax.solvers import qp


class FactoredQP(NamedTuple):
    c: jnp.ndarray     # [..., k, n] cost factor (P = c^T c + reg I)
    reg: float
    q: jnp.ndarray     # [..., n]
    a: jnp.ndarray     # [..., m, n]
    l: jnp.ndarray     # [..., m]
    u: jnp.ndarray     # [..., m]


def whiten_factors(c: jnp.ndarray, reg: float):
    """(P^{1/2}, P^{-1/2}) for P = c^T c + reg I, via Jacobi SVD of c^T."""
    ct = jnp.swapaxes(c, -1, -2)                       # [..., n, k]
    n = ct.shape[-2]
    v, s = linalg.onesided_jacobi_svd(ct)              # [..., n, k], [..., k]
    lam = s * s
    sq = jnp.sqrt(lam + reg)
    r_half = jnp.sqrt(jnp.asarray(reg, c.dtype))
    d_fwd = (sq - r_half)[..., None, :]
    d_inv = (1.0 / sq - 1.0 / r_half)[..., None, :]
    eye = jnp.eye(n, dtype=c.dtype)
    p_half = (v * d_fwd) @ jnp.swapaxes(v, -1, -2) + r_half * eye
    p_inv_half = (v * d_inv) @ jnp.swapaxes(v, -1, -2) + eye / r_half
    return p_half, p_inv_half


def _kkt_arrays(xi, y, m_act, b_act, a_t, qt, l, u, act_u, act_l, eq):
    ax = jnp.einsum("...mn,...n->...m", a_t, xi)
    viol = jnp.maximum(l - ax, 0.0) + jnp.maximum(ax - u, 0.0)
    sign = jnp.where(act_u & ~eq, jnp.maximum(-y, 0.0), 0.0) \
        + jnp.where(act_l & ~eq, jnp.maximum(y, 0.0), 0.0)
    comp = jnp.abs(m_act * (ax - b_act)) * jnp.abs(y)
    return ax, viol, sign, comp


def solve_factored(prob: FactoredQP, *, admm_iters: int = 100,
                   polish_passes: int = 24, rho: float = 1.0,
                   kkt_tol: float = 1e-5,
                   x0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Exact minimizer of the factored QP; batch over leading axes.

    x0: optional warm start in the ORIGINAL variables (e.g. the previous
    control tick's forces — the same role qpOASES hot-starts play in the
    reference). It is whitened into the ADMM stage; the active-set polish
    then starts from the warm solve's active set, so a near-stationary
    problem converges in a fraction of the cold budget (measured on the
    walk stack: benchmarks/exp_walk_budget.py)."""
    dtype = prob.q.dtype
    n = prob.q.shape[-1]
    mrows = prob.l.shape[-1]
    batch = prob.q.shape[:-1]

    p_half, p_inv_half = whiten_factors(prob.c, prob.reg)

    qt = jnp.einsum("...ij,...j->...i", p_inv_half, prob.q)
    a_t = prob.a @ p_inv_half                          # [..., m, n]
    row_norm = jnp.sqrt(jnp.sum(a_t * a_t, axis=-1)) + 1e-30
    a_t = a_t / row_norm[..., None]
    l = prob.l / row_norm
    u = prob.u / row_norm

    # --- stage 2: whitened ADMM (identity Hessian, unit rows) ---
    rho_vec = qp.default_rho(l, u, rho=rho)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), batch + (n, n))
    xi_warm = (None if x0 is None
               else jnp.einsum("...ij,...j->...i", p_half, x0))
    sol = qp.admm_solve(eye, qt, a_t, l, u, iters=admm_iters, rho=rho_vec,
                        scale=False, x0=xi_warm)
    xi0 = sol.x

    # --- stage 3: single-pivot active-set polish ---
    eq = (u - l) < 1e-9
    gmat = a_t @ jnp.swapaxes(a_t, -1, -2)             # [..., m, m] fixed
    ax0 = jnp.einsum("...mn,...n->...m", a_t, xi0)
    scale0 = jnp.maximum(1.0, jnp.max(jnp.abs(ax0), axis=-1,
                                      keepdims=True))
    tol0 = 1e-4 * scale0
    act_u = (ax0 > u - tol0) & ~eq
    act_l = (ax0 < l + tol0) & ~eq

    def body(carry, _):
        act_l, act_u, best_kkt, best_xi = carry
        act = act_l | act_u | eq
        m_act = act.astype(dtype)
        b_act = jnp.where(act_u, u, l)
        s_mat = m_act[..., :, None] * gmat * m_act[..., None, :] \
            + (1.0 + 1e-9 - m_act) * jnp.eye(mrows, dtype=dtype)
        s_inv = linalg.inv_spd(s_mat, refine=2)
        rhs = m_act * (jnp.einsum("...mn,...n->...m", a_t, -qt) - b_act)
        y = m_act * jnp.einsum("...ij,...j->...i", s_inv, rhs)
        xi = -qt - jnp.einsum("...nm,...m->...n",
                              jnp.swapaxes(a_t, -1, -2), m_act * y)
        ax, viol, sign, comp = _kkt_arrays(xi, y, m_act, b_act, a_t, qt,
                                           l, u, act_u, act_l, eq)
        kkt = jnp.max(viol, -1) + jnp.max(sign, -1) + jnp.max(comp, -1)
        better = kkt < best_kkt
        best_xi = jnp.where(better[..., None], xi, best_xi)
        best_kkt = jnp.where(better, kkt, best_kkt)
        # Single pivot per pass, frozen once the KKT residual is tight:
        live = (kkt > kkt_tol)[..., None]
        drop_phase = (jnp.max(sign, -1) > 1e-7)[..., None]
        worst_sign = jnp.argmax(sign, axis=-1)
        one_hot_drop = jnp.arange(mrows) == worst_sign[..., None]
        do_drop = live & drop_phase & one_hot_drop
        act_u = act_u & ~do_drop
        act_l = act_l & ~do_drop
        worst_viol = jnp.argmax(viol, axis=-1)
        one_hot_add = jnp.arange(mrows) == worst_viol[..., None]
        has_viol = (jnp.max(viol, -1) > 1e-7)[..., None]
        do_add = live & ~drop_phase & has_viol & one_hot_add
        above = jnp.take_along_axis(ax, worst_viol[..., None],
                                    -1) > jnp.take_along_axis(
                                        u, worst_viol[..., None], -1)
        act_u = act_u | (do_add & above & ~eq)
        act_l = act_l | (do_add & ~above & ~eq)
        return (act_l, act_u, best_kkt, best_xi), None

    init = (act_l, act_u, jnp.full(batch, jnp.inf, dtype), xi0)
    (act_l, act_u, best_kkt, best_xi), _ = lax.scan(
        body, init, None, length=polish_passes)

    return jnp.einsum("...ij,...j->...i", p_inv_half, best_xi)
