"""Prototype: primal-dual active-set polish for the force-balance QP.

Goal: from an approximate ADMM solution, recover the EXACT minimizer of
min 1/2 x^T P x + q^T x  s.t. l <= Ax <= u  (P nearly singular: the
reference's tiny ones+I regularizer leaves kappa ~ 1e8), matching the
reference's QuadProg++ solution to <0.1 N. Kunisch-Rendl iteration with
all-at-once set updates, range-space solves, and a best-KKT-iterate
fallback against cycling. f64 here; the production port runs the same
recursion in compensated f32 (core/linalg df32 helpers).

    python benchmarks/exp_fb_polish.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax

jax.config.update("jax_platforms", "cpu")
from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp
import numpy as np


def kr_polish(P, q, A, l, u, x0, passes=12, delta=1e-9):
    """Primal-dual active-set (Kunisch-Rendl) from a warm primal x0.

    Returns the iterate with the best KKT residual over the passes
    (guards against the known KR cycling failure mode).
    """
    m_rows = A.shape[0]
    Pinv_mul = np.linalg.inv(P)          # prototype: plain f64 inverse
    eq = (u - l) < 1e-9
    span = np.abs(u - l)
    ax0 = A @ x0
    tol = 1e-4 * max(1.0, np.abs(ax0).max())
    act_u = (ax0 > u - tol) & ~eq
    act_l = (ax0 < l + tol) & ~eq
    best = (np.inf, x0.copy())
    y = np.zeros(m_rows)
    sscale = np.abs(np.diag(A @ Pinv_mul @ A.T)) + delta

    for _ in range(passes):
        act = act_l | act_u | eq
        m = act.astype(np.float64)
        b_act = np.where(act_u, u, l)
        G = A @ Pinv_mul @ A.T
        S = np.outer(m, m) * G + np.diag((1.0 - m) * sscale) \
            + delta * np.diag(sscale)
        rhs = m * (A @ Pinv_mul @ (-q) - b_act)
        y = m * np.linalg.solve(S, rhs)
        x = Pinv_mul @ (-q - A.T @ (m * y))
        ax = A @ x
        # KKT residual: primal violation + complementarity sign errors.
        viol = np.maximum(l - ax, 0.0) + np.maximum(ax - u, 0.0)
        sign_err = np.where(act_u & ~eq, np.maximum(-y, 0.0), 0.0) \
            + np.where(act_l & ~eq, np.maximum(y, 0.0), 0.0)
        kkt = viol.max() + 1e-3 * sign_err.max()
        if kkt < best[0]:
            best = (kkt, x.copy())
        # KR update: add violated rows, drop wrong-sign multipliers.
        act_u = ((ax > u + 0.0) | ((act_u) & (y > 0.0))) & ~eq
        act_l = ((ax < l - 0.0) | ((act_l) & (y < 0.0))) & ~eq
    return best[1], best[0]


def main():
    import pathlib

    from test_golden_parity import make_fb_case, run_fb_oracle
    from quadruped_jax.control import stance_force_balance as fb
    from quadruped_jax.core import se3

    tmp = pathlib.Path("/tmp")
    cases = [(0, (1, 1, 1, 1)), (1, (1, 1, 1, 1)), (2, (1, 0, 1, 1)),
             (3, (0, 1, 1, 0)), (4, (1, 1, 1, 1)), (5, (1, 1, 0, 1)),
             (6, (1, 1, 1, 1)), (7, (0, 1, 1, 1))]
    worst = 0.0
    for seed, contacts in cases:
        params, config, obs, des, a_des, feet_base, cvec = \
            make_fb_case(seed, contacts)
        ref = run_fb_oracle(params, a_des, np.asarray(obs.base_quat),
                            feet_base, cvec, tmp)
        r_mat = np.asarray(se3.quat_to_rotmat(obs.base_quat), np.float64)

        # f64 problem build identical to compute_contact_forces
        r_feet = feet_base @ r_mat.T
        inertia_w = r_mat @ np.asarray(params.total_inertia,
                                       np.float64) @ r_mat.T
        m6 = np.zeros((6, 12))
        inv_inertia = np.linalg.inv(inertia_w)
        for leg in range(4):
            m6[:3, 3 * leg:3 * leg + 3] = \
                np.eye(3) / float(params.total_mass)
            fx, fy, fz = r_feet[leg]
            m6[3:, 3 * leg:3 * leg + 3] = inv_inertia @ np.array(
                [[0, -fz, fy], [fz, 0, -fx], [-fy, fx, 0]])
        qd = np.array([1., 1, 1, 10, 10, 1])
        target = np.asarray(a_des, np.float64) + np.array([0, 0, 9.8,
                                                           0, 0, 0])
        P = m6.T @ (qd[:, None] * m6) + 1e-4 * (np.ones((12, 12))
                                                + np.eye(12))
        qv = -(m6.T @ (qd * target))
        A, l_b, u_b = [np.asarray(v, np.float64) for v in
                       fb.build_constraints(params, jnp.asarray(cvec),
                                            jnp.full(4, 0.01),
                                            jnp.full(4, 10.0),
                                            jnp.asarray([0., 0., 1.]))]
        F32 = np.asarray(fb.compute_contact_forces(
            config.replace(qp_iters=400), params, obs, des,
            jnp.asarray(cvec)))
        x, kkt = kr_polish(P, qv, A, l_b, u_b,
                           F32.reshape(12).astype(np.float64))
        ours = -(x.reshape(4, 3) @ r_mat)
        err = np.abs(ours - ref).max()
        worst = max(worst, err)
        print(f"seed {seed} contacts={contacts}: polish err = {err:8.4f} N"
              f"  (kkt {kkt:.2e})")
    print("worst:", worst)


if __name__ == "__main__":
    main()
