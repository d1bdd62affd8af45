"""H=16 slow-mode probe on the worst cadence step (seed 0, step 6).

Tests structural rho choices (per-triple rho matched to the equilibrated
curvature) and scheme variants against plain scalar rho, measuring
first-step error vs budget — looking for something that drains the
4-8% plateau at a fixed ~32-64 warm budget.

Run:  python benchmarks/exp_h16_rho_structure.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_platforms", "cpu")
from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import cone_qp
from quadruped_jax.control.mpc import gravity_warm_start

from exp_h16_tune import CADENCE_S, N_G, build_blocked, cadence_case_at, \
    first_step_err


def warm_from_prev(seed, k):
    """Warm start exactly as the cadence chain would: converged boot at
    step 0, then 32-iteration production solves up to step k-1."""
    x = y = None
    for j in range(k):
        prob = build_blocked(cadence_case_at(j * CADENCE_S, seed))
        if x is None:
            sol = cone_qp.solve(prob, iters=3200, x0=gravity_warm_start(
                a1_params(), (prob.fz_hi > 0).astype(jnp.float32)
                .reshape(N_G, 4)))
        else:
            sol = cone_qp.solve(prob, iters=32, alpha=1.0,
                                accel_restart=20, x0=x, y0=y)
        x, y = sol.x, sol.y
    return x, y


def main():
    seed, k = 0, 6
    scale = float(a1_params().total_mass) * 9.81
    prob = build_blocked(cadence_case_at(k * CADENCE_S, seed))
    oracle = cone_qp.solve(prob, iters=8000)
    x_w, y_w = warm_from_prev(seed, k)

    # Per-triple curvature of the EQUILIBRATED P (what the solver sees).
    q_s, d, d_t, gamma, fz_lo, fz_hi = cone_qp._equilibrate_scales(prob)
    diag = jnp.diagonal(prob.p, axis1=-2, axis2=-1) * d * d * gamma
    curv_t = jnp.mean(diag.reshape(-1, 3), axis=-1)          # [T]
    curv_t = curv_t / jnp.mean(curv_t)
    print("curvature per triple (normalized):",
          np.asarray(curv_t).round(2))

    def err(sol):
        return first_step_err(sol.x, oracle.x, scale) * 100

    for budget in (32, 64, 128):
        rows = []
        sol = cone_qp.solve(prob, iters=budget, alpha=1.0,
                            accel_restart=20, x0=x_w, y0=y_w)
        rows.append(f"accel rho0.05: {err(sol):.2f}%")
        sol = cone_qp.solve(prob, iters=budget, x0=x_w, y0=y_w)
        rows.append(f"relax: {err(sol):.2f}%")
        for expo in (0.5, 1.0):
            rho_vec = (0.05 * curv_t[:, None] ** expo)
            sol = cone_qp.solve(prob, iters=budget, rho=rho_vec,
                                alpha=1.0, accel_restart=20,
                                x0=x_w, y0=y_w)
            rows.append(f"accel rho~curv^{expo}: {err(sol):.2f}%")
        for restart in (10, 40):
            sol = cone_qp.solve(prob, iters=budget, alpha=1.0,
                                accel_restart=restart, x0=x_w, y0=y_w)
            rows.append(f"accel restart{restart}: {err(sol):.2f}%")
        print(f"budget {budget}: " + "  ".join(rows))


if __name__ == "__main__":
    main()
