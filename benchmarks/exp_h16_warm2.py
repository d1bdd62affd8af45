"""H=16 warm-cadence rho refinement (follow-up to exp_h16_warm.py).

Findings so far: the warm stall is the long horizon itself (unblocked
matches blocked), dual resets do nothing, budget helps only slowly —
but raising rho 0.05 -> 0.1 halves the 32-iteration error. This sweep
finds the (warm rho, budget) pair for the production H=16 config: cold
boot stays at rho 0.05 / 3200 iters (its own measured optimum), the
oracle is a 6000-iteration converged solve at default rho.

Run:  python benchmarks/exp_h16_warm2.py
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

from exp_h16_tune import (CADENCE_S, N_G, build_blocked, cadence_case_at,
                          first_step_err)


def run(seed, warm_rho, budget, accel=20):
    scale = float(a1_params().total_mass) * 9.81
    x_warm = y_warm = None
    errs = []
    for k in range(10):
        case = cadence_case_at(k * CADENCE_S, seed)
        prob = build_blocked(case)
        oracle = cone_qp.solve(prob, iters=6000)
        if x_warm is None:
            sol = cone_qp.solve(prob, iters=3200, x0=gravity_warm_start(
                case[0], (prob.fz_hi > 0).astype(jnp.float32)
                .reshape(N_G, 4)))
        else:
            sol = cone_qp.solve(prob, iters=budget, alpha=1.0,
                                accel_restart=accel, rho=warm_rho,
                                x0=x_warm, y0=y_warm)
        x_warm, y_warm = sol.x, sol.y
        errs.append(first_step_err(sol.x, oracle.x, scale))
    return errs


def main():
    seeds = [0, 1, 2, 3]
    for budget in (24, 32, 48):
        for rho in (0.1, 0.15, 0.2, 0.3):
            ms = []
            for seed in seeds:
                ms.append(max(run(seed, rho, budget)))
            print(f"budget {budget} rho {rho}: max {max(ms) * 100:.2f}%  "
                  + " ".join(f"{m * 100:.1f}" for m in ms), flush=True)


if __name__ == "__main__":
    main()
