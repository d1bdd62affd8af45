"""H=16 warm-cadence stall isolation.

exp_h16_tune.py showed warm-started cadence solves at H=16-blocked
plateau at 4-8% of m*g regardless of budget (24 vs 48 vs relaxed nearly
identical) — not a truncation error. This script isolates the cause:

  A. Is it the BLOCKING?  Run the same cadence warm on the FULL (192-var)
     H=16 system.
  B. Is it the carried DUALS?  Reset duals on triples whose pin status
     changed between problems (the 100x rho-boosted fz rows make y jump).
  C. Is it rho?  Warm rho sweep.
  D. How slow is the stalled mode?  Error vs budget 32 -> 1600 on the
     worst step.

Run:  python benchmarks/exp_h16_warm.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

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
from quadruped_jax.solvers import condense
from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb

H = 16
DT = 0.03
MU = 0.45
ALPHA = 4e-6
WEIGHTS = np.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1],
                     np.float32)


def build_full(case):
    params, rpy, p, v, w, quat, feet_world, traj, gait = case
    r_mat = se3.quat_to_rotmat(jnp.asarray(quat, jnp.float32))
    a, b = srb.srb_continuous(r_mat, params.total_inertia,
                              params.total_mass,
                              jnp.asarray(feet_world, jnp.float32))
    ad, bd = srb.srb_discretize(a, b, DT)
    x0 = jnp.asarray(np.concatenate([rpy, p, w, v, [srb.GRAVITY]]),
                     jnp.float32)
    x_des = jnp.concatenate([jnp.asarray(traj, jnp.float32),
                             jnp.full((H, 1), srb.GRAVITY)], axis=-1)
    weights13 = jnp.asarray(np.concatenate([WEIGHTS, [0.0]]), jnp.float32)
    pmat, qvec = condense.condense_cost(ad, bd, x0, x_des, weights13,
                                        ALPHA, H)
    fz_hi = jnp.asarray(gait.reshape(H * 4), jnp.float32) * params.max_force
    return cone_qp.ConeQP(p=pmat, q=qvec, mu=jnp.asarray(MU, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


def run_cadence(seed, build, n_t, budget=32, rho=cone_qp.RHO_CONE,
                dual_reset=False):
    scale = float(a1_params().total_mass) * 9.81
    x_warm = y_warm = None
    prev_pin = None
    errs = []
    for k in range(10):
        case = cadence_case_at(k * CADENCE_S, seed)
        prob = build(case)
        oracle = cone_qp.solve(prob, iters=6000, rho=rho)
        pin = np.asarray(prob.fz_hi < 1e-6)
        if x_warm is None:
            sol = cone_qp.solve(prob, iters=3200, rho=rho,
                                x0=gravity_warm_start(
                                    case[0], (prob.fz_hi > 0)
                                    .astype(jnp.float32).reshape(n_t, 4)))
        else:
            if dual_reset and prev_pin is not None:
                changed = jnp.asarray((pin != prev_pin).astype(np.float32))
                y_warm = y_warm * (1.0 - changed[:, None])
                x_warm = x_warm * jnp.repeat(
                    1.0 - jnp.asarray(pin, jnp.float32), 3)
            sol = cone_qp.solve(prob, iters=budget, alpha=1.0,
                                accel_restart=20, rho=rho,
                                x0=x_warm, y0=y_warm)
        x_warm, y_warm = sol.x, sol.y
        prev_pin = pin
        errs.append(first_step_err(sol.x, oracle.x, scale))
    return errs


def main():
    seeds = [0, 1, 3]

    print("=== A. full (unblocked) H=16, warm budget 32")
    for seed in seeds:
        errs = run_cadence(seed, build_full, H)
        print(f"  seed {seed}: max {max(errs) * 100:.2f}%  "
              + " ".join(f"{e * 100:.1f}" for e in errs))

    print("=== B. blocked + dual/pinned-primal reset on pin change")
    for seed in seeds:
        errs = run_cadence(seed, build_blocked, N_G, dual_reset=True)
        print(f"  seed {seed}: max {max(errs) * 100:.2f}%  "
              + " ".join(f"{e * 100:.1f}" for e in errs))

    print("=== C. blocked warm rho sweep (budget 32)")
    for rho in (0.02, 0.05, 0.1):
        ms = []
        for seed in seeds:
            errs = run_cadence(seed, build_blocked, N_G, rho=rho)
            ms.append(max(errs))
        print(f"  rho {rho}: " + " ".join(f"{m * 100:.1f}" for m in ms))

    print("=== D. blocked, budget scaling on seed 0")
    for budget in (32, 100, 400, 1600):
        errs = run_cadence(0, build_blocked, N_G, budget=budget)
        print(f"  budget {budget}: max {max(errs) * 100:.2f}%  "
              + " ".join(f"{e * 100:.1f}" for e in errs))


if __name__ == "__main__":
    main()
