"""H=16 force-regularizer (alpha) study.

Hypothesis: the 4-8% warm plateau at H=16 is a near-nullspace effect —
the reference's alpha=4e-6 force regularizer leaves directions with
curvature ~alpha that ADMM drains at ~1 bit / 300 iterations, but whose
position DOES move first-step forces. Raising alpha improves kappa
directly; the question is how far the converged optimum moves (the
modeling error of the stronger regularizer) vs how much the fixed-budget
convergence improves.

For each alpha: oracle = converged solve of the alpha'd problem;
reported are (a) warm-32 error vs that oracle on the worst cadence step,
(b) the converged first-step force shift vs the alpha=4e-6 oracle —
(b) is the price, (a) the payoff.

Run:  python benchmarks/exp_h16_alpha.py
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

from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, cone_qp
from quadruped_jax.control.mpc import gravity_warm_start

from exp_h16_tune import CADENCE_S, GROUPS, N_G, cadence_case_at, \
    first_step_err

H = 16
DT = 0.03
MU = 0.45
WEIGHTS = np.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1],
                     np.float32)


def build_blocked_alpha(case, alpha):
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
                                        alpha, H)
    fz_hi = jnp.asarray(gait.reshape(H * 4), jnp.float32) * params.max_force
    p_r, q_r, fz_r = condense.reduce_move_blocking(pmat, qvec, fz_hi,
                                                   GROUPS, N_G, H)
    return cone_qp.ConeQP(p=p_r, q=q_r, mu=jnp.asarray(MU, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_r), fz_hi=fz_r)


def run_cadence_alpha(seed, alpha, budget=32):
    scale = float(a1_params().total_mass) * 9.81
    x = y = None
    errs = []
    shifts = []
    for k in range(10):
        case = cadence_case_at(k * CADENCE_S, seed)
        prob = build_blocked_alpha(case, alpha)
        oracle = cone_qp.solve(prob, iters=6000)
        base = cone_qp.solve(build_blocked_alpha(case, 4e-6), iters=6000)
        shifts.append(first_step_err(oracle.x, base.x, scale))
        if x is None:
            sol = cone_qp.solve(prob, iters=3200, x0=gravity_warm_start(
                a1_params(), (prob.fz_hi > 0).astype(jnp.float32)
                .reshape(N_G, 4)))
        else:
            sol = cone_qp.solve(prob, iters=budget, alpha=1.0,
                                accel_restart=20, x0=x, y0=y)
        x, y = sol.x, sol.y
        errs.append(first_step_err(sol.x, oracle.x, scale))
    return errs, shifts


def main():
    for alpha in (4e-6, 1e-4, 1e-3, 1e-2):
        for seed in (0, 1, 3):
            errs, shifts = run_cadence_alpha(seed, alpha)
            print(f"alpha {alpha:g} seed {seed}: warm32 max "
                  f"{max(errs) * 100:.2f}% "
                  f"(steps: {' '.join(f'{e * 100:.1f}' for e in errs)}); "
                  f"optimum shift max {max(shifts) * 100:.2f}%",
                  flush=True)


if __name__ == "__main__":
    main()
