"""H=16 move-blocked production-schedule tuning.

Round-3 finding (STATUS.md): the H=10-tuned ADMM settings do not transfer
to the H=16 move-blocked trot system — a cold relaxed solve needed > 1600
iterations to reach the 3% m*g gate on hard seeds. This experiment
separates the two halves of the production schedule and tunes each:

  1. COLD boot (one-off, untimed in the closed loop): how many relaxed
     iterations (and which rho / init) reach the gate at H=16-blocked?
  2. WARM cadence solves (the timed production path): with a converged
     boot, does a fixed small Fast-ADMM budget hold the gate across a
     15 ms cadence sequence with trot contact flips?

Oracle: OUR converged solve (6000 relaxed iterations) on the same blocked
system — the H=16 reference kernel is untrustworthy there (its production
nWSR=100 cap binds at 192 vars; tests/test_golden_parity.py
::test_long_horizon_blocked_consistency documents this), and the blocking
approximation itself is separately gated against the full 192-var system.

Run:  python benchmarks/exp_h16_tune.py
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

from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, cone_qp
from quadruped_jax.control.mpc import gravity_warm_start

H = 16
DT = 0.03
MU = 0.45
ALPHA = 4e-6
CADENCE_S = 0.015
WEIGHTS = np.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1],
                     np.float32)
GROUPS, N_G = condense.move_block_groups(H, 6, 2)


def cadence_case_at(t, seed=0):
    """H=16 version of the golden-parity cadence ensemble (same motion
    model, trot table with diagonal flips over the longer horizon)."""
    rng = np.random.default_rng(seed)
    params = a1_params()
    amp = rng.uniform(0.5, 1.0, size=4)
    rpy = np.array([0.04 * amp[0] * np.sin(3 * t),
                    0.04 * amp[1] * np.cos(2 * t), 0.15 * t])
    p = np.array([0.4 * t, 0.02 * np.sin(t), 0.27 + 0.01 * np.sin(4 * t)])
    v = np.array([0.4, 0.02 * np.cos(t), 0.04 * np.cos(4 * t)])
    w = np.array([0.1 * amp[2] * np.cos(3 * t),
                  0.1 * amp[3] * np.sin(2 * t), 0.15])
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    feet0 = np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                      [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
    feet = feet0 + 0.02 * np.sin(5 * t + np.arange(12).reshape(4, 3))
    r_mat = np.asarray(se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32)))
    feet_world = feet @ r_mat.T
    traj = np.zeros((H, 12), np.float32)
    traj[:, 0:3] = [0.0, 0.0, rpy[2]]
    traj[:, 3:6] = [p[0], p[1], 0.27]
    traj[:, 9] = 0.4
    for k in range(1, H):
        traj[k, 3] = traj[k - 1, 3] + DT * 0.4
        traj[k, 2] = traj[k - 1, 2] + DT * 0.15
    phase = (np.arange(H) * DT / 0.6 + t / 0.6) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    gait = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a],
                    axis=1).astype(np.float32)
    gait[0] = 1.0   # measured full stance at the solve tick
    return params, rpy, p, v, w, quat, feet_world, traj, gait


def build_blocked(case):
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
    p_r, q_r, fz_r = condense.reduce_move_blocking(pmat, qvec, fz_hi,
                                                   GROUPS, N_G, H)
    return cone_qp.ConeQP(p=p_r, q=q_r, mu=jnp.asarray(MU, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_r), fz_hi=fz_r)


def first_step_err(x, x_ref, scale):
    return float(np.abs(np.asarray(x[:12] - x_ref[:12])).max() / scale)


def main():
    seeds = [0, 1, 2, 3]
    scale = float(a1_params().total_mass) * 9.81

    print("=== 1. cold-boot budget at H=16 blocked (relaxed, gravity init)")
    for seed in seeds:
        case = cadence_case_at(0.0, seed)
        prob = build_blocked(case)
        oracle = cone_qp.solve(prob, iters=6000)
        o2 = cone_qp.solve(prob, iters=9000)
        drift = first_step_err(o2.x, oracle.x, scale)
        grav = gravity_warm_start(case[0], (prob.fz_hi > 0)
                                  .astype(jnp.float32).reshape(N_G, 4))
        row = [f"seed {seed} (oracle drift {drift * 100:.2f}%)"]
        for iters in (400, 800, 1600, 3200):
            sol = cone_qp.solve(prob, iters=iters, x0=grav)
            row.append(f"{iters}: {first_step_err(sol.x, oracle.x, scale) * 100:.2f}%")
        print("  " + "  ".join(row))

    print("=== 1b. cold-boot rho sweep (1600 iters)")
    for rho in (0.01, 0.02, 0.05, 0.1, 0.2):
        errs = []
        for seed in seeds:
            case = cadence_case_at(0.0, seed)
            prob = build_blocked(case)
            oracle = cone_qp.solve(prob, iters=6000)
            grav = gravity_warm_start(case[0], (prob.fz_hi > 0)
                                      .astype(jnp.float32).reshape(N_G, 4))
            sol = cone_qp.solve(prob, iters=1600, rho=rho, x0=grav)
            errs.append(first_step_err(sol.x, oracle.x, scale))
        print(f"  rho {rho}: max {max(errs) * 100:.2f}%  "
              + " ".join(f"{e * 100:.1f}" for e in errs))

    print("=== 2. warm cadence (converged boot, then fixed budgets)")
    for seed in seeds:
        for budget, accel in ((24, 20), (32, 20), (48, 20), (32, 0)):
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
                    if accel:
                        sol = cone_qp.solve(prob, iters=budget, alpha=1.0,
                                            accel_restart=accel,
                                            x0=x_warm, y0=y_warm)
                    else:
                        sol = cone_qp.solve(prob, iters=budget,
                                            x0=x_warm, y0=y_warm)
                x_warm, y_warm = sol.x, sol.y
                errs.append(first_step_err(sol.x, oracle.x, scale))
            tag = f"accel{accel}" if accel else "relaxed"
            print(f"  seed {seed} budget {budget} {tag}: "
                  f"max {max(errs) * 100:.2f}%  "
                  + " ".join(f"{e * 100:.1f}" for e in errs))


if __name__ == "__main__":
    main()
