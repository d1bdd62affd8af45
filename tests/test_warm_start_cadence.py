"""Warm-started solve quality at the MPC cadence, at the PRODUCTION budget.

The closed loop boots with one high-budget cold solve (MpcConfig
qp_cold_iters, mpc_cold_start) and then re-solves every 15 ticks from the
previous solution with qp_iters=24 Fast-ADMM iterations (the reference
hot-starts qpOASES the same way). This test drives a sequence of
slowly-varying MPC problems (as in a real trot) through exactly that
schedule and checks the production budget tracks the fully-converged
solution within control tolerance. Oracle-backed parity at the same
budgets lives in test_golden_parity.py::test_production_cadence_parity.
"""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control.mpc import MpcConfig
from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, cone_qp

H = 10
DT = 0.03
CFG = MpcConfig()


def solve_production(prob, iters, x0=None, y0=None):
    """The deployed solver configuration (MpcConfig defaults)."""
    return cone_qp.solve(prob, iters=iters, alpha=CFG.qp_alpha,
                         accel_restart=CFG.qp_accel_restart, x0=x0, y0=y0)


def problem_at(t, params, weights):
    """A slowly-varying trot-like MPC problem parameterized by time."""
    rpy = jnp.asarray([0.02 * np.sin(3 * t), 0.02 * np.cos(2 * t), 0.1 * t],
                      jnp.float32)
    r = se3.rpy_to_rotmat(rpy)
    feet = jnp.asarray(
        np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                  [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
        + 0.02 * np.sin(t * 5), jnp.float32)
    a, b = srb.srb_continuous(r, params.total_inertia, params.total_mass,
                              feet)
    ad, bd = srb.srb_discretize(a, b, DT)
    x0 = srb.srb_initial_state(
        rpy, jnp.asarray([0.4 * t, 0.0, 0.27 + 0.01 * np.sin(4 * t)]),
        jnp.asarray([0.0, 0.0, 0.1]), jnp.asarray([0.4, 0.0, 0.0]))
    x_des = jnp.tile(x0, (H, 1)).at[:, 9].set(0.4)
    p, q = condense.condense_cost(ad, bd, x0, x_des, weights, 4e-6, H)
    # Alternating diagonal contact (trot) advancing with t.
    phase = (np.arange(H) * DT / 0.6 + t / 0.6) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    contact = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a], axis=1)
    contact[0] = 1.0  # current tick in full stance for determinism
    fz_hi = jnp.asarray(contact.reshape(H * 4), jnp.float32) \
        * params.max_force
    return cone_qp.ConeQP(p=p, q=q, mu=jnp.asarray(0.45, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


def test_cadence_solves_track_converged():
    """Characterization on a deliberately hard sequence (the contact table
    flips diagonals every period and feet oscillate +/-2 cm per solve):
    the production schedule (cold qp_cold_iters boot, then warm qp_iters=24
    per solve) stays within 8% of m*g of the fully converged solution on
    first-step forces, warm starting does not destabilize across solves,
    and a cold 24-iteration solve is measurably worse — the reason the
    cold budget exists."""
    params = a1_params()
    weights = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                          jnp.float32)
    scale = float(params.total_mass) * 9.81
    x_warm = y_warm = None
    errs_warm = []
    errs_cold24 = []
    for k in range(8):
        prob = problem_at(0.03 * k, params, weights)
        ref = solve_production(prob, iters=1200)
        cold24 = solve_production(prob, iters=CFG.qp_iters)
        if x_warm is None:
            sol = cone_qp.solve(prob, iters=CFG.qp_cold_iters,
                                alpha=CFG.qp_cold_alpha, accel_restart=0)
        else:
            sol = solve_production(prob, iters=CFG.qp_iters,
                                   x0=x_warm, y0=y_warm)
        x_warm, y_warm = sol.x, sol.y
        errs_warm.append(float(jnp.max(jnp.abs(sol.x[:12] - ref.x[:12]))))
        errs_cold24.append(
            float(jnp.max(jnp.abs(cold24.x[:12] - ref.x[:12]))))
    assert max(errs_warm) < 0.08 * scale, errs_warm
    # No error explosion across the warm-started sequence.
    assert errs_warm[-1] < 2.5 * max(errs_warm[0], 1.0)
    # The production schedule beats an always-cold 24-iteration budget on
    # this hard sequence (documents why mpc_cold_start exists).
    assert max(errs_warm) < max(errs_cold24), (errs_warm, errs_cold24)
