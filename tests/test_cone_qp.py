import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, qp, cone_qp

H = 5


def build_problem(contact_row=None, yaw=0.1, seed=0):
    params = a1_params()
    rng = np.random.default_rng(seed)
    feet = jnp.asarray(
        rng.normal(size=(4, 3)) * 0.03
        + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                    [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]), jnp.float32)
    a, b = srb.srb_continuous(jnp.asarray(yaw, jnp.float32),
                              params.total_inertia, params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, b, 0.03)
    x0 = srb.srb_initial_state(
        jnp.asarray(rng.normal(3) * 0.05 * np.ones(3), jnp.float32),
        jnp.asarray([0.0, 0.0, 0.28], jnp.float32),
        jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32),
        jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32))
    x_des = jnp.tile(x0, (H, 1)).at[:, 9].set(0.5)  # want some vx
    w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                    jnp.float32)
    contact = jnp.ones((H, 4), jnp.float32)
    if contact_row is not None:
        contact = contact.at[:, contact_row].set(0.0)
    prob_dense = condense.condense_qp(ad, bd, x0, x_des, w, 4e-6,
                                      jnp.asarray(0.45), params.max_force,
                                      contact, H)
    fz_hi = (contact * params.max_force).reshape(H * 4)
    prob_cone = cone_qp.ConeQP(p=prob_dense.p, q=prob_dense.q,
                               mu=jnp.asarray(0.45, jnp.float32),
                               fz_lo=jnp.zeros(H * 4),
                               fz_hi=fz_hi)
    return prob_dense, prob_cone


def test_newton_schulz_inverse():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(4, 24, 24)).astype(np.float32)
    m = jnp.asarray(f @ np.swapaxes(f, -1, -2) + 0.5 * np.eye(24))
    # Normalize conditioning similar to an equilibrated M.
    x = cone_qp.newton_schulz_inverse(m, iters=20)
    eye = jnp.broadcast_to(jnp.eye(24), m.shape)
    np.testing.assert_allclose(np.asarray(x @ m), np.asarray(eye), atol=5e-3)


def test_cone_solver_matches_dense_solver():
    prob_dense, prob_cone = build_problem()
    sol_dense = qp.admm_solve(prob_dense.p, prob_dense.q, prob_dense.a,
                              prob_dense.l, prob_dense.u, iters=2000)
    sol_cone = cone_qp.solve(prob_cone, iters=400)
    f_dense = np.asarray(sol_dense.x).reshape(H, 4, 3)
    f_cone = np.asarray(sol_cone.x).reshape(H, 4, 3)
    # First-step forces (the ones applied to the robot) must agree.
    np.testing.assert_allclose(f_cone[0], f_dense[0], atol=1.0)
    assert float(sol_cone.prim_res) < 1e-2


def test_cone_solver_pins_swing_legs():
    _, prob_cone = build_problem(contact_row=1)
    sol = cone_qp.solve(prob_cone, iters=200)
    f = np.asarray(sol.x).reshape(H, 4, 3)
    np.testing.assert_allclose(f[:, 1, :], 0.0, atol=1e-2)
    # Friction cone feasibility everywhere.
    assert float(sol.prim_res) < 1e-2
    fz = f[:, :, 2]
    assert fz.min() > -1e-2
    assert np.all(np.abs(f[:, :, 0]) <= 0.45 * fz + 0.05)


def test_cone_solver_batched():
    _, p0 = build_problem(seed=3)
    _, p1 = build_problem(contact_row=2, seed=4)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), p0, p1)
    # ns_f32_polish=2 converges the inverse to ~1e-8 so the batched and
    # single solves agree regardless of XLA fusion-order rounding (the
    # production polish=1 inverse is ~1e-4-accurate, which 200 ADMM
    # iterations amplify past this test's tolerance).
    sol = jax.jit(lambda pr: cone_qp.solve(pr, iters=200,
                                           ns_f32_polish=2))(stacked)
    s0 = cone_qp.solve(p0, iters=200, ns_f32_polish=2)
    s1 = cone_qp.solve(p1, iters=200, ns_f32_polish=2)
    np.testing.assert_allclose(sol.x[0], s0.x, atol=5e-3)
    np.testing.assert_allclose(sol.x[1], s1.x, atol=5e-3)


def test_accelerated_budget_matches_relaxed_40():
    """Fast-ADMM (accel_restart=20, alpha=1) at the production 24-iter
    budget bounds the WORST-case truncation error at least as well as
    the former relaxed 40-iteration scheme over an ensemble of
    contact-switching instances (benchmarks/exp_admm_iters.py measured
    ~30N vs ~35N max on the hard H=10 ensemble; per-EASY-instance the
    relaxed scheme can be closer, but the tail governs closed-loop
    stability and cadence re-solves are warm-started anyway)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks"))
    from exp_admm_iters import build_ensemble

    prob = build_ensemble(32, hard=True, seed=1)
    ref = np.asarray(cone_qp.solve(prob, iters=1500).x)
    old = np.asarray(cone_qp.solve(prob, iters=40).x)
    new = np.asarray(cone_qp.solve(prob, iters=24, alpha=1.0,
                                   accel_restart=20).x)
    err_old = np.abs(old - ref).max()
    err_new = np.abs(new - ref).max()
    assert err_new <= err_old * 1.05, (err_new, err_old)


def test_accelerated_warm_start_composes():
    """Warm starting from a previous accelerated solution keeps the
    accelerated re-solve at or beyond cold accuracy (momentum starts at
    rest, so x0/y0 carry over unchanged)."""
    _, prob = build_problem(seed=9)
    ref = np.asarray(cone_qp.solve(prob, iters=3000).x)
    cold = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20)
    warm = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20,
                         x0=cold.x, y0=cold.y)
    err_cold = np.abs(np.asarray(cold.x) - ref).max()
    err_warm = np.abs(np.asarray(warm.x) - ref).max()
    assert err_warm <= err_cold * 1.05, (err_warm, err_cold)
