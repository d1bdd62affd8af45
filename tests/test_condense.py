import jax.numpy as jnp
import numpy as np

from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, qp

H = 5


def build_model(seed=0):
    params = a1_params()
    rng = np.random.default_rng(seed)
    yaw = jnp.asarray(0.1, jnp.float32)
    feet = jnp.asarray([[0.18, -0.13, -0.28], [0.18, 0.13, -0.28],
                        [-0.18, -0.13, -0.28], [-0.18, 0.13, -0.28]],
                       jnp.float32)
    a, b = srb.srb_continuous(yaw, params.total_inertia, params.total_mass,
                              feet)
    ad, bd = srb.srb_discretize(a, b, 0.03)
    return params, ad, bd


def test_condensed_prediction_matches_rollout():
    params, ad, bd = build_model()
    aqp, bqp = condense.condense_dynamics(ad, bd, H)
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(np.concatenate([rng.normal(size=12) * 0.05, [-9.81]]),
                     jnp.float32)
    us = jnp.asarray(rng.normal(size=(H, 12)) * 10, jnp.float32)
    # Direct recursion.
    xs = []
    x = x0
    for k in range(H):
        x = ad @ x + bd @ us[k]
        xs.append(x)
    expected = jnp.stack(xs).reshape(-1)
    predicted = aqp @ x0 + bqp @ us.reshape(-1)
    np.testing.assert_allclose(predicted, expected, atol=1e-3, rtol=1e-4)


def test_cone_constraints_pin_swing_legs():
    params, ad, bd = build_model()
    mu = jnp.asarray(0.45, jnp.float32)
    fmax = params.max_force
    contact = jnp.ones((H, 4), jnp.float32).at[:, 1].set(0.0)  # FL swings
    a, l, u = condense.build_cone_constraints(mu, fmax, contact, H)
    assert a.shape == (condense.CONE_ROWS * 4 * H, 12 * H)
    u_rows = np.asarray(u).reshape(H, 4, condense.CONE_ROWS)
    assert np.all(u_rows[:, 1, 4] == 0.0)        # swing fz capped at 0
    assert np.all(u_rows[:, 0, 4] > 100.0)       # stance fz up to m*g


def test_mpc_qp_stand_solution_balances_gravity():
    """Standing still with zero velocity command: the QP should distribute
    weight over the four stance legs and keep tangential forces small."""
    params, ad, bd = build_model()
    x0 = srb.srb_initial_state(
        jnp.asarray([0.0, 0.0, 0.1]), jnp.asarray([0.0, 0.0, 0.28]),
        jnp.zeros(3), jnp.zeros(3))
    x_des = jnp.tile(x0, (H, 1))
    weights = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                          jnp.float32)
    contact = jnp.ones((H, 4), jnp.float32)
    prob = condense.condense_qp(ad, bd, x0, x_des, weights, 1e-5,
                                jnp.asarray(0.45), params.max_force,
                                contact, H)
    sol = qp.admm_solve(prob.p, prob.q, prob.a, prob.l, prob.u, iters=150)
    forces = np.asarray(sol.x).reshape(H, 4, 3)
    # First-step total vertical force (the forces actually applied) must
    # balance gravity; later steps legitimately taper (no terminal cost).
    total_fz = forces[0, :, 2].sum()
    weight = float(params.total_mass) * 9.81
    np.testing.assert_allclose(total_fz, weight, rtol=0.05)
    assert np.max(np.abs(forces[0, :, :2])) < 0.25 * weight
    # Feasibility wrt friction cones.
    _, prim, _ = qp.kkt_residuals(prob.p, prob.q, prob.a, prob.l, prob.u, sol)
    assert float(prim) < 1e-2


def test_structured_condensation_matches_generic():
    """The closed-form condensation (nilpotent SRB) must equal the generic
    power/Toeplitz build to f32 roundoff."""
    import numpy as np
    from quadruped_jax.core import se3

    params = a1_params()
    rng = np.random.default_rng(7)
    B = 4
    rpy = jnp.asarray(rng.normal(size=(B, 3)) * 0.1, jnp.float32)
    feet = jnp.asarray(
        rng.normal(size=(B, 4, 3)) * 0.05
        + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                    [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]),
        jnp.float32)
    x0 = jnp.asarray(
        np.concatenate([rng.normal(size=(B, 12)) * 0.05,
                        srb.GRAVITY * np.ones((B, 1))], 1), jnp.float32)
    x_des = jnp.asarray(rng.normal(size=(B, H, 13)) * 0.2, jnp.float32)
    w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                    jnp.float32)
    r = se3.rpy_to_rotmat(rpy)
    a_ct, b_ct = srb.srb_continuous(r, params.total_inertia,
                                    params.total_mass, feet)
    ad, bd = srb.srb_discretize(a_ct, b_ct, 0.03)
    p1, q1 = condense.condense_cost(ad, bd, x0, x_des, w, 4e-6, H)
    p2, q2 = condense.condense_cost_structured(a_ct, bd, ad, x0, x_des, w,
                                               4e-6, H, 0.03)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-7)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q2), atol=1e-6)
