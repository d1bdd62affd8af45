import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import optimize

from quadruped_jax.solvers import qp


def random_qp(n, m, seed, eq_rows=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, n))
    p = f @ f.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    a = rng.normal(size=(m, n))
    center = a @ rng.normal(size=n) * 0.1
    width = np.abs(rng.normal(size=m)) + 0.5
    l = center - width
    u = center + width
    for i in range(eq_rows):
        u[i] = l[i]
    return (p.astype(np.float32), q.astype(np.float32), a.astype(np.float32),
            l.astype(np.float32), u.astype(np.float32))


def scipy_solve(p, q, a, l, u):
    p, q, a, l, u = (np.asarray(m, np.float64) for m in (p, q, a, l, u))
    cons = [
        {"type": "ineq", "fun": lambda x, a=a, u=u: u - a @ x,
         "jac": lambda x, a=a: -a},
        {"type": "ineq", "fun": lambda x, a=a, l=l: a @ x - l,
         "jac": lambda x, a=a: a},
    ]
    res = optimize.minimize(
        lambda x: 0.5 * x @ p @ x + q @ x, np.zeros_like(q),
        jac=lambda x: p @ x + q, constraints=cons, method="SLSQP",
        options={"maxiter": 400, "ftol": 1e-12})
    assert res.success, res.message
    return res.x


def test_unconstrained_matches_linear_solve():
    p, q, a, l, u = random_qp(8, 4, seed=0)
    l[:] = -1e8
    u[:] = 1e8
    sol = qp.admm_solve(jnp.asarray(p), jnp.asarray(q), jnp.asarray(a),
                        jnp.asarray(l), jnp.asarray(u), iters=200)
    expected = np.linalg.solve(p, -q)
    np.testing.assert_allclose(sol.x, expected, atol=1e-3)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_inequality_qp_matches_scipy(seed):
    p, q, a, l, u = random_qp(6, 8, seed=seed)
    rho = qp.default_rho(jnp.asarray(l), jnp.asarray(u))
    sol = qp.admm_solve(jnp.asarray(p), jnp.asarray(q), jnp.asarray(a),
                        jnp.asarray(l), jnp.asarray(u), rho=rho, iters=400)
    expected = scipy_solve(p, q, a, l, u)
    np.testing.assert_allclose(sol.x, expected, atol=2e-3)


def test_equality_rows():
    p, q, a, l, u = random_qp(6, 5, seed=4, eq_rows=2)
    rho = qp.default_rho(jnp.asarray(l), jnp.asarray(u))
    sol = qp.admm_solve(jnp.asarray(p), jnp.asarray(q), jnp.asarray(a),
                        jnp.asarray(l), jnp.asarray(u), rho=rho, iters=500)
    # Equality rows satisfied tightly.
    ax = a @ np.asarray(sol.x)
    np.testing.assert_allclose(ax[:2], l[:2], atol=2e-3)
    expected = scipy_solve(p, q, a, l, u)
    np.testing.assert_allclose(sol.x, expected, atol=5e-3)


def test_batched_vmap_consistency():
    problems = [random_qp(6, 8, seed=s) for s in (5, 6, 7, 8)]
    stack = [jnp.asarray(np.stack([pr[i] for pr in problems])) for i in range(5)]
    rho = qp.default_rho(stack[3], stack[4])
    batched = jax.jit(lambda *ops: qp.admm_solve(*ops, rho=rho, iters=300))
    sol = batched(*stack)
    for i, pr in enumerate(problems):
        single = qp.admm_solve(*map(jnp.asarray, pr),
                               rho=qp.default_rho(jnp.asarray(pr[3]),
                                                  jnp.asarray(pr[4])),
                               iters=300)
        np.testing.assert_allclose(sol.x[i], single.x, atol=1e-4)


def test_friction_cone_projection_shape():
    # Force-balance style QP: 12 vars, friction pyramid per leg, desired
    # acceleration pushing into the ground -> nonzero vertical forces.
    n = 12
    rng = np.random.default_rng(9)
    p = np.eye(n, dtype=np.float32)
    q = -np.tile([0.0, 0.0, 30.0], 4).astype(np.float32)  # want fz ~ 30
    mu = 0.4
    rows = []
    for leg in range(4):
        base = np.zeros((5, n), np.float32)
        base[0, 3 * leg + 0] = 1; base[0, 3 * leg + 2] = mu
        base[1, 3 * leg + 0] = -1; base[1, 3 * leg + 2] = mu
        base[2, 3 * leg + 1] = 1; base[2, 3 * leg + 2] = mu
        base[3, 3 * leg + 1] = -1; base[3, 3 * leg + 2] = mu
        base[4, 3 * leg + 2] = 1
        rows.append(base)
    a = np.concatenate(rows)
    l = np.tile([0, 0, 0, 0, 0], 4).astype(np.float32)
    u = np.tile([1e8, 1e8, 1e8, 1e8, 25.0], 4).astype(np.float32)
    sol = qp.admm_solve(*map(jnp.asarray, (p, q, a, l, u)), iters=200)
    x = np.asarray(sol.x).reshape(4, 3)
    # fz clipped at bound 25, tangential ~0.
    np.testing.assert_allclose(x[:, 2], 25.0, atol=1e-2)
    np.testing.assert_allclose(x[:, :2], 0.0, atol=1e-2)
    s, pr, co = qp.kkt_residuals(*map(jnp.asarray, (p, q, a, l, u)), sol)
    assert float(pr) < 1e-3
