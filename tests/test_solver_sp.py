"""The sp-sharded cone solve (distributed/solver_sp.py) must agree with
the unsharded reference solver on the same batch: the variable-axis
partition + per-iteration psum is an exact reformulation, so tolerance is
float-roundoff tight, warm and cold, relaxed and accelerated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.distributed import make_mesh
from quadruped_jax.distributed.solver_sp import solve_cone_sp
from quadruped_jax.dynamics import srb
from quadruped_jax.core import se3
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, cone_qp

H = 10


def make_probs(b, seed=0):
    rng = np.random.default_rng(seed)
    params = a1_params()

    def one(i):
        rpy = jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)
        r = se3.rpy_to_rotmat(rpy)
        feet = jnp.asarray(
            rng.normal(size=(4, 3)) * 0.03
            + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]),
            jnp.float32)
        a, bmat = srb.srb_continuous(r, params.total_inertia,
                                     params.total_mass, feet)
        ad, bd = srb.srb_discretize(a, bmat, 0.03)
        x0 = srb.srb_initial_state(
            rpy, jnp.asarray([0.0, 0.0, 0.27], jnp.float32),
            jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32),
            jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32))
        x_des = jnp.tile(x0, (H, 1)).at[:, 9].set(0.4)
        w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                        jnp.float32)
        p, q = condense.condense_cost(ad, bd, x0, x_des, w, 4e-6, H)
        # Trot-ish table with pinned triples.
        gait = (rng.uniform(size=(H, 4)) > 0.4).astype(np.float32)
        gait[0] = 1.0
        fz_hi = jnp.asarray(gait.reshape(H * 4), jnp.float32) \
            * params.max_force
        return p, q, fz_hi

    ps, qs, fzs = zip(*[one(i) for i in range(b)])
    return cone_qp.ConeQP(
        p=jnp.stack(ps), q=jnp.stack(qs),
        mu=jnp.asarray(0.45, jnp.float32),
        fz_lo=jnp.zeros((b, H * 4), jnp.float32), fz_hi=jnp.stack(fzs))


@pytest.mark.parametrize("sp,accel", [(2, 20), (4, 20), (4, 0)])
def test_sp_sharded_matches_unsharded(sp, accel):
    """Solve-QUALITY parity: the sharded solver must land as close to the
    converged solution as the unsharded one at the same budget. (Bitwise
    iterate comparison is the wrong gate: the psum of column-block partial
    matvecs reassociates f32 sums, and ADMM's slow contraction amplifies
    ~1e-5 reassociation noise into ~1 N on truncated iterates — measured;
    both iterates track the SAME trajectory, equidistant from the
    optimum.)"""
    assert jax.device_count() >= 8
    b = 8
    prob = make_probs(b)
    alpha = 1.0 if accel else 1.6
    conv = cone_qp.solve(prob, iters=2000)
    ref = cone_qp.solve(prob, iters=24, alpha=alpha, accel_restart=accel)
    mesh = make_mesh(8, sp=sp)
    got = solve_cone_sp(mesh, prob, iters=24, alpha=alpha,
                        accel_restart=accel)
    err_ref = np.abs(np.asarray(ref.x) - np.asarray(conv.x)).max()
    err_got = np.abs(np.asarray(got.x) - np.asarray(conv.x)).max()
    assert err_got < err_ref * 1.2 + 0.5, (err_got, err_ref)
    # And the iterates themselves stay within the amplified-roundoff band.
    assert np.abs(np.asarray(got.x) - np.asarray(ref.x)).max() < 2.0


def test_sp_sharded_warm_start():
    """Warm-started (the production path): near the fixed point the
    amplification is mild and the sharded solve tracks tightly."""
    b = 8
    prob = make_probs(b, seed=3)
    cold = cone_qp.solve(prob, iters=400, alpha=1.6)
    conv = cone_qp.solve(prob, iters=2000)
    ref = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20,
                        x0=cold.x, y0=cold.y)
    mesh = make_mesh(8, sp=4)
    got = solve_cone_sp(mesh, prob, iters=24, x0=cold.x, y0=cold.y)
    err_ref = np.abs(np.asarray(ref.x) - np.asarray(conv.x)).max()
    err_got = np.abs(np.asarray(got.x) - np.asarray(conv.x)).max()
    assert err_got < err_ref * 1.2 + 0.5, (err_got, err_ref)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               atol=1.0)
