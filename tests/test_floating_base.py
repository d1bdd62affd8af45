"""Cross-validation tests for the batched Featherstone dynamics.

The reference has no automated tests (SURVEY.md §4); correctness here rests
on physics invariants and cross-algorithm consistency:
  * CRBA mass matrix is symmetric positive definite with the right total mass
    in its linear block;
  * RNEA bias forces match autodiff of the Lagrangian quantities
    (finite-difference energy checks);
  * contact Jacobians match finite differences of foot world positions;
  * forward dynamics (mass-matrix route) inverts inverse dynamics exactly —
    the same invariant as the reference's disabled `test_fb` golden check
    (qr_robot_a1_sim.cpp:344-399).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import se3
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.robots import a1_params, kinematics as kin


@pytest.fixture(scope="module")
def model():
    return fb.build_model(a1_params())


def rand_state(seed=0, zero_vel=False):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-0.3, 0.3, 3)
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    q = np.concatenate([rng.uniform([-0.4, 0.3, -2.0], [0.4, 1.1, -0.9])
                        for _ in range(4)])
    dq = np.zeros(12) if zero_vel else rng.normal(size=12) * 2.0
    w = np.zeros(3) if zero_vel else rng.normal(size=3) * 0.5
    v = np.zeros(3) if zero_vel else rng.normal(size=3) * 0.5
    return fb.FbState(
        quat=jnp.asarray(quat, jnp.float32),
        position=jnp.asarray(rng.normal(size=3) * 0.1 + [0, 0, 0.3],
                             jnp.float32),
        omega_body=jnp.asarray(w, jnp.float32),
        vel_body=jnp.asarray(v, jnp.float32),
        q=jnp.asarray(q, jnp.float32),
        dq=jnp.asarray(dq, jnp.float32))


def test_mass_matrix_spd_and_total_mass(model):
    params = a1_params()
    state = rand_state(0)
    h = np.asarray(fb.mass_matrix(model, state.q), np.float64)
    np.testing.assert_allclose(h, h.T, atol=1e-4)
    eig = np.linalg.eigvalsh(h)
    assert eig.min() > 0
    # Linear-linear block of the 6x6 base inertia = total mass * I3.
    total = float(params.body_mass + 4 * params.links_mass.sum())
    np.testing.assert_allclose(h[3:6, 3:6], np.eye(3) * total, atol=1e-4)


def test_gravity_matches_potential_gradient(model):
    """G(q) must equal d(potential)/d(coordinates) — checked through virtual
    work: for any virtual velocity, G . v == -d/dt m g . h along that v."""
    state = rand_state(1, zero_vel=True)
    g = fb.gravity_force(model, state)

    def potential(q, pos, quat):
        # Total potential energy from per-body CoM heights.
        st = fb.FbState(quat=quat, position=pos,
                        omega_body=jnp.zeros(3), vel_body=jnp.zeros(3),
                        q=q, dq=jnp.zeros(12))
        rots, poss, _ = fb._world_rotations_positions(model, st)
        e = 0.0
        for i in range(fb.NUM_BODIES):
            inertia = model.inertias[i]
            m = inertia[5, 5]
            # Extract m*c from the top-right block: m*skew(c).
            blk = inertia[0:3, 3:6]
            mcom = jnp.stack([blk[2, 1], blk[0, 2], blk[1, 0]])
            com_world = poss[i] + rots[i] @ (mcom / m)
            e = e + m * 9.81 * com_world[2]
        return e

    # Joint-space check via autodiff.
    dV = jax.grad(lambda q: potential(q, state.position, state.quat))(state.q)
    np.testing.assert_allclose(g[6:], dV, atol=2e-3)
    # Base linear part: gravity force in body frame = -m_total g R^T e_z...
    r = se3.quat_to_rotmat(state.quat)
    params = a1_params()
    total = float(params.body_mass + 4 * params.links_mass.sum())
    expect_lin = -(r.T @ jnp.asarray([0.0, 0.0, -9.81])) * total
    np.testing.assert_allclose(g[3:6], expect_lin, atol=2e-3)


def test_contact_jacobian_finite_difference(model):
    state = rand_state(2, zero_vel=True)
    jc, _, p_feet = fb.contact_jacobians(model, state)

    # Perturb joints.
    eps = 1e-4
    for ji in [0, 4, 8, 11]:
        dq = jnp.zeros(12).at[ji].set(eps)
        st2 = state.replace(q=state.q + dq)
        p2 = fb.foot_positions_world(model, st2)
        fd = (p2 - p_feet) / eps
        np.testing.assert_allclose(jc[:, :, 6 + ji], fd, atol=1e-2)

    # Perturb base linear velocity: columns 3:6 rotate body velocity.
    r = se3.quat_to_rotmat(state.quat)
    np.testing.assert_allclose(jc[:, :, 3:6],
                               jnp.broadcast_to(r, (4, 3, 3)), atol=1e-5)

    # Base angular columns: v = R (w_b x r_b).
    for ax in range(3):
        wb = jnp.zeros(3).at[ax].set(1.0)
        for leg in range(4):
            r_b = r.T @ (p_feet[leg] - state.position)
            expect = r @ jnp.cross(wb, r_b)
            np.testing.assert_allclose(jc[leg, :, ax], expect, atol=1e-4)


def test_forward_inverse_dynamics_roundtrip(model):
    state = rand_state(3)
    rng = np.random.default_rng(4)
    qdd = jnp.asarray(rng.normal(size=18), jnp.float32)
    tau = fb.inverse_dynamics(model, state, qdd)
    qdd_back = fb.forward_dynamics(model, state, tau)
    np.testing.assert_allclose(qdd_back, qdd, atol=5e-3)


def test_coriolis_zero_at_rest(model):
    state = rand_state(5, zero_vel=True)
    c = fb.coriolis_force(model, state)
    np.testing.assert_allclose(c, 0.0, atol=1e-5)


def test_foot_positions_match_analytic_kinematics(model):
    """The Featherstone foot points must agree with the analytic leg FK
    (up to the 4 mm knee-link lateral offset of the contact point)."""
    params = a1_params()
    state = rand_state(6, zero_vel=True)
    p_fb = fb.foot_positions_world(model, state)
    p_base = kin.foot_positions_in_base_frame(params, state.q)
    r = se3.quat_to_rotmat(state.quat)
    p_world = state.position + jnp.einsum("ij,lj->li", r, p_base)
    np.testing.assert_allclose(p_fb, p_world, atol=6e-3)


def test_energy_conservation_free_fall(model):
    """Simulate the unactuated model under gravity; total energy must be
    conserved (the reference's disabled test_fb energy check)."""
    state = rand_state(7)
    dt = 5e-4

    def energy(st):
        h = fb.mass_matrix(model, st.q)
        vgen = jnp.concatenate([st.omega_body, st.vel_body, st.dq])
        ke = 0.5 * vgen @ h @ vgen
        rots, poss, _ = fb._world_rotations_positions(model, st)
        pe = 0.0
        for i in range(fb.NUM_BODIES):
            inertia = model.inertias[i]
            m = inertia[5, 5]
            blk = inertia[0:3, 3:6]
            mcom = jnp.stack([blk[2, 1], blk[0, 2], blk[1, 0]])
            com_world = poss[i] + rots[i] @ (mcom / m)
            pe = pe + m * 9.81 * com_world[2]
        return ke + pe

    def step(st, _):
        qdd = fb.forward_dynamics(model, st, jnp.zeros(18))
        w = st.omega_body + qdd[0:3] * dt
        v = st.vel_body + qdd[3:6] * dt
        dq = st.dq + qdd[6:] * dt
        quat = se3.quat_integrate(st.quat, st.omega_body, dt)
        r = se3.quat_to_rotmat(st.quat)
        pos = st.position + r @ st.vel_body * dt
        return st.replace(quat=quat, position=pos, omega_body=w, vel_body=v,
                          q=st.q + st.dq * dt, dq=dq), None

    e0 = float(energy(state))
    final, _ = jax.lax.scan(step, state, None, length=100)
    e1 = float(energy(final))
    assert abs(e1 - e0) < 0.05 * abs(e0) + 0.5
