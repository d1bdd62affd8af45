import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.robots import a1_params, aliengo_params, lite3_params, kinematics as kin


@pytest.fixture(params=["a1", "aliengo", "lite3"])
def params(request):
    return {"a1": a1_params, "aliengo": aliengo_params,
            "lite3": lite3_params}[request.param]()


def sample_q(n, seed=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 4, 3), np.float32)
    q[..., 0] = rng.uniform(-0.5, 0.5, size=(n, 4))
    q[..., 1] = rng.uniform(0.2, 1.2, size=(n, 4))
    q[..., 2] = rng.uniform(-2.2, -0.7, size=(n, 4))
    return jnp.asarray(q.reshape(n, 12))


def test_fk_ik_roundtrip(params):
    q = sample_q(256)
    p = kin.foot_positions_in_base_frame(params, q)
    q2 = kin.joint_angles_from_foot_positions(params, p)
    np.testing.assert_allclose(q2, q, atol=2e-4)


def test_fk_stand_pose_reasonable(params):
    p = kin.foot_positions_in_base_frame(params, params.stand_angles)
    # Feet below the body, roughly under the hips.
    assert np.all(np.asarray(p[..., 2]) < -0.15)
    np.testing.assert_allclose(p[..., 0], params.hip_offset[:, 0], atol=0.15)


def test_jacobian_matches_autodiff(params):
    q = sample_q(32, seed=5)
    j_analytic = kin.all_leg_jacobians(params, q)

    def fk_flat(qi):
        return kin.foot_positions_in_base_frame(params, qi).reshape(12)

    j_auto = jax.vmap(jax.jacfwd(fk_flat))(q)  # [n, 12, 12]
    j_auto = j_auto.reshape(-1, 4, 3, 4, 3)
    # Per-leg block diagonal must match; cross-blocks are zero.
    for leg in range(4):
        np.testing.assert_allclose(j_analytic[:, leg], j_auto[:, leg, :, leg],
                                   atol=1e-4)


def test_foot_velocity_consistency(params):
    q = sample_q(16, seed=6)
    dq = jnp.asarray(np.random.default_rng(7).normal(size=(16, 12)) * 0.5,
                     jnp.float32)
    v = kin.foot_velocities_in_base_frame(params, q, dq)
    # Finite difference check.
    eps = 1e-4
    p0 = kin.foot_positions_in_base_frame(params, q)
    p1 = kin.foot_positions_in_base_frame(params, q + eps * dq)
    v_fd = (p1 - p0) / eps
    np.testing.assert_allclose(v, v_fd, atol=5e-3)


def test_torque_map_is_jacobian_transpose(params):
    q = sample_q(8, seed=8)
    f = jnp.asarray(np.random.default_rng(9).normal(size=(8, 4, 3)) * 10,
                    jnp.float32)
    tau = kin.map_contact_forces_to_torques(params, q, f)
    j = kin.all_leg_jacobians(params, q)
    expected = jnp.einsum("...lji,...lj->...li", j, f).reshape(8, 12)
    np.testing.assert_allclose(tau, expected, atol=1e-5)
    # Power consistency: tau . dq == f . (J dq)
    dq = jnp.asarray(np.random.default_rng(10).normal(size=(8, 12)), jnp.float32)
    v = kin.foot_velocities_in_base_frame(params, q, dq)
    np.testing.assert_allclose(jnp.sum(tau * dq, -1),
                               jnp.sum(f * v, (-2, -1)), rtol=1e-4, atol=1e-4)


def test_foot_force_estimate_inverts_torque_map(params):
    # F -> tau (J^T) -> F_hat (damped J^{-T}) must round-trip away from
    # singular configurations (reference ComputeMoment, qr_robot.cpp:74-85).
    q = sample_q(8, seed=11)
    f = jnp.asarray(np.random.default_rng(12).normal(size=(8, 4, 3)) * 20,
                    jnp.float32)
    tau = kin.map_contact_forces_to_torques(params, q, f)
    f_hat = kin.estimate_foot_forces_from_torques(params, q, tau)
    np.testing.assert_allclose(f_hat, f, rtol=2e-2, atol=0.3)


def test_estimate_moment_matches_reference_formula(params):
    q = sample_q(4, seed=13)
    tau = jnp.asarray(np.random.default_rng(14).normal(size=(4, 12)) * 5,
                      jnp.float32)
    m = kin.estimate_moment(params, q, tau)
    f = kin.estimate_foot_forces_from_torques(params, q, tau)
    p = kin.foot_positions_in_base_frame(params, q)
    expected = np.sum(np.cross(np.asarray(p), np.asarray(f)), axis=-2) \
        / np.asarray(f).sum(-2)
    np.testing.assert_allclose(m, expected, rtol=1e-3, atol=1e-3)
    assert np.all(np.isfinite(np.asarray(m)))
