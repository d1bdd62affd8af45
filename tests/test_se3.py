import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import se3


def random_rpy(n, seed=0):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-1.0, 1.0, size=(n, 3))
    rpy[:, 1] *= 0.45 * np.pi  # keep pitch away from gimbal lock
    rpy[:, 0] *= np.pi * 0.9
    rpy[:, 2] *= np.pi * 0.9
    return jnp.asarray(rpy, dtype=jnp.float32)


def test_rpy_rotmat_roundtrip():
    rpy = random_rpy(64)
    r = se3.rpy_to_rotmat(rpy)
    back = se3.rotmat_to_rpy(r)
    np.testing.assert_allclose(back, rpy, atol=1e-5)


def test_rotmat_orthonormal():
    r = se3.rpy_to_rotmat(random_rpy(32))
    eye = jnp.broadcast_to(jnp.eye(3), r.shape)
    np.testing.assert_allclose(r @ jnp.swapaxes(r, -1, -2), eye, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(np.asarray(r)), 1.0, atol=1e-5)


def test_quat_roundtrips():
    rpy = random_rpy(128, seed=1)
    q = se3.rpy_to_quat(rpy)
    np.testing.assert_allclose(jnp.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    # quat -> rpy -> quat
    np.testing.assert_allclose(se3.quat_to_rpy(q), rpy, atol=1e-5)
    # quat -> rotmat agrees with rpy -> rotmat
    np.testing.assert_allclose(se3.quat_to_rotmat(q), se3.rpy_to_rotmat(rpy),
                               atol=1e-5)
    # rotmat -> quat roundtrip (up to sign, canonicalized w>=0)
    q2 = se3.rotmat_to_quat(se3.quat_to_rotmat(q))
    qc = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    np.testing.assert_allclose(q2, qc, atol=1e-4)


def test_quat_rotate_matches_matrix():
    rpy = random_rpy(32, seed=2)
    q = se3.rpy_to_quat(rpy)
    r = se3.rpy_to_rotmat(rpy)
    v = jnp.asarray(np.random.default_rng(3).normal(size=(32, 3)), jnp.float32)
    np.testing.assert_allclose(se3.quat_rotate(q, v),
                               jnp.einsum("...ij,...j->...i", r, v), atol=1e-5)


def test_skew_cross():
    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    np.testing.assert_allclose(
        jnp.einsum("...ij,...j->...i", se3.skew(a), b), jnp.cross(a, b),
        atol=1e-6)
    np.testing.assert_allclose(se3.unskew(se3.skew(a)), a, atol=1e-6)


def test_quat_integrate_constant_omega():
    q0 = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    omega = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)  # 1 rad/s yaw
    q = q0
    for _ in range(100):
        q = se3.quat_integrate(q, omega, 0.01)
    rpy = se3.quat_to_rpy(q)
    np.testing.assert_allclose(rpy, [0.0, 0.0, 1.0], atol=1e-4)


def test_quat_error_so3():
    rpy = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    rpy_des = jnp.asarray([0.1, -0.05, 0.2], jnp.float32)
    q = se3.rpy_to_quat(rpy)
    q_des = se3.rpy_to_quat(rpy_des)
    err = se3.quat_error_so3(q_des, q)
    # First-order: so3 error ~ rpy for small angles (second-order ~ 0.01).
    np.testing.assert_allclose(err, rpy_des, atol=0.02)
    # Exactness: rotating q by the error must reproduce q_des.
    angle = np.linalg.norm(np.asarray(err))
    axis_sin = np.asarray(err) / angle * np.sin(angle / 2)
    dq = jnp.asarray(np.concatenate([[np.cos(angle / 2)], axis_sin]),
                     jnp.float32)
    q_rebuilt = se3.quat_mul(q, dq)
    np.testing.assert_allclose(np.abs(np.asarray(q_rebuilt)),
                               np.abs(np.asarray(q_des)), atol=1e-5)
    # Zero error at identity
    np.testing.assert_allclose(se3.quat_error_so3(q, q), 0.0, atol=1e-6)


def test_jit_and_vmap():
    rpy = random_rpy(8)
    f = jax.jit(jax.vmap(se3.rpy_to_rotmat))
    np.testing.assert_allclose(f(rpy), se3.rpy_to_rotmat(rpy), atol=1e-6)


def test_inv3x3_matches_linalg():
    import numpy as np
    rng = np.random.default_rng(3)
    m = jnp.asarray(rng.normal(size=(64, 3, 3)).astype(np.float32))
    m = m @ jnp.swapaxes(m, -1, -2) + 0.5 * jnp.eye(3)  # SPD, well-conditioned
    got = se3.inv3x3(m)
    want = jnp.linalg.inv(m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=2e-4)
