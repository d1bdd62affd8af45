import jax.numpy as jnp
import numpy as np

from quadruped_jax.core import se3
from quadruped_jax.dynamics import spatial as sp


def rand_rot(seed=0):
    rng = np.random.default_rng(seed)
    return se3.rpy_to_rotmat(jnp.asarray(rng.uniform(-1, 1, 3), jnp.float32))


def test_transform_inverse():
    e = rand_rot(1)
    r = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    x = sp.spatial_transform(e, r)
    xi = sp.transform_inverse(x)
    np.testing.assert_allclose(np.asarray(x @ xi), np.eye(6), atol=1e-5)
    np.testing.assert_allclose(np.asarray(xi @ x), np.eye(6), atol=1e-5)


def test_translation_part_roundtrip():
    e = rand_rot(2)
    r = jnp.asarray([0.3, 0.1, -0.4], jnp.float32)
    x = sp.spatial_transform(e, r)
    np.testing.assert_allclose(sp.rotation_part(x), e, atol=1e-6)
    np.testing.assert_allclose(sp.translation_part(x), r, atol=1e-5)


def test_motion_cross_matches_matrix():
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.normal(size=6), jnp.float32)
    m = jnp.asarray(rng.normal(size=6), jnp.float32)
    full = sp.motion_cross_matrix(v) @ m
    fast = sp.motion_cross(v, m)
    np.testing.assert_allclose(fast, full, atol=1e-5)
    f = jnp.asarray(rng.normal(size=6), jnp.float32)
    np.testing.assert_allclose(sp.force_cross(v, f),
                               sp.force_cross_matrix(v) @ f, atol=1e-5)


def test_force_cross_is_negative_transpose():
    rng = np.random.default_rng(4)
    v = jnp.asarray(rng.normal(size=6), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(sp.force_cross_matrix(v)),
        -np.asarray(sp.motion_cross_matrix(v)).T, atol=1e-6)


def test_spatial_inertia_kinetic_energy():
    """KE from the 6x6 spatial inertia == translational + rotational parts
    computed longhand."""
    rng = np.random.default_rng(5)
    mass = 2.5
    com = jnp.asarray([0.02, -0.01, 0.05], jnp.float32)
    a = rng.normal(size=(3, 3))
    i_com = jnp.asarray(a @ a.T + np.eye(3) * 0.1, jnp.float32)
    inertia = sp.spatial_inertia(mass, com, i_com)
    # Symmetric PSD.
    np.testing.assert_allclose(np.asarray(inertia),
                               np.asarray(inertia).T, atol=1e-6)
    assert np.linalg.eigvalsh(np.asarray(inertia)).min() > 0
    w = np.asarray([0.3, -0.2, 0.5])
    vlin = np.asarray([0.1, 0.4, -0.3])
    v6 = jnp.asarray(np.concatenate([w, vlin]), jnp.float32)
    ke_spatial = 0.5 * float(v6 @ inertia @ v6)
    v_com = vlin + np.cross(w, np.asarray(com))
    ke_long = 0.5 * mass * v_com @ v_com + 0.5 * w @ np.asarray(i_com) @ w
    np.testing.assert_allclose(ke_spatial, ke_long, rtol=1e-5)


def test_flip_along_y_preserves_mass_and_diagonal():
    mass = 1.0
    com = jnp.asarray([0.01, 0.02, -0.03], jnp.float32)
    i_com = jnp.asarray([[1.0, 0.2, 0.3], [0.2, 2.0, 0.4], [0.3, 0.4, 3.0]],
                        jnp.float32)
    m2, com2, i2 = sp.flip_inertia_along_y(mass, com, i_com)
    assert m2 == mass
    np.testing.assert_allclose(com2, [0.01, -0.02, -0.03], atol=1e-6)
    np.testing.assert_allclose(np.diag(i2), np.diag(i_com), atol=1e-6)
    # Products of inertia involving y flip sign.
    np.testing.assert_allclose(i2[0, 1], -i_com[0, 1], atol=1e-6)
    np.testing.assert_allclose(i2[1, 2], -i_com[1, 2], atol=1e-6)
    np.testing.assert_allclose(i2[0, 2], i_com[0, 2], atol=1e-6)


def test_joint_transform_composition():
    """X_child_from_parent for a revolute joint: rotating the joint by theta
    then transforming a motion vector matches the rotated frame."""
    theta = jnp.asarray(0.7, jnp.float32)
    xj = sp.joint_transform_revolute(1, theta)  # about y
    # A pure angular motion about y is invariant.
    v = jnp.asarray([0.0, 1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    np.testing.assert_allclose(xj @ v, v, atol=1e-6)
    # Composition of two half-angles equals the full angle.
    xj_half = sp.joint_transform_revolute(1, theta / 2)
    np.testing.assert_allclose(np.asarray(xj_half @ xj_half),
                               np.asarray(xj), atol=1e-5)
