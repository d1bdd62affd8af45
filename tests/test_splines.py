import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import splines


START = jnp.asarray([0.1, -0.1, -0.28], jnp.float32)
END = jnp.asarray([0.2, -0.12, -0.27], jnp.float32)
H = 0.09


@pytest.mark.parametrize("fn", [splines.swing_parabola, splines.swing_cubic,
                                splines.swing_bspline])
def test_swing_endpoints(fn):
    p0, _ = fn(START, END, H, jnp.float32(0.0))
    p1, _ = fn(START, END, H, jnp.float32(1.0 - 1e-6))
    np.testing.assert_allclose(p0, START, atol=2e-3)
    np.testing.assert_allclose(p1, END, atol=2e-3)


@pytest.mark.parametrize("fn", [splines.swing_parabola, splines.swing_cubic,
                                splines.swing_bspline])
def test_swing_clearance(fn):
    phi = jnp.linspace(0.0, 1.0 - 1e-6, 101)
    p, _ = fn(START, END, H, phi)
    apex = float(jnp.max(p[:, 2]))
    assert apex > float(jnp.maximum(START[2], END[2])) + 0.5 * H
    # Never digs below the endpoints line by much.
    assert float(jnp.min(p[:, 2])) > float(jnp.minimum(START[2], END[2])) - 0.02


def test_parabola_velocity_is_derivative():
    phi = jnp.linspace(0.05, 0.95, 64)
    p, v = splines.swing_parabola(START, END, H, phi)
    eps = 1e-3
    p2, _ = splines.swing_parabola(START, END, H, phi + eps)
    v_fd = (p2 - p) / eps
    np.testing.assert_allclose(v, v_fd, atol=5e-3)


def test_bspline_basis_partition_of_unity():
    phi = jnp.linspace(0.0, 0.999, 200)
    basis = splines.bspline_basis(phi)
    np.testing.assert_allclose(jnp.sum(basis, -1), 1.0, atol=1e-5)
    assert float(jnp.min(basis)) >= -1e-6


def test_cubic_hermite_boundaries():
    p, v = splines.cubic_hermite(0.0, 1.0, 2.0, -1.0, jnp.asarray(0.0))
    np.testing.assert_allclose([p, v], [0.0, 1.0], atol=1e-6)
    p, v = splines.cubic_hermite(0.0, 1.0, 2.0, -1.0, jnp.asarray(1.0))
    np.testing.assert_allclose([p, v], [2.0, -1.0], atol=1e-6)


def test_phase_remap_monotone_endpoints():
    np.testing.assert_allclose(splines.phase_remap(jnp.asarray(0.0)), 0.0, atol=1e-6)
    np.testing.assert_allclose(splines.phase_remap(jnp.asarray(1.0)), 1.0, atol=1e-6)
