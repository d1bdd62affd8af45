"""core/linalg.py: block-Schur SPD inverse + damped pseudo-inverse."""

import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import linalg


def _random_spd(n, batch=(), seed=0, cond=100.0):
    rng = np.random.default_rng(seed + n)
    a = rng.normal(size=batch + (n, n))
    q, _ = np.linalg.qr(a)
    evals = np.logspace(0, np.log10(cond), n)
    return jnp.asarray(q @ (evals[..., None] * np.swapaxes(q, -1, -2)),
                       jnp.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 9, 12, 18])
def test_inv_spd_matches_numpy(n):
    m = _random_spd(n, batch=(7,))
    got = np.asarray(linalg.inv_spd(m))
    want = np.linalg.inv(np.asarray(m, np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_inv_spd_beyond_envelope_never_diverges():
    """Past the f32 envelope (scaled kappa >> 1e3) the residual guard
    swaps in the always-convergent Newton-Schulz seed: accuracy degrades
    gracefully (residual stays inside the contraction radius, never NaN
    or exploding) instead of the raw recursion's 1e4+ blow-up."""
    for cond in (1e5, 1e7):
        m = _random_spd(18, batch=(4,), cond=cond)
        got = np.asarray(linalg.inv_spd(m))
        resid = np.abs(got @ np.asarray(m, np.float64) - np.eye(18)).max()
        assert np.isfinite(resid) and resid < 1.0, (cond, resid)


def test_inv_spd_diagonal_ill_conditioning_is_free():
    """kappa that lives in the diagonal (contact-masked Lambda blocks
    padded with tiny damping) is removed exactly by the Jacobi
    pre-scaling — accuracy is that of the scaled matrix."""
    m = _random_spd(12, batch=(3,), cond=30.0)
    s = np.ones(12, np.float32)
    s[3:6] = 1e-3  # masked rows ~ damping-only scale
    ms = jnp.asarray(np.asarray(m) * s * s[:, None], jnp.float32)
    got = np.asarray(linalg.inv_spd(ms))
    want = np.linalg.inv(np.asarray(ms, np.float64))
    # Error relative to the largest entry of each inverse (entries span
    # 1e6 in scale, so a single rtol/atol pair cannot express this).
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    err = (np.abs(got - want) / scale).max()
    assert err < 3e-4, err


def test_inv_spd_real_mass_matrix():
    """The A1 18-DoF CRBA mass matrix (kappa ~ 4.5e3 raw, ~16 after
    Jacobi scaling) inverts to f32 accuracy."""
    from quadruped_jax.robots.params import a1_params
    from quadruped_jax.dynamics import floating_base as fb
    model = fb.build_model(a1_params())
    rng = np.random.default_rng(2)
    q = jnp.asarray(np.tile([0.0, 0.9, -1.8], 4)
                    + 0.2 * rng.normal(size=12), jnp.float32)
    a = fb.mass_matrix(model, q)
    got = np.asarray(linalg.inv_spd(a))
    resid = np.abs(got @ np.asarray(a, np.float64) - np.eye(18)).max()
    assert resid < 1e-4, resid


def test_damped_pinv_matches_svd_above_threshold():
    rng = np.random.default_rng(0)
    j = jnp.asarray(rng.normal(size=(5, 3, 18)), jnp.float32)
    got = np.asarray(linalg.damped_pinv(j, 1e-3))
    want = np.linalg.pinv(np.asarray(j, np.float64))
    # Random 3x18 rows are far above the threshold: damped ~ exact.
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_damped_pinv_zero_rows_stay_zero():
    rng = np.random.default_rng(1)
    j = np.asarray(rng.normal(size=(12, 18)), np.float32)
    j[3:6] = 0.0  # contact-masked task rows
    got = np.asarray(linalg.damped_pinv(jnp.asarray(j), 1e-3))
    np.testing.assert_array_equal(got[:, 3:6], 0.0)
    # Remaining columns behave like the pinv of the nonzero rows.
    keep = np.concatenate([np.arange(0, 3), np.arange(6, 12)])
    want = np.linalg.pinv(np.asarray(j[keep], np.float64))
    np.testing.assert_allclose(got[:, keep], want, rtol=2e-3, atol=2e-4)


def test_onesided_jacobi_svd_relative_accuracy():
    """Singular values spread over 1e4 (the whitened-QP transform's
    regime: sqrt(reg)=1e-2 vs sigma_max~1e2) resolve to high RELATIVE
    accuracy, and the left factor is orthonormal."""
    rng = np.random.default_rng(0)
    q1, _ = np.linalg.qr(rng.normal(size=(12, 7)))
    q2, _ = np.linalg.qr(rng.normal(size=(7, 7)))
    s_true = np.array([150.0, 90.0, 20.0, 1.0, 0.3, 0.011, 0.01])
    a = (q1 * s_true) @ q2.T
    u, s = linalg.onesided_jacobi_svd(jnp.asarray(a, jnp.float32))
    s_sorted = np.sort(np.asarray(s))[::-1]
    np.testing.assert_allclose(s_sorted, s_true, rtol=2e-4)
    un = np.asarray(u)
    assert np.abs(un.T @ un - np.eye(7)).max() < 1e-5


def test_onesided_jacobi_svd_batched():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(5, 9, 4)), jnp.float32)
    u, s = linalg.onesided_jacobi_svd(a)
    want = np.linalg.svd(np.asarray(a, np.float64), compute_uv=False)
    np.testing.assert_allclose(np.sort(np.asarray(s))[:, ::-1], want,
                               rtol=1e-4, atol=1e-5)
