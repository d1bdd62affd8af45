import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = a1_params()
    yaw = jnp.asarray(rng.uniform(-np.pi, np.pi), jnp.float32)
    r_feet = jnp.asarray(rng.normal(size=(4, 3)) * 0.15 +
                         np.array([0, 0, -0.28]), jnp.float32)
    return params, yaw, r_feet


def test_zoh_matches_expm():
    """Closed-form ZOH must match the reference's 25x25 expm discretization
    (qr_mpc_interface.cpp:257-293) to float precision."""
    params, yaw, r_feet = make_inputs()
    a, b = srb.srb_continuous(yaw, params.total_inertia, params.total_mass,
                              r_feet)
    dt = 0.03
    ad, bd = srb.srb_discretize(a, b, dt)

    block = np.zeros((25, 25))
    block[:13, :13] = np.asarray(a) * dt
    block[:13, 13:] = np.asarray(b) * dt
    ebig = expm(block)
    np.testing.assert_allclose(ad, ebig[:13, :13], atol=1e-5)
    np.testing.assert_allclose(bd, ebig[:13, 13:], atol=1e-5)


def test_continuous_dynamics_physics():
    params, yaw, r_feet = make_inputs(1)
    # Standing still, forces exactly canceling gravity -> zero acceleration.
    x = srb.srb_initial_state(
        jnp.asarray([0.0, 0.0, float(yaw)]), jnp.asarray([0.0, 0.0, 0.28]),
        jnp.zeros(3), jnp.zeros(3))
    fz = params.total_mass * (-srb.GRAVITY) / 4.0
    # Forces at the CoM height pattern: use symmetric feet so torques cancel.
    feet = jnp.asarray([[0.18, -0.13, -0.28], [0.18, 0.13, -0.28],
                        [-0.18, -0.13, -0.28], [-0.18, 0.13, -0.28]],
                       jnp.float32)
    forces = jnp.tile(jnp.asarray([0.0, 0.0, fz]), (4, 1))
    xdot = srb.srb_dynamics(x, forces, params.total_inertia,
                            params.total_mass, feet)
    np.testing.assert_allclose(xdot[9:12], 0.0, atol=1e-5)   # no accel
    np.testing.assert_allclose(xdot[6:9], 0.0, atol=1e-4)    # no ang accel
    # No force -> free fall.
    xdot = srb.srb_dynamics(x, jnp.zeros((4, 3)), params.total_inertia,
                            params.total_mass, feet)
    np.testing.assert_allclose(xdot[11], srb.GRAVITY, atol=1e-5)


def test_torque_from_offset_force():
    params, _, _ = make_inputs(2)
    x = srb.srb_initial_state(jnp.zeros(3), jnp.asarray([0.0, 0.0, 0.28]),
                              jnp.zeros(3), jnp.zeros(3))
    feet = jnp.asarray([[0.2, 0.0, -0.28]] * 4, jnp.float32)
    # Vertical force at x-offset foot -> pitch torque r x F along -y axis...
    forces = jnp.zeros((4, 3)).at[0, 2].set(10.0)
    xdot = srb.srb_dynamics(x, forces, params.total_inertia,
                            params.total_mass, feet)
    torque = np.cross(np.asarray(feet[0]), [0.0, 0.0, 10.0])
    expected_alpha = np.linalg.solve(np.asarray(params.total_inertia), torque)
    np.testing.assert_allclose(xdot[6:9], expected_alpha, atol=1e-4)


def test_discrete_rollout_matches_fine_euler():
    params, yaw, r_feet = make_inputs(3)
    a, b = srb.srb_continuous(yaw, params.total_inertia, params.total_mass,
                              r_feet)
    dt = 0.03
    ad, bd = srb.srb_discretize(a, b, dt)
    rng = np.random.default_rng(4)
    x0 = jnp.asarray(np.concatenate([rng.normal(size=12) * 0.1, [-9.81]]),
                     jnp.float32)
    u = jnp.asarray(rng.normal(size=12) * 5, jnp.float32)
    x_zoh = ad @ x0 + bd @ u
    # Fine Euler integration of the LTI system.
    n_sub = 3000
    x = np.asarray(x0, np.float64)
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    for _ in range(n_sub):
        x = x + (a64 @ x + b64 @ np.asarray(u)) * (dt / n_sub)
    np.testing.assert_allclose(x_zoh, x, atol=1e-4)
