import jax.numpy as jnp
import numpy as np

from quadruped_jax.estimation.zmp import compute_zmp, support_margin
from quadruped_jax.control.teleop import step_trace, apply_key
from quadruped_jax.control.desired_state import TwistCommand


def test_zmp_static_equals_com():
    zmp = compute_zmp(jnp.asarray([0.1, 0.05, 0.28]), jnp.zeros(3))
    np.testing.assert_allclose(zmp, [0.1, 0.05], atol=1e-6)


def test_zmp_accel_shifts_backward():
    # Forward acceleration moves the ZMP behind the CoM.
    zmp = compute_zmp(jnp.asarray([0.0, 0.0, 0.28]),
                      jnp.asarray([1.0, 0.0, 0.0]))
    assert float(zmp[0]) < 0


def test_support_margin_sign():
    feet = jnp.asarray([[0.17, -0.13, 0], [0.17, 0.13, 0],
                        [-0.17, -0.13, 0], [-0.17, 0.13, 0]])
    assert float(support_margin(jnp.asarray([0.0, 0.0]), feet,
                                jnp.ones(4))) > 0
    assert float(support_margin(jnp.asarray([0.5, 0.0]), feet,
                                jnp.ones(4))) < 0
    # Three-leg support (FR swinging) pulls the centroid backward-left.
    contact = jnp.asarray([0.0, 1.0, 1.0, 1.0])
    m_front = support_margin(jnp.asarray([0.15, -0.1]), feet, contact)
    m_back = support_margin(jnp.asarray([-0.05, 0.05]), feet, contact)
    assert float(m_back) > float(m_front)


def test_step_trace_and_keys():
    tr = step_trace(10, [(0, 0.0), (5, 0.4)])
    assert tr.linear.shape == (10, 3)
    np.testing.assert_allclose(tr.linear[7, 0], 0.4, atol=1e-6)
    np.testing.assert_allclose(tr.linear[3, 0], 0.0, atol=1e-6)
    c = apply_key(TwistCommand.constant(), "w")
    np.testing.assert_allclose(c.linear[0], 0.1, atol=1e-6)
    c = apply_key(c, "q")
    np.testing.assert_allclose(c.angular_z, 0.2, atol=1e-6)
    c = apply_key(c, " ")
    np.testing.assert_allclose(c.linear, 0.0, atol=1e-6)


def test_keyboard_to_rc_joy():
    """Keyboard -> JoyInput -> RC machine: 'k' starts locomotion, wasd
    move the sticks, 'l' stops (teleop.joy_from_key + rc_mode)."""
    from quadruped_jax.control.rc_mode import RcMode, rc_init, rc_update
    from quadruped_jax.control.teleop import joy_from_key

    st = rc_init()
    sticks = (0.0, 0.0, 0.0)
    joy, sticks = joy_from_key("k", sticks)
    st, cmd, req, _ = rc_update(st, joy, 0.27)
    assert int(st.mode) == RcMode.JOY_ADVANCED_TROT
    joy, sticks = joy_from_key("w", sticks)
    st, cmd, req, _ = rc_update(st, joy, 0.27)
    np.testing.assert_allclose(float(cmd.linear[0]), 0.1, rtol=1e-5)
    joy, sticks = joy_from_key("l", sticks)
    st, cmd, req, _ = rc_update(st, joy, 0.27)
    assert int(st.mode) == RcMode.JOY_STAND
    assert float(cmd.linear[0]) == 0.0
