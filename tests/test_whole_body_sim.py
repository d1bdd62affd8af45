import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.robots import a1_params
from quadruped_jax.control.types import HybridCommand
from quadruped_jax.sim import whole_body as wb
from quadruped_jax.sim import terrain


@pytest.fixture(scope="module")
def setup():
    params = a1_params()
    model = fb.build_model(params)
    return params, model


def stand_command(params):
    return HybridCommand(
        q=params.stand_angles,
        kp=jnp.full((12,), 100.0),
        dq=jnp.zeros(12),
        kd=jnp.full((12,), 2.0),
        tau=jnp.zeros(12))


def run(params, model, steps, start_height=None, command=None,
        terrain_fn=None):
    state = wb.whole_body_init(params, body_height=start_height)
    cmd = stand_command(params) if command is None else command
    contact = wb.ContactModel()

    def step(s, _):
        s2, flags = wb.whole_body_step(params, model, s, cmd, contact,
                                       0.002, terrain_height=terrain_fn)
        return s2, (s2.fb.position[2], flags)

    state, (hs, flags) = jax.jit(
        lambda s: jax.lax.scan(step, s, None, length=steps))(state)
    return state, hs, flags


def test_stand_settles(setup):
    """Dropped from slightly above footfall, the motor-law-held stand pose
    must settle into standing (all feet in contact, height stable)."""
    params, model = setup
    state, hs, flags = run(params, model, steps=500)
    h = np.asarray(hs)
    assert np.all(np.isfinite(h))
    # Settles near the kinematic stand height (feet at -0.261 for A1 stand
    # angles), allowing contact penetration of a few mm.
    assert 0.2 < h[-1] < 0.32
    assert abs(h[-1] - h[-100]) < 0.01
    assert np.all(np.asarray(flags)[-1] == 1.0)


def test_free_fall_without_contact(setup):
    params, model = setup
    state, hs, _ = run(params, model, steps=50, start_height=1.0)
    # ~0.1 s of fall: dz = 0.5 g t^2 = 4.9 cm.
    drop = 1.0 - float(hs[-1])
    assert 0.03 < drop < 0.07


def test_slope_contact(setup):
    params, model = setup
    t = terrain.slope(pitch=0.15)
    state, hs, flags = run(params, model, steps=800, terrain_fn=t)
    h = np.asarray(hs)
    assert np.all(np.isfinite(h))
    # Robot rests on the slope: at least two feet loaded, height stable,
    # body not fallen through or tipped over.
    assert np.asarray(flags)[-1].sum() >= 2
    assert 0.1 < h[-1] < 0.4
    assert abs(h[-1] - h[-100]) < 0.02
    from quadruped_jax.core import se3
    rpy = np.asarray(se3.quat_to_rpy(state.fb.quat))
    assert abs(rpy[0]) < 0.5 and abs(rpy[1]) < 0.5


def test_momentum_conservation_airborne(setup):
    """With no contact and zero torque, angular momentum about the CoM is
    conserved during flight."""
    params, model = setup
    s0 = wb.whole_body_init(params, body_height=2.0)
    s0 = wb.WholeBodySimState(
        fb=s0.fb.replace(omega_body=jnp.asarray([0.5, -0.3, 0.8])), t=s0.t)
    cmd = HybridCommand(q=jnp.zeros(12), kp=jnp.zeros(12), dq=jnp.zeros(12),
                        kd=jnp.zeros(12), tau=jnp.zeros(12))
    contact = wb.ContactModel()

    def momentum(s):
        """Angular momentum about the total CoM, world frame — the quantity
        gravity cannot change."""
        from quadruped_jax.core import se3

        h = fb.mass_matrix(model, s.fb.q)
        vgen = jnp.concatenate([s.fb.omega_body, s.fb.vel_body, s.fb.dq])
        p6 = h[0:6] @ vgen  # [L_about_base_origin; P], body frame
        rot = se3.quat_to_rotmat(s.fb.quat)
        l_o = rot @ p6[0:3]
        p_lin = rot @ p6[3:6]
        # Total CoM in world frame from per-body inertias.
        rots, poss, _ = fb._world_rotations_positions(model, s.fb)
        msum = 0.0
        csum = jnp.zeros(3)
        for i in range(fb.NUM_BODIES):
            inertia = model.inertias[i]
            m = inertia[5, 5]
            blk = inertia[0:3, 3:6]
            mcom = jnp.stack([blk[2, 1], blk[0, 2], blk[1, 0]])
            csum = csum + m * (poss[i] + rots[i] @ (mcom / m))
            msum = msum + m
        c_world = csum / msum
        return l_o - jnp.cross(c_world - s.fb.position, p_lin)

    def step(s, _):
        s2, _ = wb.whole_body_step(params, model, s, cmd, contact, 0.002)
        return s2, None

    h0 = momentum(s0)
    s_final, _ = jax.jit(lambda s: jax.lax.scan(step, s, None, length=100))(s0)
    h1 = momentum(s_final)
    # Angular momentum drifts only from the (small) momentum-arm change as
    # the CoM moves; tolerance covers integration error.
    np.testing.assert_allclose(np.asarray(h1), np.asarray(h0),
                               rtol=0.1, atol=0.05)
