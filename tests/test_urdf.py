"""URDF loader: parse reference robot_description URDFs into RobotParams.

Validates against the hand-transcribed factories (robots/params.py, whose
numbers come from the reference YAML configs) and checks the derived
whole-body model is usable (FK runs, mass matrix SPD).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.robots import a1_params, aliengo_params, lite3_params
from quadruped_jax.robots.urdf import load_urdf, robot_params_from_urdf

REF = "/root/reference/robot_description"
A1_URDF = os.path.join(REF, "a1_description/urdf/a1.urdf")
ALIENGO_URDF = os.path.join(REF, "aliengo_description/xacro/aliengo.urdf")
LITE3_URDF = os.path.join(REF, "lite3_description/Lite3White/urdf/Lite3.urdf")

needs_ref = pytest.mark.skipif(not os.path.isdir(REF),
                               reason="reference robot_description absent")


@needs_ref
def test_load_a1_urdf_structure():
    m = load_urdf(A1_URDF)
    assert "trunk" in m.links
    assert m.links["trunk"].mass == pytest.approx(6.0)
    for leg in ["FR", "FL", "RR", "RL"]:
        assert f"{leg}_hip_joint" in m.joints
        assert m.joints[f"{leg}_calf_joint"].joint_type == "revolute"


@needs_ref
def test_a1_params_from_urdf_match_yaml_factory():
    """URDF-derived geometry/mass must agree with the YAML-derived factory
    (they describe the same robot; small diffs from YAML rounding)."""
    got = robot_params_from_urdf(A1_URDF, template=a1_params())
    want = a1_params()
    # YAML says 13.0; the URDF sums to 13.74 (it counts the feet and uses
    # unrounded link masses) — same robot, different bookkeeping.
    assert float(got.total_mass) == pytest.approx(float(want.total_mass),
                                                  rel=0.08)
    assert float(got.body_mass) == pytest.approx(6.0)
    np.testing.assert_allclose(got.hip_offset, want.hip_offset, atol=5e-3)
    # URDF thigh-joint y offset is 0.0838; the YAML rounds to 0.08505 —
    # the reference's own sources disagree by ~1.3 mm.
    assert float(got.hip_length) == pytest.approx(float(want.hip_length),
                                                  abs=2e-3)
    assert float(got.upper_length) == pytest.approx(0.2, abs=1e-3)
    assert float(got.lower_length) == pytest.approx(0.2, abs=1e-3)
    # Link-chain properties used by the Featherstone model.
    np.testing.assert_allclose(got.links_mass, want.links_mass, atol=1e-3)
    # SRB composite inertia: positive definite, roll inertia smallest
    # (trunk is long and the legs hang under it), same magnitude as the
    # reference's lumped total_inertia [0.24, 0.80, 1.0].
    diag = np.diag(np.asarray(got.total_inertia))
    assert np.all(diag > 0)
    assert diag[0] == diag.min()
    assert 0.05 < diag[0] < 1.0 and diag[1] < 2.0 and diag[2] < 2.0


@needs_ref
@pytest.mark.parametrize("path,total_lo,total_hi", [
    (A1_URDF, 10.0, 16.0),
    (ALIENGO_URDF, 19.0, 25.0),
    # The Lite3 URDF models ~8.7 kg (gazebo masses; the real robot is ~12).
    (LITE3_URDF, 7.0, 15.0),
])
def test_urdf_total_masses_plausible(path, total_lo, total_hi):
    p = robot_params_from_urdf(path)
    assert total_lo < float(p.total_mass) < total_hi


@needs_ref
def test_lite3_deeprobotics_convention():
    p = robot_params_from_urdf(LITE3_URDF, template=lite3_params())
    want = lite3_params()
    # Same robot as the factory: geometry within 1 cm.
    assert float(p.hip_length) == pytest.approx(float(want.hip_length),
                                                abs=0.01)
    assert float(p.upper_length) == pytest.approx(float(want.upper_length),
                                                  abs=0.01)
    # Leg order is ours (FR, FL, RR, RL): front hips have x > 0, right y < 0.
    ho = np.asarray(p.hip_offset)
    assert ho[0, 0] > 0 and ho[1, 0] > 0 and ho[2, 0] < 0 and ho[3, 0] < 0
    assert ho[0, 1] < 0 and ho[1, 1] > 0 and ho[2, 1] < 0 and ho[3, 1] > 0


@needs_ref
def test_urdf_params_build_whole_body_model():
    from quadruped_jax.dynamics import floating_base as fb

    p = robot_params_from_urdf(A1_URDF, template=a1_params())
    model = fb.build_model(p)
    q = jnp.tile(jnp.asarray([0.0, 0.8, -1.6]), 4)
    h = fb.mass_matrix(model, q)
    assert h.shape == (18, 18)
    evals = np.linalg.eigvalsh(np.asarray(h, dtype=np.float64))
    assert evals.min() > 0, "mass matrix must be SPD"
    np.testing.assert_allclose(h, h.T, atol=1e-4)


@needs_ref
def test_urdf_params_run_mpc_step():
    """URDF-derived params drive the same MPC solve path as the factories."""
    from quadruped_jax.core import se3
    from quadruped_jax.dynamics import srb
    from quadruped_jax.solvers import condense, cone_qp

    p = robot_params_from_urdf(A1_URDF, template=a1_params())
    rpy = jnp.zeros((1, 3))
    feet = jnp.asarray([[[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                         [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]])
    x0 = jnp.zeros((1, 13)).at[:, 12].set(srb.GRAVITY)
    x_des = jnp.tile(x0[:, None, :], (1, 10, 1))
    weights = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                          jnp.float32)
    r = se3.rpy_to_rotmat(rpy)
    a, b = srb.srb_continuous(r, p.total_inertia, p.total_mass, feet)
    ad, bd = srb.srb_discretize(a, b, 0.03)
    pmat, q = condense.condense_cost_structured(a, bd, ad, x0, x_des,
                                                weights, 4e-6, 10, 0.03)
    fz_hi = jnp.full((1, 40), float(p.max_force))
    sol = cone_qp.solve(cone_qp.ConeQP(
        p=pmat, q=q, mu=p.friction_coef, fz_lo=jnp.zeros_like(fz_hi),
        fz_hi=fz_hi), iters=100)
    forces = np.asarray(sol.x).reshape(10, 4, 3)
    # Standing balance: total vertical force ~ weight (terminal steps relax
    # — no future cost — so check the first 8 of 10).
    np.testing.assert_allclose(forces[:8, :, 2].sum(-1),
                               float(p.total_mass) * 9.81, rtol=0.05)
