"""3-D rollout visualization (utils/viz3d.py — the xpp replacement)."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.robots import a1_params
from quadruped_jax.utils import viz3d


def make_trace(steps=40):
    """A short whole-body stand trace with real poses."""
    from quadruped_jax.control.types import HybridCommand
    from quadruped_jax.core import se3
    from quadruped_jax.dynamics import floating_base as fb
    from quadruped_jax.sim import whole_body as wb

    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    command = HybridCommand(q=params.stand_angles,
                            kp=jnp.full((12,), 120.0), dq=jnp.zeros(12),
                            kd=jnp.full((12,), 3.0), tau=jnp.zeros(12))
    sim0 = wb.whole_body_init(params)

    def step(s, _):
        s, flags = wb.whole_body_step(params, model, s, command, cm, 0.002)
        return s, (s.fb.position, se3.quat_to_rpy(s.fb.quat), s.fb.q, flags)

    _, (pos, rpy, q, contact) = jax.lax.scan(step, sim0, None, length=steps)
    return params, viz3d.Viz3DTrace(
        position=np.asarray(pos), rpy=np.asarray(rpy),
        joint_angles=np.asarray(q), contact=np.asarray(contact))


def test_skeleton_geometry():
    """Skeleton points are geometrically consistent: feet at FK
    positions, knees between hip and foot at the right link distances."""
    params, trace = make_trace(steps=2)
    trunk, legs = viz3d.skeleton_points(params, trace.position[0],
                                        trace.rpy[0],
                                        trace.joint_angles[0])
    assert trunk.shape == (5, 3) and legs.shape == (4, 3, 3)
    upper = float(params.upper_length)
    lower = float(params.lower_length)
    hip_l = float(params.hip_length)
    for i in range(4):
        hip, knee, foot = legs[i]
        # |hip -> knee| = hip link + upper link chain length.
        d_hk = np.linalg.norm(knee - hip)
        assert abs(d_hk - np.hypot(hip_l, upper)) < 0.02, (i, d_hk)
        # |knee -> foot| = lower link.
        d_kf = np.linalg.norm(foot - knee)
        assert abs(d_kf - lower) < 0.01, (i, d_kf)
        # Feet near the ground for a standing pose.
        assert foot[2] < 0.08


def test_snapshot_and_gif(tmp_path):
    params, trace = make_trace(steps=40)
    png = viz3d.snapshot(params, trace, str(tmp_path / "s.png"),
                         ticks=(0, 39))
    assert os.path.getsize(png) > 10_000
    gif = viz3d.animate_rollout(params, trace, str(tmp_path / "a.gif"),
                                every=10, fps=5)
    assert os.path.getsize(gif) > 20_000
