"""Closed-loop gap crossing on the 18-DoF whole-body sim.

The other half of the reference's qrFootStepper capability
(quadruped/src/planner/qr_foot_stepper.cpp:339 GetOptimalFootholdsOffset,
:483 StepGenerator — plum-pile gap terrain): round 4 demonstrated stairs
end-to-end (tests/test_stair_climb.py) but left the gap path unit-tested
only. Here the statically-stable walk stack crosses a 6 cm gap strip
using planner/foot_stepper.gap_foothold_adjust (nearest-edge snap +
pair coordination) as the foothold hook, with terrain.gaps as ground
truth: feet hold at the near edge while the body approaches, cross once
their nominal passes the center (or their pair partner has crossed), and
no foot ever LANDS in the gap — the swing toe may dip below the surface
plane while traversing the open gap airspace, but never falls toward the
-0.5 m bottom.

Gap-size envelope (measured, round 5): the crossing jump is
gap + 2*margin; the 3.7 s walk cycle's natural stride at vx 0.03 is
~0.11 m, so a 6 cm gap (0.10 m jump) crosses cleanly while a 10 cm gap
(0.16 m jump) distorts the stance geometry enough to tip the robot
regardless of hold/cross policy (per-leg nearest-edge, cross-early,
common-offset, and speed-governor variants all measured) — crossing
wider gaps needs a longer-stride gait, not a better foothold rule.

Phase-robustness envelope (measured, round 5): reactive crossing is
APPROACH-PHASE-SENSITIVE. Sweeping the gap position over 0.19-0.34 m
(which sweeps the gait phase at which each foot meets the strip):
per-leg+pair crosses 1/6 positions, the common-offset hybrid 2/6, an
approach-speed governor 0/6 (slowing mid-crossing destabilizes the
pose-planner tracking), and a phase-gated hold-and-release (stop at a
standard distance, release at a calibrated gait phase, ramped restart)
1/6 — the hold position still quantizes by walk steps, so the gate does
not standardize the engagement state. The deterministic scenario below is a genuine
crossing, but robust any-phase crossing needs APPROACH PLANNING — a
step-queue that retimes strides several cycles out (the reference's
offline StepGenerator shape, plan_step_sequence) integrated as a
phase controller; recorded as the measured frontier, not hidden.
"""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.walk_locomotion import (WalkConfig, walk_init,
                                                   walk_step)
from quadruped_jax.core import se3
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait.scheduler import _config
from quadruped_jax.planner import foot_stepper
from quadruped_jax.robots import a1_params, kinematics
from quadruped_jax.sim import terrain, whole_body as wb

DT = 0.002
GAP_X = 0.25
GAP_W = 0.06


def test_gap_foothold_adjust_snaps_to_edges():
    """Unit behavior of the hook: inside-gap nominals snap to the nearest
    edge (hold short before the center, cross after), clear nominals are
    untouched."""
    centers = jnp.asarray([GAP_X])
    x = jnp.asarray([GAP_X - 0.04, GAP_X + 0.04, GAP_X - 0.2, GAP_X + 0.2])
    out = np.asarray(foot_stepper.gap_foothold_adjust(x, centers, GAP_W))
    half = GAP_W / 2 + 0.03
    np.testing.assert_allclose(out[0], GAP_X - half, atol=1e-6)
    np.testing.assert_allclose(out[1], GAP_X + half, atol=1e-6)
    np.testing.assert_allclose(out[2:], np.asarray(x[2:]), atol=1e-6)
    # Snapped positions are clear of the strip.
    assert not np.asarray(foot_stepper.gap_infeasible(
        jnp.asarray(out), centers, GAP_W)).any()


def test_walk_crosses_gap():
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    terr = terrain.gaps(gap_centers=(GAP_X,), gap_width=GAP_W, depth=0.5)
    centers = jnp.asarray([GAP_X])

    def adjust(target, feet):
        x_adj = foot_stepper.gap_foothold_adjust(target[:, 0], centers,
                                                 GAP_W, margin=0.02,
                                                 current_x=feet[:, 0])
        return target.at[:, 0].set(x_adj)

    config = WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=40))
    cmd = TwistCommand.constant(vx=0.03, body_height=0.27)

    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm, terrain_height=terr)
    st0 = walk_init(config, params, obs0)
    steps = int(40.0 / DT)

    def step(carry, i):
        sim, st = carry
        obs = wb.observe(params, model, sim, cm, terrain_height=terr)
        command, forces, st = walk_step(
            config, params, st, obs, cmd,
            (i + 1).astype(jnp.float32) * DT,
            terrain_height=terr, foothold_adjust_fn=adjust)
        sim, _ = wb.whole_body_step(params, model, sim, command, cm, DT,
                                    terrain_height=terr)
        r = se3.quat_to_rotmat(obs.base_quat)
        feet_w = jnp.einsum("ij,lj->li", r,
                            kinematics.foot_positions_in_base_frame(
                                params, obs.joint_angles)) \
            + obs.base_position
        return (sim, st), (sim.fb.position[0], sim.fb.position[2],
                           obs.base_rpy[1], feet_w[:, 0], feet_w[:, 2])

    _, (xs, hs, pitch, fx, fz) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    xs, hs, pitch, fx, fz = (np.asarray(v) for v in (xs, hs, pitch, fx, fz))

    assert np.isfinite(hs).all()
    assert hs.min() > 0.2, hs.min()
    assert np.abs(pitch).max() < 0.3, np.abs(pitch).max()
    # No foot ever FALLS into the gap: a landed-in-gap foot drops toward
    # the -0.5 m bottom; the crossing swing toe may dip briefly below the
    # surface plane inside the open strip (measured ~-0.11 m).
    assert fz.min() > -0.25, fz.min()
    # All four feet end PAST the far edge of the gap...
    far_edge = GAP_X + GAP_W / 2
    assert (fx[-1] > far_edge).all(), fx[-1]
    # ...and the base walked through the gap region without falling.
    assert xs[-1] > GAP_X, xs[-1]
