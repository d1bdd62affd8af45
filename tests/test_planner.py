import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.gait import TROT, gait_init
from quadruped_jax.gait.scheduler import LegState
from quadruped_jax.planner import com_adjuster, pose_planner, foot_stepper
from quadruped_jax.robots import a1_params


FEET = jnp.asarray([[0.17, -0.13, -0.3], [0.17, 0.13, -0.3],
                    [-0.17, -0.13, -0.3], [-0.17, 0.13, -0.3]])


def test_com_adjuster_centered_when_all_stance():
    state = gait_init(TROT()).replace(
        normalized_phase=jnp.full((4,), 0.5))
    com = com_adjuster.com_position_in_base_frame(state, FEET)
    np.testing.assert_allclose(com[:2], 0.0, atol=1e-5)


def test_com_adjuster_shifts_away_from_swing_leg():
    # FR (leg 0, front-right) swinging -> CoM shifts toward the support
    # triangle (negative x, positive y).
    state = gait_init(TROT()).replace(
        leg_state=jnp.asarray([LegState.SWING, 1, 1, 1], jnp.int32),
        normalized_phase=jnp.full((4,), 0.5))
    com = com_adjuster.com_position_in_base_frame(state, FEET)
    assert float(com[0]) < -1e-3
    assert float(com[1]) > 1e-3


def test_pose_planner_targets_support_centroid():
    """The centroid HEURISTIC path (use_sqp=False); the SQP optimizer has
    its own tests below (it stops short of the raw centroid when the
    base starts far away — leg-length constrained)."""
    params = a1_params()
    state = pose_planner.pose_planner_init()
    feet_world = FEET + jnp.asarray([0.5, 0.0, 0.3])
    state = pose_planner.pose_planner_update(
        state, params,
        base_position=jnp.asarray([0.4, 0.0, 0.3]),
        base_rpy=jnp.asarray([0.0, 0.0, 0.2]),
        foot_positions_world=feet_world,
        support_mask=jnp.ones(4),
        ground_rpy=jnp.zeros(3),
        body_height=jnp.asarray(0.3),
        replan=jnp.ones(()),
        use_sqp=False)
    target = np.asarray(state.pose_target)
    np.testing.assert_allclose(target[0], 0.5 + float(params.com_offset[0]),
                               atol=1e-5)
    np.testing.assert_allclose(target[5], 0.2, atol=1e-6)  # keeps yaw

    pose_mid, vel_mid = pose_planner.intermediate_base_pose(
        state, jnp.asarray(0.5))
    start = np.asarray(state.pose_start)
    assert np.all((pose_mid >= np.minimum(start, target) - 1e-5)
                  & (pose_mid <= np.maximum(start, target) + 1e-5))
    p0, _ = pose_planner.intermediate_base_pose(state, jnp.asarray(0.0))
    p1, _ = pose_planner.intermediate_base_pose(state, jnp.asarray(1.0))
    np.testing.assert_allclose(p0, start, atol=1e-5)
    np.testing.assert_allclose(p1, target, atol=1e-5)


def test_foot_stepper_avoids_gaps():
    gap_centers = jnp.asarray([0.5])
    width = 0.12
    feet = jnp.asarray([[0.5, -0.13, 0.0], [0.52, 0.13, 0.0],
                        [0.15, -0.13, 0.0], [0.15, 0.13, 0.0]])
    adjusted = foot_stepper.adjust_footholds_for_gaps(feet, gap_centers,
                                                      width)
    bad = foot_stepper.gap_infeasible(adjusted[:, 0], gap_centers, width)
    assert not bool(jnp.any(bad))
    # Offset applied uniformly.
    np.testing.assert_allclose(np.asarray(adjusted[:, 0] - feet[:, 0]),
                               float(adjusted[0, 0] - feet[0, 0]), atol=1e-6)


def test_foot_stepper_keeps_feasible_nominal():
    gap_centers = jnp.asarray([5.0])
    feet = jnp.asarray([[0.5, -0.13, 0.0], [0.5, 0.13, 0.0],
                        [0.15, -0.13, 0.0], [0.15, 0.13, 0.0]])
    adjusted = foot_stepper.adjust_footholds_for_gaps(feet, gap_centers, 0.1)
    np.testing.assert_allclose(adjusted, feet, atol=1e-6)


def test_stairs_snap():
    feet = jnp.asarray([[0.8, -0.13, 0.0], [0.8, 0.13, 0.0],
                        [0.3, -0.13, 0.0], [0.3, 0.13, 0.0]])
    snapped = foot_stepper.snap_to_stairs(feet, step_length=0.25,
                                          step_height=0.06, start_x=0.5)
    # 0.8 is on tread floor((0.3)/0.25)=1 -> z = 0.06; 0.3 is before stairs.
    np.testing.assert_allclose(snapped[0, 2], 0.06, atol=1e-6)
    np.testing.assert_allclose(snapped[2, 2], 0.0, atol=1e-6)


def test_plan_step_sequence_clears_gap_field():
    """Multi-step lookahead: every planned foothold clears every gap, and
    steps stay forward-moving (StepGenerator queue semantics)."""
    from quadruped_jax.planner import foot_stepper as fs

    x0 = jnp.asarray([0.35, 0.35, 0.0, 0.0])       # front/back pairs
    gaps = jnp.asarray([0.52, 0.83])
    offsets, xs = jax.jit(lambda x: fs.plan_step_sequence(
        x, gaps, 0.08, n_steps=6))(x0)
    assert offsets.shape == (6, 4) and xs.shape == (6, 4)
    bad = np.asarray(fs.gap_infeasible(xs, gaps, 0.08))
    assert not bad.any(), np.asarray(xs)
    assert np.all(np.asarray(offsets) > 0.0)
    # Total advance is close to the nominal plan (no stalling).
    assert float(xs[-1, 0] - x0[0]) > 0.35


def test_plan_step_sequence_half_step_fallback():
    """With a gap field too dense for any common offset, the planner takes
    the cross-gait half step (front/rear diagonal split) instead of
    freezing."""
    from quadruped_jax.planner import foot_stepper as fs

    x0 = jnp.asarray([0.0, 0.0, -0.35, -0.35])
    # Gaps every 12 cm with 8 cm width + 2cm margins: a common offset for
    # feet 35 cm apart cannot clear all four.
    gaps = jnp.arange(0.06, 1.2, 0.12)
    offsets, xs = fs.plan_step_sequence(x0, gaps, 0.08, n_steps=4)
    o = np.asarray(offsets)
    half_rows = np.isclose(o[:, 0], 0.05).all() or np.any(
        np.isclose(o, np.asarray([0.05, 0.1, 0.1, 0.05])).all(axis=1))
    assert half_rows, o


def test_stair_coordination_gates_climb():
    """A front foot in the climb window climbs only when its pair is not
    behind and the rear feet are close enough (no body straddling)."""
    from quadruped_jax.planner import foot_stepper as fs

    stair = fs.StairParams(start_x=jnp.asarray(1.0), width=jnp.asarray(0.2),
                           height=jnp.asarray(0.1), count=jnp.asarray(3))
    # FR at the riser of tread 1 (climb window: nominal-riser in [2,7) cm),
    # FL alongside, rear feet on the ground right behind the stairs.
    x = jnp.asarray([0.94, 0.94, 0.80, 0.80])
    x_adj, dz = jax.jit(lambda x: fs.stair_foothold_adjust(x, stair, 0.1))(x)
    # Both front feet may climb (pair equal, rear within one tread).
    assert float(dz[0]) > 0.05 and float(dz[1]) > 0.05
    assert float(x_adj[0]) > 1.0
    # Rear feet hold (not in the climb window yet).
    assert float(dz[2]) == 0.0 and float(dz[3]) == 0.0

    # Now FR already one tread above the rear-most back foot + its pair
    # behind: it must wait.
    x2 = jnp.asarray([1.34, 1.05, 0.80, 0.80])
    x_adj2, dz2 = fs.stair_foothold_adjust(x2, stair, 0.1)
    assert float(dz2[0]) == 0.0
    assert float(x_adj2[0]) < 1.4


def test_pose_planner_sqp_flat_symmetric():
    """The support-polygon SQP (plan_target_pose_sqp) reproduces the
    centroid fixed point on flat symmetric stance: level pose at body
    height over the center (reference qrPosePlanner::Update)."""
    from quadruped_jax.planner.pose_planner import plan_target_pose_sqp
    from quadruped_jax.robots import a1_params

    params = a1_params()
    feet = jnp.asarray([[0.17, -0.13, 0.0], [0.17, 0.13, 0.0],
                        [-0.17, -0.13, 0.0], [-0.17, 0.13, 0.0]],
                       jnp.float32)
    pose = plan_target_pose_sqp(params,
                                jnp.asarray([0.0, 0.0, 0.27], jnp.float32),
                                jnp.zeros(3, jnp.float32), feet,
                                jnp.ones(4), jnp.zeros(3, jnp.float32),
                                0.27)
    np.testing.assert_allclose(np.asarray(pose),
                               [0, 0, 0.27, 0, 0, 0], atol=2e-3)


def test_pose_planner_sqp_three_contact_constrained():
    """Three-contact plan: the base moves toward the support triangle but
    the leg-length and polygon constraints keep it short of the raw
    centroid; orientation stays near level (the ground anchor)."""
    from quadruped_jax.planner.pose_planner import plan_target_pose_sqp
    from quadruped_jax.robots import a1_params

    params = a1_params()
    feet = jnp.asarray([[0.17, -0.13, 0.0], [0.17, 0.13, 0.0],
                        [-0.17, -0.13, 0.0], [-0.17, 0.13, 0.0]],
                       jnp.float32)
    pose = plan_target_pose_sqp(params,
                                jnp.asarray([0.0, 0.0, 0.27], jnp.float32),
                                jnp.zeros(3, jnp.float32), feet,
                                jnp.asarray([0.0, 1.0, 1.0, 1.0]),
                                jnp.zeros(3, jnp.float32), 0.27)
    p = np.asarray(pose)
    # Moves back-left toward the FL-RR-RL triangle...
    assert p[0] < -0.015 and p[1] > 0.012, p
    # ...but stays short of the unconstrained centroid blend (-0.052, 0.045)
    assert p[0] > -0.052 and p[1] < 0.045, p
    # Orientation near level; height held.
    assert np.abs(p[3:6]).max() < 0.02, p
    assert abs(p[2] - 0.27) < 0.01

    # All virtual legs inside [l_min, l_max] at the planned pose.
    from quadruped_jax.core import se3 as se3m
    r = np.asarray(se3m.rpy_to_rotmat(jnp.asarray(p[3:6], jnp.float32)))
    hips = np.asarray(params.hip_offset)
    g = p[None, :3] + hips @ r.T - np.asarray(feet)
    lens = np.linalg.norm(g, axis=-1)[[1, 2, 3]]
    assert (lens > 0.21).all() and (lens < 0.36).all(), lens


def test_pose_planner_sqp_slope_alignment():
    """On a 10-degree slope the planned orientation aligns with the
    ground frame and the height is kept above the (tilted) support."""
    import math

    from quadruped_jax.planner.pose_planner import plan_target_pose_sqp
    from quadruped_jax.robots import a1_params

    params = a1_params()
    s = math.tan(math.radians(10))
    feet0 = np.array([[0.17, -0.13, 0.0], [0.17, 0.13, 0.0],
                      [-0.17, -0.13, 0.0], [-0.17, 0.13, 0.0]])
    feet = jnp.asarray(feet0 - np.array([0, 0, 1])[None, :]
                       * (feet0[:, :1] * s), jnp.float32)
    gr = jnp.asarray([0.0, math.radians(10), 0.0], jnp.float32)
    pose = plan_target_pose_sqp(params,
                                jnp.asarray([0.0, 0.0, 0.27], jnp.float32),
                                jnp.zeros(3, jnp.float32), feet,
                                jnp.ones(4), gr, 0.27)
    p = np.asarray(pose)
    assert abs(p[4] - math.radians(10)) < 0.02, p   # ground-aligned pitch
    assert abs(p[2] - 0.27) < 0.02, p
