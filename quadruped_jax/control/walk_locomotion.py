"""Statically-stable WALK locomotion: one fused tick, batched.

Capability parity with the reference's WALK_LOCOMOTION mode — the
combination of `qrWalkGaitGenerator` (sub-state machine, gait/walk.py),
`qrPosePlanner` (base shift over the support polygon, planner/pose_planner),
the force-balance stance controller with per-leg load/unload force ramps
(`TorqueStanceLegController::UpdateFRatio`, qr_torque_stance_leg_controller
.cpp:89-172), and the swing controller driving only TRUE_SWING legs
(qr_swing_leg_controller.cpp WALK branch + GetAction flag :434-438).

Flow per tick (qr_locomotion_controller.cpp:90-122 walk path):
  1. advance the walk gait sub-state machine;
  2. when a leg approaches TRUE_SWING, (re)plan the base pose over the
     remaining support feet and track the interpolated pose setpoint;
  3. stance/load/unload legs get force-balance torques with ramped
     f_min/f_max ratios; the TRUE_SWING leg follows its swing spline.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import se3, splines
from quadruped_jax.core import struct
from quadruped_jax.gait.scheduler import GaitConfig, LegState
from quadruped_jax.gait.walk import (SubLegState, WalkGaitState,
                                     walk_gait_init, walk_gait_update,
                                     load_ratios)
from quadruped_jax.planner.pose_planner import (PosePlannerState,
                                                pose_planner_init,
                                                pose_planner_update,
                                                intermediate_base_pose)
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.control.types import RobotObservation, HybridCommand
from quadruped_jax.control.desired_state import (DesiredStateCommand,
                                                 TwistCommand,
                                                 desired_state_init,
                                                 desired_state_update)
from quadruped_jax.control import stance_force_balance as stance_fb

STANCE_KD = 3.0


@struct.dataclass
class WalkConfig:
    gait: GaitConfig
    force_balance: stance_fb.ForceBalanceConfig
    swing_height: float = struct.field(pytree_node=False, default=0.08)
    step_length: float = struct.field(pytree_node=False, default=0.08)
    # Pose-planner choice: True = the reference's support-polygon SQP
    # optimization (planner/pose_planner.plan_target_pose_sqp), False =
    # the flat-ground centroid heuristic.
    use_sqp_pose_planner: bool = struct.field(pytree_node=False,
                                              default=True)


@struct.dataclass
class WalkState:
    gait: WalkGaitState
    pose: PosePlannerState
    command: DesiredStateCommand
    liftoff_pos_world: jnp.ndarray    # [4, 3] translated-world swing latch
    foot_target_world: jnp.ndarray    # [4, 3]
    prev_sub_state: jnp.ndarray       # [4] int
    # Previous tick's contact forces — the force-balance QP's warm start
    # when ForceBalanceConfig.warm_start is on (1 kHz hot-start, the
    # role qpOASES hot-starts play in the reference).
    warm_forces: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((4, 3), jnp.float32))


def walk_init(config: WalkConfig, params: RobotParams,
              obs: RobotObservation) -> WalkState:
    foot_base = kinematics.foot_positions_in_base_frame(params,
                                                        obs.joint_angles)
    r = obs.rot_body_to_world
    feet_world = jnp.einsum("ij,lj->li", r, foot_base) + obs.base_position
    return WalkState(
        gait=walk_gait_init(config.gait),
        pose=pose_planner_init(),
        command=desired_state_init(params.body_height),
        liftoff_pos_world=feet_world,
        foot_target_world=feet_world,
        prev_sub_state=jnp.full((4,), LegState.STANCE, jnp.int32))


def walk_step(config: WalkConfig, params: RobotParams, state: WalkState,
              obs: RobotObservation, cmd: TwistCommand, t: jnp.ndarray,
              terrain_height=None, ground_rpy=None,
              foothold_adjust_fn=None):
    """One walk tick. Returns (HybridCommand, forces_world, new state).

    `terrain_height(x, y)` (sim/terrain.py callback) grounds the swing
    foot targets on non-flat terrain; `ground_rpy` [3] (from the ground
    estimator's control frame) aligns the planned base pose with the
    slope. `foothold_adjust_fn` (world [4, 3] targets + current feet
    [4, 3] -> [4, 3]) is the terrain-constrained foothold hook — the walk
    path's `qrFootStepper` seam (qr_foothold_planner.cpp UpdateOnce
    :67-87), e.g. a planner.foot_stepper.stair_foothold_adjust partial
    holding feet short of a riser or pushing them past it. It runs before
    z-grounding. Defaults keep the flat-ground behavior."""
    des = desired_state_update(state.command, cmd)
    gait = walk_gait_update(config.gait, state.gait, t, obs.foot_contact)

    r = obs.rot_body_to_world
    foot_base = kinematics.foot_positions_in_base_frame(params,
                                                        obs.joint_angles)
    feet_world = jnp.einsum("ij,lj->li", r, foot_base) + obs.base_position

    # --- swing bookkeeping: latch lift-off + plan the step target ---
    entering_swing = ((gait.leg_sub_state == SubLegState.TRUE_SWING)
                      & (state.prev_sub_state != SubLegState.TRUE_SWING))
    liftoff = jnp.where(entering_swing[:, None], feet_world,
                        state.liftoff_pos_world)
    # Step target: Raibert placement under the hip, advanced by half the
    # (long) walk stance window at the commanded velocity so the feet keep
    # up with the base over the cycle; clipped to the step-length envelope.
    v_world = r @ des.velocity
    offset_xy = jnp.clip(v_world[:2] * config.gait.stance_duration[0] * 0.5,
                         -config.step_length, config.step_length)
    hip_world = jnp.einsum("ij,lj->li", r, params.default_hip_position) \
        + obs.base_position
    target = hip_world.at[:, :2].add(offset_xy[None, :])
    if foothold_adjust_fn is not None:
        target = foothold_adjust_fn(target, feet_world)
    target_z = (jnp.zeros(4) if terrain_height is None
                else terrain_height(target[:, 0], target[:, 1]))
    target = target.at[:, 2].set(target_z)
    foot_target = jnp.where(entering_swing[:, None], target,
                            state.foot_target_world)

    # --- pose planner: replan at the START of a leg's pre-swing window
    # (its in-window FULL_STANCE sub-state), planning over the FUTURE
    # support polygon (upcoming swing leg excluded) so the base shifts
    # into it while move_base_phase ramps 0 -> 1, ARRIVING before
    # lift-off — the reference's moveBase semantics. (Replanning at
    # TRUE_SWING entry instead commands a step change with the CoM still
    # outside the new support triangle and tips the robot — measured.)
    # An EARLY_CONTACT leg (touched down before its TRUE_SWING window
    # ended) leaves the swing set and becomes a (lightly loaded) support
    # leg — reference swing-leg selection skips detected EARLY_CONTACT
    # (qr_swing_leg_controller.cpp:208-218) and UpdateFRatio loads it.
    early = (gait.detected_leg_state == LegState.EARLY_CONTACT)
    in_true_swing = (gait.leg_sub_state == SubLegState.TRUE_SWING) & ~early
    support = (~in_true_swing).astype(jnp.float32)
    entering_window = ((gait.leg_sub_state == SubLegState.FULL_STANCE)
                       & (state.prev_sub_state == LegState.STANCE))
    pre_swing = ((gait.leg_sub_state == SubLegState.FULL_STANCE)
                 | (gait.leg_sub_state == SubLegState.UNLOAD_FORCE))
    plan_support = jnp.where(pre_swing | in_true_swing, 0.0, 1.0)
    replan = jnp.max(entering_window.astype(jnp.float32))
    pose_state = pose_planner_update(
        state.pose, params, base_position=obs.base_position,
        base_rpy=obs.base_rpy, foot_positions_world=feet_world,
        support_mask=plan_support,
        ground_rpy=jnp.zeros(3) if ground_rpy is None else ground_rpy,
        body_height=des.position[2], replan=replan,
        use_sqp=config.use_sqp_pose_planner)
    pose_des, twist_des = intermediate_base_pose(pose_state,
                                                 gait.move_base_phase)
    # Track the full planned position (the z target is slope-aware: the
    # SQP plans mean-contact-height + body height, which equals the
    # commanded body height on flat ground).
    des_walk = des.replace(position=pose_des[:3], rpy=pose_des[3:6])

    # --- stance: force balance with load/unload ramps ---
    f_min_ratio, f_max_ratio = load_ratios(gait)
    fb_config = config.force_balance.replace(track_xy=True)
    # Friction pyramid erected around the GROUND normal on slopes (the
    # reference's control-frame formulation rotates the whole QP;
    # passing the surface normal is the world-frame equivalent). On the
    # welded-anchor SRB sim this is cosmetic; on the whole-body sim's
    # real contact physics a vertical pyramid on a slope demands
    # tangential force beyond friction and the robot slides.
    normal = None
    if ground_rpy is not None:
        normal = se3.rpy_to_rotmat(ground_rpy) @ jnp.asarray(
            [0.0, 0.0, 1.0], jnp.float32)
    forces = stance_fb.compute_contact_forces(
        fb_config, params, obs, des_walk, support,
        f_min_ratio=f_min_ratio, f_max_ratio=f_max_ratio,
        surface_normal=normal,
        x_warm=state.warm_forces if fb_config.warm_start else None)
    tau_stance = stance_fb.stance_torques(params, obs, forces, support)

    # --- swing: spline for the TRUE_SWING leg ---
    phi = gait.normalized_phase
    pos_w, vel_w = splines.swing_parabola(
        liftoff - obs.base_position,
        jnp.einsum("ij,lj->li", jnp.eye(3), foot_target - obs.base_position),
        config.swing_height, phi)
    pos_base = jnp.einsum("ji,lj->li", r, pos_w)
    q_sw = kinematics.joint_angles_from_foot_positions(params, pos_base)
    swing_mask = jnp.repeat(in_true_swing.astype(jnp.float32), 3)

    sw = swing_mask > 0.5
    command = HybridCommand(
        q=jnp.where(sw, q_sw, 0.0),
        kp=jnp.where(sw, params.motor_kp, 0.0),
        dq=jnp.zeros(12, jnp.float32),
        kd=jnp.where(sw, params.motor_kd,
                     STANCE_KD * jnp.repeat(support, 3)),
        tau=jnp.where(sw, 0.0, tau_stance))

    new_state = WalkState(
        gait=gait, pose=pose_state, command=des,
        liftoff_pos_world=liftoff, foot_target_world=foot_target,
        prev_sub_state=gait.leg_sub_state,
        warm_forces=forces)
    return command, forces, new_state
