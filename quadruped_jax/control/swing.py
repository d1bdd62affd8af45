"""Raibert swing-leg controller + foothold heuristics, batched.

Capability parity with `qrRaibertSwingLegController`
(quadruped/src/controllers/qr_swing_leg_controller.cpp) and the heuristic
part of `qrFootholdPlanner` (quadruped/src/planner/qr_foothold_planner.cpp:112
`ComputeHeuristicFootHold`):

  * lift-off latching: on the tick a leg enters swing, its current foot
    position (base and world frame) is latched as the swing start (:104-239);
  * foothold targets:
      - velocity mode (:287-308): hip velocity * stance/2 - Kp (v_target - v)
        under the hip, at -desired_height;
      - advanced trot (foothold_planner :189-235): commanded hip velocity *
        swing_time_remaining - Kp (v_target - v), roll-compensated hip
        offset, +/-0.2 m clip;
  * swing trajectory: parabola/cubic/B-spline family (core/splines) evaluated
    at the gait's normalized phase, apex 0.1 m;
  * joint targets: analytic IK for q_des, J^{-1} v for dq_des with NaN-free
    total formulas (reference guards NaNs at :408-423);
  * per-joint swing mask: swing legs get {q, Kp, dq, Kd, 0}; the locomotion
    merger overlays them on the stance torque map.

Everything is per-leg masked arithmetic — all four legs are computed every
tick and the swing mask selects, which is the vectorization of the
reference's `for legId in swingFootIds` loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import se3, splines
from quadruped_jax.core import struct
from quadruped_jax.gait.scheduler import GaitConfig, GaitState, LegState
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams, SIDE_SIGN
from quadruped_jax.control.types import RobotObservation
from quadruped_jax.control.desired_state import DesiredStateCommand, ControlMode


class SplineType:
    """Swing trajectory families (qr_foot_trajectory_generator.cpp)."""

    PARABOLA = 0   # XY linear + Z parabola (:166-215)
    CUBIC = 1      # cubic XY + two-segment Z (:218-278)
    BSPLINE = 2    # 9-control-point clamped cubic B-spline (:30-163)


@struct.dataclass
class SwingConfig:
    swing_kp: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray([0.03, 0.03, 0.03], jnp.float32))
    foot_clearance: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.01, jnp.float32))
    swing_height: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.1, jnp.float32))
    # Foothold displacement clip (reference hard-codes +/-0.2 m,
    # qr_foothold_planner.cpp:210/:289). At clip c and cycle time T the
    # kinematic speed ceiling is ~2c/T (measured, STATUS r4), so raising
    # the clip past the reference's 0.2 is THE lever for the upper half
    # of the [-1, 2] m/s command envelope the reference clips to but
    # never demonstrates — see benchmarks/exp_high_speed_trot.py.
    foothold_clip: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.2, jnp.float32))
    # Raibert symmetric-support term for the ADVANCED foothold law:
    # dp += gain * v_target * stance_duration. The reference's advanced
    # law (qr_foothold_planner.cpp:189-235) lands the foot essentially at
    # the hip (its target_v * swing_time_remaining term collapses as the
    # swing ends), which caps speed at workspace/stance_time ~ 1.15 m/s —
    # measured, and invariant to foothold_clip (round-5 clip sweep). Its
    # OTHER two planners carry exactly this v*stance/2 term
    # (:287-308, :242-302); gain 0.5 is the symmetric placement. Default
    # 0 = reference behavior.
    foothold_forward_gain: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.0, jnp.float32))
    mode: int = struct.field(pytree_node=False, default=ControlMode.ADVANCED_TROT)
    spline_type: int = struct.field(pytree_node=False,
                                    default=0)  # SplineType.PARABOLA
    # Optional terrain-aware foothold adjustment (world-frame [4,3] ->
    # [4,3]), e.g. planner.foot_stepper.adjust_footholds_for_gaps /
    # snap_to_stairs partials — the position-mode `UpdateOnce` hook
    # (qr_foothold_planner.cpp:67-109).
    foothold_adjust_fn: object = struct.field(pytree_node=False, default=None)


@struct.dataclass
class SwingState:
    liftoff_pos_base: jnp.ndarray    # [4, 3] foot pos at swing start (base)
    liftoff_pos_world: jnp.ndarray   # [4, 3] translated-world latch
    foot_target_base: jnp.ndarray    # [4, 3] desired foothold, base frame
    foot_target_world: jnp.ndarray   # [4, 3] world frame (for MPC CoM dest)
    # WBC foot task targets (filled in advanced trot, consumed by the WBC).
    wbc_pfoot_des: jnp.ndarray       # [4, 3] world
    wbc_vfoot_des: jnp.ndarray       # [4, 3] world
    wbc_afoot_des: jnp.ndarray       # [4, 3] world


def swing_init(params: RobotParams, obs: RobotObservation) -> SwingState:
    p = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    r = obs.rot_body_to_world
    p_world = jnp.einsum("ij,lj->li", r, p)
    return SwingState(
        liftoff_pos_base=p, liftoff_pos_world=p_world,
        foot_target_base=p, foot_target_world=p_world + obs.base_position,
        wbc_pfoot_des=p_world + obs.base_position,
        wbc_vfoot_des=jnp.zeros((4, 3), jnp.float32),
        wbc_afoot_des=jnp.zeros((4, 3), jnp.float32))


def _twisting_vector(hip_offset: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 3] -> [..., 4, 3]: yaw-rate lever arm (-y, x, 0) per hip."""
    return jnp.stack([-hip_offset[..., 1], hip_offset[..., 0],
                      jnp.zeros_like(hip_offset[..., 0])], axis=-1)


def raibert_foothold_velocity_mode(
        config: SwingConfig, params: RobotParams,
        gait_config: GaitConfig, obs: RobotObservation,
        des: DesiredStateCommand) -> jnp.ndarray:
    """[4, 3] foothold targets in base frame (velocity mode, :287-308)."""
    hip = params.default_hip_position + params.com_offset
    twist = _twisting_vector(hip)
    v_base = obs.base_vel_world @ obs.rot_body_to_world  # R^T v -> base frame
    yaw_dot = obs.base_omega_body[2]
    hip_v = v_base[None, :] + yaw_dot * twist
    hip_v = hip_v.at[:, 2].set(0.0)
    target_v = des.velocity[None, :] + des.omega[2] * twist
    foothold = (hip_v * gait_config.stance_duration[:, None] * 0.5
                - config.swing_kp * (target_v - hip_v))
    foothold = foothold + jnp.stack(
        [hip[:, 0], hip[:, 1], jnp.zeros(4, hip.dtype)], axis=-1)
    height = jnp.stack([jnp.zeros(()), jnp.zeros(()),
                        des.position[2] - config.foot_clearance])
    return foothold - obs.rot_body_to_world.T @ height


def heuristic_foothold_advanced(
        config: SwingConfig, params: RobotParams,
        gait_config: GaitConfig, gait_state: GaitState,
        obs: RobotObservation, des: DesiredStateCommand) -> jnp.ndarray:
    """[4, 3] advanced-trot foothold targets, base frame
    (qr_foothold_planner.cpp:189-235)."""
    hip = params.hip_offset
    twist = _twisting_vector(hip)
    r_mat = obs.rot_body_to_world
    v_base = obs.base_vel_world @ r_mat
    omega = obs.base_omega_body
    hip_v = v_base[None, :] + jnp.cross(jnp.broadcast_to(omega, (4, 3)),
                                        hip)
    hip_v = hip_v.at[:, 2].set(0.0)
    target_v = des.velocity[None, :] + des.omega[2] * twist

    dp = (target_v * gait_state.swing_time_remaining[:, None]
          - config.swing_kp * (target_v - hip_v)
          + config.foothold_forward_gain * target_v
          * gait_config.stance_duration[:, None])
    dp = jnp.clip(dp, -config.foothold_clip,
                  config.foothold_clip).at[:, 2].set(0.0)

    roll_r = se3.rot_x(obs.base_rpy[0])
    interleave = params.hip_length * jnp.asarray(SIDE_SIGN, hip.dtype)
    hip_link = jnp.stack([jnp.zeros(4, hip.dtype), interleave,
                          jnp.zeros(4, hip.dtype)], axis=-1)
    hip_world = jnp.einsum("ij,lj->li", roll_r, hip_link)

    target = dp + jnp.stack([hip[:, 0], hip[:, 1],
                             jnp.zeros(4, hip.dtype)], axis=-1) + hip_world
    # Backward walking drops the rear feet slightly (:224-227).
    rear_drop = jnp.where(des.velocity[0] < -0.01, 0.02, 0.0)
    target = target.at[2:, 0].add(-rear_drop)
    height = jnp.stack([jnp.zeros(()), jnp.zeros(()),
                        des.position[2] - config.foot_clearance])
    return target - (r_mat.T @ height)[None, :]


def mit_foothold(config: SwingConfig, params: RobotParams,
                 gait_config: GaitConfig, obs: RobotObservation,
                 des: DesiredStateCommand) -> jnp.ndarray:
    """[4, 3] MIT-style foothold targets, base frame
    (qrFootholdPlanner::ComputeMITFootHold, qr_foothold_planner.cpp:242-302):
    yaw-corrected hip offset + roll-compensated lateral interleave, with the
    capture-point-like relative term v*stance/2 + k (v - v_des), +/-0.2 clip.
    """
    r_mat = obs.rot_body_to_world
    stance_t = gait_config.stance_duration
    swing_t = gait_config.swing_duration
    wz_des = des.omega[2]

    # Yaw-corrected hip positions (rotate by -wz*stance/2).
    rz = se3.rot_z(-wz_des * stance_t * 0.5)          # [4, 3, 3]
    p_yaw = jnp.einsum("lij,lj->li", rz, params.hip_offset)
    interleave = jnp.asarray([-0.08, 0.08, -0.08, 0.08], p_yaw.dtype)
    roll_r = se3.rot_x(obs.base_rpy[0])
    lateral = jnp.einsum("ij,lj->li", roll_r, jnp.stack(
        [jnp.zeros(4, p_yaw.dtype), interleave,
         jnp.zeros(4, p_yaw.dtype)], axis=-1))
    pf = jnp.einsum("ij,lj->li", r_mat, p_yaw + lateral)  # world (translated)

    v_w = obs.base_vel_world
    v_des_w = r_mat @ des.velocity
    pfx = jnp.clip(v_w[0] * stance_t * 0.5 + 0.03 * (v_w[0] - v_des_w[0]),
                   -config.foothold_clip, config.foothold_clip)
    pfy = jnp.clip(v_w[1] * swing_t * 0.5 + 0.03 * (v_w[1] - v_des_w[1]),
                   -config.foothold_clip, config.foothold_clip)
    pf = pf.at[:, 0].add(pfx).at[:, 1].add(pfy)
    pf = pf.at[:, 2].set(-(des.position[2] - config.foot_clearance))
    return jnp.einsum("ji,lj->li", r_mat, pf)  # back to base frame


def swing_step(config: SwingConfig, params: RobotParams,
               gait_config: GaitConfig, gait_state: GaitState,
               state: SwingState, obs: RobotObservation,
               des: DesiredStateCommand):
    """One swing-controller tick.

    Returns (q_des [12], dq_des [12], swing_joint_mask [12], new state).
    """
    r_mat = obs.rot_body_to_world
    foot_base = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    foot_world = jnp.einsum("ij,lj->li", r_mat, foot_base)

    # --- lift-off latch on first swing tick (:104-239) ---
    first = gait_state.first_swing[:, None] > 0.5
    liftoff_base = jnp.where(first, foot_base, state.liftoff_pos_base)
    liftoff_world = jnp.where(first, foot_world, state.liftoff_pos_world)

    # --- foothold targets ---
    if config.mode == ControlMode.ADVANCED_TROT:
        target_base = heuristic_foothold_advanced(
            config, params, gait_config, gait_state, obs, des)
    else:
        target_base = raibert_foothold_velocity_mode(
            config, params, gait_config, obs, des)
    # Touchdown-wait probe (qr_foothold_planner.cpp ComputeHeuristicFootHold
    # !allowSwitchLegState branch): a leg whose clock wants stance but has
    # not touched down creeps downward — current foot pose shrunk toward
    # the hip line in y and pushed 2 cm down, evaluated at spline end.
    blocked = gait_state.allow_switch < 0.5                       # [4]
    hip_def = params.default_hip_position
    rel = jnp.einsum("ij,lj->li", r_mat, foot_base - hip_def)
    y_rel = rel[:, 1]
    y_rel = jnp.where(y_rel > 0.01, y_rel - 0.005,
                      jnp.where(y_rel < -0.01, y_rel + 0.005, y_rel))
    rel = rel.at[:, 1].set(y_rel).at[:, 2].add(-0.02)
    probe_base = jnp.einsum("ji,lj->li", r_mat, rel) + hip_def

    # Only update targets for legs actually swinging; stance legs hold.
    swinging = (gait_state.leg_state == LegState.SWING)[:, None]
    target_base = jnp.where(swinging, target_base, state.foot_target_base)
    target_base = jnp.where(blocked[:, None], probe_base, target_base)
    target_world = jnp.einsum("ij,lj->li", r_mat, target_base) \
        + obs.base_position
    if config.foothold_adjust_fn is not None:
        target_world = config.foothold_adjust_fn(target_world)
        target_base = jnp.einsum("ji,lj->li", r_mat,
                                 target_world - obs.base_position)

    # --- swing spline in (translated) world frame (advanced trot :372-384) --
    # Blocked (touchdown-wait) legs evaluate at the spline end: the foot
    # lands exactly on the probe target (reference phase[legId] = 1.0).
    phi = jnp.where(blocked, 1.0, gait_state.normalized_phase)
    target_rot = jnp.einsum("ij,lj->li", r_mat, target_base)
    swing_fn = {SplineType.PARABOLA: splines.swing_parabola,
                SplineType.CUBIC: splines.swing_cubic,
                SplineType.BSPLINE: splines.swing_bspline}[config.spline_type]
    pos_w, vel_w = swing_fn(
        liftoff_world, target_rot, config.swing_height, phi)
    pos_base = jnp.einsum("ji,lj->li", r_mat, pos_w)
    # velocity per unit phase -> per second.
    vel_base = jnp.einsum("ji,lj->li", r_mat, vel_w) \
        / jnp.maximum(gait_config.swing_duration, 1e-4)[:, None]

    # --- IK to joint targets ---
    q_des = kinematics.joint_angles_from_foot_positions(params, pos_base)
    jac = kinematics.all_leg_jacobians(params, q_des)
    dq_des = kinematics.damped_jacobian_solve(jac, vel_base)
    dq_des = dq_des.reshape(q_des.shape[:-2] + (12,))

    # --- swing mask (GetAction tail, mode-dependent :431-456) ---
    ls = gait_state.leg_state
    swing_leg = ((ls == LegState.SWING) | (ls == LegState.USERDEFINED_SWING)
                 | blocked)
    joint_mask = jnp.repeat(swing_leg.astype(jnp.float32), 3)

    new_state = state.replace(
        liftoff_pos_base=liftoff_base,
        liftoff_pos_world=liftoff_world,
        foot_target_base=target_base,
        foot_target_world=target_world,
        wbc_pfoot_des=pos_w + obs.base_position,
        wbc_vfoot_des=obs.base_vel_world[None, :] + jnp.einsum(
            "ij,lj->li", r_mat, vel_base),
        wbc_afoot_des=jnp.zeros_like(pos_w),
    )
    return q_des, dq_des, joint_mask, new_state
