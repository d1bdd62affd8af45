"""Force-balance ("virtual model") stance controller, batched.

Capability parity with `TorqueStanceLegController`
(quadruped/src/controllers/balance_controller/qr_torque_stance_leg_controller.cpp)
and its QP (`qr_qp_torque_optimizer.cpp`):

  * desired 6-D acceleration from PD on CoM pose/twist error
    (UpdateDesCommand :174-477: ddq_des = KP o pose_err + KD o twist_err,
    clipped to [min_ddq, max_ddq]);
  * the 6x12 "mass matrix" [1/M ...; I^-1 [r]x ...] (ComputeMassMatrix :31);
  * QP: min ||M F - (a_des + g)||^2_Q + lambda ||F||^2 subject to per-leg
    normal-force bounds and a 4-edge friction pyramid
    (ComputeConstraintMatrix :63, ComputeObjectiveMatrix :154), solved by the
    batched ADMM solver instead of QuadProg++;
  * walk-mode load/unload force ramps (fMaxRatio/fMinRatio per leg) are
    supported through the per-leg f_max_ratio/f_min_ratio arguments
    (UpdateFRatio :89-172).

World-frame formulation (`computeForceInWorldFrame: true` in the reference
user_parameters.yaml); the control-frame variant differs only by a rotation
of inputs.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import linalg, se3
from quadruped_jax.core import struct
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.control.types import RobotObservation
from quadruped_jax.control.desired_state import DesiredStateCommand
from quadruped_jax.solvers import polish

BIG = 1e8


@struct.dataclass
class ForceBalanceConfig:
    """Gains from stance_leg_controller.yaml (velocity mode)."""

    kp: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(
        [100., 100., 100., 200., 200., 0.], jnp.float32))
    kd: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(
        [20., 20., 10., 20., 20., 25.], jnp.float32))
    max_ddq: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(
        [10., 10., 10., 20., 20., 20.], jnp.float32))
    acc_weight: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(
        [1., 1., 1., 10., 10., 1.], jnp.float32))
    reg_weight: float = struct.field(pytree_node=False, default=1e-4)
    # Whitened-frame ADMM budget + active-set polish passes
    # (solvers/polish.py); the polish is what pins the exact minimizer.
    # Measured budgets (round 5): on the walk closed loop cold 40
    # iterations is BIT-IDENTICAL to cold 100/300
    # (benchmarks/exp_walk_budget.py) and the terrain tests run 40; the
    # golden-parity ensemble's hardest 4-contact case needs 64 to stay
    # inside the QuadProg++ oracle gate (40 fails exactly one case), so
    # 64 is the golden-gated default.
    qp_iters: int = struct.field(pytree_node=False, default=64)
    polish_passes: int = struct.field(pytree_node=False, default=24)
    # Warm-start the QP from the previous tick's forces (walk path:
    # WalkState.warm_forces). OFF keeps the cold-solve-per-tick behavior
    # every pre-round-5 gate was measured with; ON licenses a much
    # smaller qp_iters at the 1 kHz tick (benchmarks/exp_walk_budget.py).
    warm_start: bool = struct.field(pytree_node=False, default=False)
    # Servo x/y position error too (WALK mode: the pose planner commands
    # a base SHIFT over the future support polygon and the controller
    # must actually track it — qr_torque_stance_leg_controller.cpp
    # :197-208 feeds the planner pose into the position error). Velocity
    # mode keeps False (the reference tracks velocity, height,
    # orientation only). NOTE: walk_step FORCES this True regardless of
    # the configured value (a walk without the xy servo tips over —
    # measured); the knob selects behavior for direct users of
    # compute_contact_forces only.
    track_xy: bool = struct.field(pytree_node=False, default=False)


def desired_acceleration(config: ForceBalanceConfig, obs: RobotObservation,
                         des: DesiredStateCommand) -> jnp.ndarray:
    """6-D desired CoM acceleration [lin(3); ang(3)] in world frame."""
    r_mat = obs.rot_body_to_world
    # Pose error: xy position errors are servoed only in walk mode
    # (track_xy); velocity mode tracks velocity, height, orientation.
    if config.track_xy:
        pos_err = des.position - obs.base_position
    else:
        pos_err = jnp.stack([jnp.zeros(()), jnp.zeros(()),
                             des.position[2] - obs.base_position[2]])
    q_des = se3.rpy_to_quat(des.rpy.at[2].set(obs.base_rpy[2]))
    ori_err = se3.quat_error_so3(q_des, obs.base_quat)
    ori_err_world = r_mat @ ori_err

    v_des_world = r_mat @ des.velocity
    vel_err = v_des_world - obs.base_vel_world
    omega_des_world = r_mat @ des.omega
    omega_err = omega_des_world - obs.base_omega_world

    pose_err = jnp.concatenate([pos_err, ori_err_world])
    twist_err = jnp.concatenate([vel_err, omega_err])
    ddq = config.kp * pose_err + config.kd * twist_err
    return jnp.clip(ddq, -config.max_ddq, config.max_ddq)


def mass_matrix(params: RobotParams, r_feet_world: jnp.ndarray,
                r_mat: jnp.ndarray | None = None) -> jnp.ndarray:
    """[6, 12]: wrench-per-force map (ComputeMassMatrix :31; the
    world-frame overload :401 rotates the trunk inertia to world,
    I_w = R I R^T — r_mat=None keeps the base-frame variant)."""
    inv_mass = jnp.eye(3, dtype=r_feet_world.dtype) / params.total_mass
    inertia = params.total_inertia
    if r_mat is not None:
        inertia = r_mat @ inertia @ r_mat.T
    inv_inertia = linalg.inv_spd(inertia)
    skews = se3.skew(r_feet_world)  # [4, 3, 3]
    ang = jnp.einsum("ij,ljk->lik", inv_inertia, skews)  # [4, 3, 3]
    top = jnp.concatenate([inv_mass] * 4, axis=-1)       # [3, 12]
    bottom = jnp.concatenate([ang[i] for i in range(4)], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def build_constraints(params: RobotParams, contacts: jnp.ndarray,
                      f_min_ratio: jnp.ndarray, f_max_ratio: jnp.ndarray,
                      surface_normal: jnp.ndarray):
    """OSQP-form (A [24, 12], l, u) force-limit + friction-pyramid rows."""
    dtype = surface_normal.dtype
    mu = params.friction_coef
    weight = params.total_mass * 9.8
    # Orthonormal tangent basis ON the surface for any normal (a fixed
    # [0,1,0] tangent is only tangent to pitch-only slopes; with roll it
    # leaks normal force into the tangential bound and inflates the
    # effective friction cone by ~sin(roll)).
    x_axis = jnp.asarray([1.0, 0.0, 0.0], dtype)
    t2 = jnp.cross(surface_normal, x_axis)
    t2 = t2 / jnp.maximum(jnp.linalg.norm(t2), 1e-6)
    t1 = jnp.cross(t2, surface_normal)
    tangent1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-6)
    tangent2 = t2

    rows = []
    for _ in range(4):
        rows.append(jnp.stack([
            surface_normal,                    # normal force bounds
            mu * surface_normal + tangent1,    # pyramid edges >= 0
            mu * surface_normal - tangent1,
            mu * surface_normal + tangent2,
            mu * surface_normal - tangent2,
        ]))
    block = jnp.stack(rows)  # [4, 5, 3]
    a = jnp.zeros((4, 5, 4, 3), dtype)
    idx = jnp.arange(4)
    a = a.at[idx, :, idx, :].set(block)
    a = a.reshape(20, 12)

    f_min = f_min_ratio * weight * contacts
    f_max = jnp.where(contacts > 0.5, f_max_ratio * weight, 0.0)
    l = jnp.stack([f_min] + [jnp.zeros(4, dtype)] * 4, axis=-1).reshape(20)
    u = jnp.stack([f_max] + [jnp.full((4,), BIG, dtype)] * 4,
                  axis=-1).reshape(20)
    return a, l, u


def compute_contact_forces(
        config: ForceBalanceConfig, params: RobotParams,
        obs: RobotObservation, des: DesiredStateCommand,
        contacts: jnp.ndarray,
        f_min_ratio=None, f_max_ratio=None,
        surface_normal=None,
        x_warm: jnp.ndarray | None = None) -> jnp.ndarray:
    """[4, 3] world-frame contact forces (ComputeContactForce :303).

    x_warm: optional [4, 3] previous-tick forces — warm-starts the QP
    (the same hot-start role qpOASES plays in the reference's MPC). At
    the 1 kHz walk tick the problem moves ~1e-3 between solves, so a
    warm budget of qp_iters=40 matches the cold-300 solution to < 0.5 N
    (benchmarks/exp_walk_budget.py)."""
    dtype = obs.base_position.dtype
    if f_min_ratio is None:
        f_min_ratio = jnp.full((4,), 0.01, dtype)
    if f_max_ratio is None:
        f_max_ratio = jnp.full((4,), 10.0, dtype)
    if surface_normal is None:
        surface_normal = jnp.asarray([0.0, 0.0, 1.0], dtype)

    r_mat = obs.rot_body_to_world
    foot_base = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    r_feet = jnp.einsum("ij,lj->li", r_mat, foot_base - params.com_offset)

    m6 = mass_matrix(params, r_feet, r_mat)
    a_des = desired_acceleration(config, obs, des)
    g_vec = jnp.asarray([0.0, 0.0, 9.8, 0.0, 0.0, 0.0], dtype)
    target = a_des + g_vec

    q_diag = config.acc_weight
    # Effective objective 1/2||MF - target||^2_Q + reg/2 (F^T(ones+I)F):
    # the reference's ComputeObjectiveMatrix (:163) adds
    # regWeight * Matrix::Ones() — an ALL-ONES matrix, i.e. a penalty on
    # (sum of all force components)^2 that leaves internal-force modes
    # almost free — and ComputeContactForce (:234) then adds the 1e-4 I
    # "weight matrix". The ones term is almost certainly an
    # intended-Identity slip in the reference, but it decides the per-leg
    # force split along the near-nullspace (kappa(P) ~ 1e8), so behavior
    # parity requires both reproducing it exactly AND solving to the
    # exact minimizer — plain truncated ADMM stalls ~30 N away
    # (benchmarks/exp_fb_polish.py). solvers/polish.py factors the cost
    # as P = C^T C + reg I with C = [Q^1/2 M ; sqrt(reg) 1^T], whitens,
    # and runs an active-set polish; golden-parity lands <0.4 N from the
    # reference's f64 QuadProg++ solution.
    qvec = -(m6.T @ (q_diag * target))
    c_factor = jnp.concatenate(
        [jnp.sqrt(q_diag)[:, None] * m6,
         jnp.sqrt(config.reg_weight) * jnp.ones((1, 12), dtype)], axis=0)

    a, l, u = build_constraints(params, contacts, f_min_ratio, f_max_ratio,
                                surface_normal)
    prob = polish.FactoredQP(c=c_factor, reg=config.reg_weight, q=qvec,
                             a=a, l=l, u=u)
    x = polish.solve_factored(prob, admm_iters=config.qp_iters,
                              polish_passes=config.polish_passes,
                              x0=None if x_warm is None
                              else x_warm.reshape(12))
    return x.reshape(4, 3)


def stance_torques(params: RobotParams, obs: RobotObservation,
                   forces_world: jnp.ndarray,
                   contacts: jnp.ndarray) -> jnp.ndarray:
    """tau = J^T (-R^T F) on contact legs (GetAction :508-541)."""
    r_mat = obs.rot_body_to_world
    f_base = jnp.einsum("ji,lj->li", r_mat, forces_world)
    tau = kinematics.map_contact_forces_to_torques(params, obs.joint_angles,
                                                   -f_base)
    tau = jnp.clip(tau, -params.torque_limit, params.torque_limit)
    return tau * jnp.repeat(contacts, 3)
