"""Whole-body controller: task hierarchy + floating-base inverse-dynamics QP.

Capability parity with the reference WBC stack
(quadruped/src/controllers/wbc/):

  * `qrWbcLocomotionController::Run` (qr_wbc_locomotion_controller.cpp:107):
    update the floating-base model, build task list [body-orientation,
    body-position, swing-foot-position x 4] + contact list, kinematic
    null-space pass, dynamic WBIC pass, write feed-forward torques.
  * `qrMultitaskProjection::FindConfiguration`
    (qr_multitask_projection.cpp:38): priority-ordered null-space projection
    with SVD pseudo-inverses (threshold 0.001) -> joint position/velocity
    commands.
  * `qrWholeBodyImpulseCtrl::MakeTorque` (qr_wholebody_impulse_ctrl.cpp:62):
    dynamics-consistent weighted pseudo-inverse cascade for the acceleration
    command, then a QP over [delta qdd_fb(6), delta F_r(12)] with the
    floating-base dynamics as equality rows and per-contact friction
    pyramids (qr_single_contact.cpp:29-114, mu=0.4, fz <= m g), solved by
    the batched ADMM solver instead of QuadProg++.
  * Task definitions + gains from task_set/qr_task_body_orientation.cpp,
    qr_task_body_position.cpp, qr_task_link_position.cpp and the gain table
    at qr_wbc_locomotion_controller.cpp:59-73.

Variable contact count (the reference resizes everything by n_c) becomes
static shape + masking: all four contacts/foot-tasks are always present;
swing legs get zeroed contact rows + delta-F pinned to zero, stance legs get
zeroed foot-task rows. Zero rows have zero pseudo-inverse, so the cascades
reduce exactly to the reference's dynamic-size behavior.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import linalg, se3
from quadruped_jax.core import struct
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.control.types import RobotObservation
from quadruped_jax.solvers import qp

NDOF = fb.NUM_DOF  # 18
PINV_THRESH = 1e-3
BIG = 1e8


@struct.dataclass
class WbcConfig:
    """Gains (qr_wbc_locomotion_controller.cpp:59-73 + task ctors)."""

    kp_ori: jnp.ndarray = struct.field(default_factory=lambda: jnp.full(3, 100.0))
    kd_ori: jnp.ndarray = struct.field(default_factory=lambda: jnp.full(3, 10.0))
    kp_pos: jnp.ndarray = struct.field(default_factory=lambda: jnp.full(3, 100.0))
    kd_pos: jnp.ndarray = struct.field(default_factory=lambda: jnp.full(3, 10.0))
    kp_foot: jnp.ndarray = struct.field(default_factory=lambda: jnp.full(3, 500.0))
    kd_foot: jnp.ndarray = struct.field(default_factory=lambda: jnp.full(3, 10.0))
    weight_fb: float = struct.field(pytree_node=False, default=0.1)
    weight_fr: float = struct.field(pytree_node=False, default=1.0)
    friction_mu: float = struct.field(pytree_node=False, default=0.4)
    qp_iters: int = struct.field(pytree_node=False, default=50)


@struct.dataclass
class WbcCommand:
    """The reference's `qrWbcCtrlData` (qr_state_dataflow.h:127-165)."""

    p_body_des: jnp.ndarray        # [3] world
    v_body_des: jnp.ndarray        # [3] world
    a_body_des: jnp.ndarray        # [3] world
    rpy_des: jnp.ndarray           # [3]
    omega_des_world: jnp.ndarray   # [3]
    p_foot_des: jnp.ndarray        # [4, 3] world
    v_foot_des: jnp.ndarray        # [4, 3] world
    a_foot_des: jnp.ndarray        # [4, 3] world
    fr_des: jnp.ndarray            # [4, 3] MPC reaction forces, world
    contact_state: jnp.ndarray     # [4] 1.0 = stance


def _pinv(j: jnp.ndarray, rcond: float = PINV_THRESH) -> jnp.ndarray:
    """Damped right pseudo-inverse of a wide task Jacobian.

    Replaces the reference's SVD pseudo-inverse with absolute
    singular-value threshold (utils/qr_algebra.h:119): XLA's batched SVD
    is an iterative Jacobi loop (it dominated the whole WBC tick on an
    earlier accelerator — to re-check on the GPU); the damped normal-equation
    form is pure elementwise math with the same regularization intent
    (1/(s + rcond^2/s) ~ 1/s above the threshold, -> 0 below), and
    contact-masked all-zero rows still produce exactly zero columns."""
    return linalg.damped_pinv(j, rcond)


def _weighted_pinv(j: jnp.ndarray, a_inv: jnp.ndarray,
                   rcond: float = 1e-4) -> jnp.ndarray:
    """Dynamics-consistent inverse J_bar = A^-1 J^T (J A^-1 J^T)^+
    (WeightedInverse, qr_wholebody_impulse_ctrl.cpp:291-299); the inner
    pseudo-inverse is damped (see _pinv)."""
    temp = linalg.matmul_small(a_inv, jnp.swapaxes(j, -1, -2))
    lam = linalg.matmul_small(j, temp)
    m = lam.shape[-1]
    lam_inv = linalg.inv_spd(lam + rcond * jnp.eye(m, dtype=j.dtype))
    return linalg.matmul_small(temp, lam_inv)


def _null_projector(j: jnp.ndarray) -> jnp.ndarray:
    """N = I - J^+ J (BuildProjectionMatrix)."""
    eye = jnp.eye(NDOF, dtype=j.dtype)
    return eye - linalg.matmul_small(_pinv(j), j)


def build_tasks(config: WbcConfig, model: fb.FloatingBaseModel,
                state: fb.FbState, cmd: WbcCommand):
    """Task list [ori, pos, foot0..3] as stacked (Jt, JtDotQdot, pos_err,
    vel_des, xddot_cmd), swing-masked foot tasks."""
    r = se3.quat_to_rotmat(state.quat)
    dtype = state.q.dtype

    jc, jcdqd, p_feet = fb.contact_jacobians(model, state)
    # World-frame foot velocities from the Jacobians.
    vgen = jnp.concatenate([state.omega_body, state.vel_body, state.dq])
    v_feet = jnp.einsum("lij,j->li", jc, vgen)

    jts, jdqds, errs, vels, accs = [], [], [], [], []

    # --- body orientation (qr_task_body_orientation.cpp) ---
    jt = jnp.zeros((3, NDOF), dtype).at[:, 0:3].set(r)
    q_des = se3.rpy_to_quat(cmd.rpy_des)
    err = se3.quat_rotate(q_des, se3.quat_error_so3(q_des, state.quat))
    # (error expressed in world frame; reference mixes frames equivalently
    # for the small errors in play)
    w_world = r @ state.omega_body
    vel_err = cmd.omega_des_world - w_world
    acc = jnp.clip(config.kp_ori * err + config.kd_ori * vel_err, -10, 10)
    jts.append(jt); jdqds.append(jnp.zeros(3, dtype))
    errs.append(err); vels.append(cmd.omega_des_world); accs.append(acc)

    # --- body position (qr_task_body_position.cpp) ---
    jt = jnp.zeros((3, NDOF), dtype).at[:, 3:6].set(r)
    err = cmd.p_body_des - state.position
    v_world = r @ state.vel_body
    acc = jnp.clip(config.kp_pos * err + config.kd_pos *
                   (cmd.v_body_des - v_world) + cmd.a_body_des, -10, 10)
    jts.append(jt); jdqds.append(jnp.zeros(3, dtype))
    errs.append(err); vels.append(cmd.v_body_des); accs.append(acc)

    # --- swing-foot positions (qr_task_link_position.cpp), stance-masked ---
    swing = (1.0 - cmd.contact_state)[:, None]
    for leg in range(4):
        mask = swing[leg]
        jts.append(jc[leg] * mask)
        jdqds.append(jcdqd[leg] * mask)
        errs.append((cmd.p_foot_des[leg] - p_feet[leg]) * mask)
        vels.append(cmd.v_foot_des[leg] * mask)
        acc = (config.kp_foot * (cmd.p_foot_des[leg] - p_feet[leg])
               + config.kd_foot * (cmd.v_foot_des[leg] - v_feet[leg])
               + cmd.a_foot_des[leg]) * mask
        accs.append(acc)

    return (jnp.stack(jts), jnp.stack(jdqds), jnp.stack(errs),
            jnp.stack(vels), jnp.stack(accs), jc, jcdqd, p_feet)


def multitask_projection(jts, errs, vels, jc_stacked):
    """Kinematic null-space cascade -> (delta_q [18], qdot [18])
    (FindConfiguration :38-106)."""
    n_pre = _null_projector(jc_stacked)

    jt0 = jts[0] @ n_pre
    jt0_pinv = _pinv(jt0)
    delta_q = jt0_pinv @ errs[0]
    qdot = jt0_pinv @ vels[0]
    n_pre_next = n_pre @ _null_projector(jt0)

    for i in range(1, jts.shape[0]):
        jt = jts[i]
        jt_pre = jt @ n_pre_next
        jt_pinv = _pinv(jt_pre)
        delta_q = delta_q + jt_pinv @ (errs[i] - jt @ delta_q)
        qdot = qdot + jt_pinv @ (vels[i] - jt @ qdot)
        if i < jts.shape[0] - 1:
            n_pre_next = n_pre_next @ _null_projector(jt_pre)
    return delta_q, qdot


def wbic_torque(config: WbcConfig, params: RobotParams,
                model: fb.FloatingBaseModel, state: fb.FbState,
                cmd: WbcCommand, jts, jdqds, accs, jc, jcdqd):
    """Dynamic pass: acceleration cascade + QP -> feed-forward torque [12]
    (MakeTorque :62-126)."""
    dtype = state.q.dtype
    a_mat = fb.mass_matrix(model, state.q)
    grav = fb.gravity_force(model, state)
    cori = fb.coriolis_force(model, state)
    a_inv = linalg.inv_spd(a_mat)

    contact = cmd.contact_state
    cmask = jnp.repeat(contact, 3)[:, None]
    jc_stacked = jc.reshape(12, NDOF) * cmask
    jcdqd_stacked = jcdqd.reshape(12) * cmask[:, 0]
    fr_des = cmd.fr_des.reshape(12) * cmask[:, 0]

    # Acceleration cascade with dynamics-consistent inverses.
    jc_bar = _weighted_pinv(jc_stacked, a_inv)
    qddot_pre = jc_bar @ (-jcdqd_stacked)
    n_pre = jnp.eye(NDOF, dtype=dtype) - jc_bar @ jc_stacked
    for i in range(jts.shape[0]):
        jt = jts[i]
        jt_pre = jt @ n_pre
        jt_bar = _weighted_pinv(jt_pre, a_inv)
        qddot_pre = qddot_pre + jt_bar @ (accs[i] - jdqds[i] - jt @ qddot_pre)
        if i < jts.shape[0] - 1:
            n_pre = n_pre @ (jnp.eye(NDOF, dtype=dtype) - jt_bar @ jt_pre)

    # --- QP over z = [dqdd_fb(6), dFr(12)] ---
    nz = 18
    p_cost = jnp.diag(jnp.concatenate([
        jnp.full((6,), config.weight_fb, dtype),
        jnp.full((12,), config.weight_fr, dtype)]))
    q_cost = jnp.zeros(nz, dtype)

    # Equality rows: floating-base dynamics (SetEqualityConstraint :128-148).
    a_eq = jnp.zeros((6, nz), dtype)
    a_eq = a_eq.at[:, 0:6].set(a_mat[0:6, 0:6])
    a_eq = a_eq.at[:, 6:18].set(-jnp.swapaxes(jc_stacked, -1, -2)[0:6, :])
    rhs_eq = -(a_mat @ qddot_pre + cori + grav
               - jnp.swapaxes(jc_stacked, -1, -2) @ fr_des)[0:6]

    # Inequality rows: per-leg friction pyramid on total force
    # (qr_single_contact Uf layout), or dFr pinned to 0 on swing legs.
    mu = config.friction_mu
    uf_rows = jnp.asarray([
        [0.0, 0.0, 1.0],
        [1.0, 0.0, mu],
        [-1.0, 0.0, mu],
        [0.0, 1.0, mu],
        [0.0, -1.0, mu],
        [0.0, 0.0, -1.0],
    ], dtype)
    max_fz = params.total_mass * 9.81
    blocks, lows, highs = [], [], []
    for leg in range(4):
        stance = contact[leg]
        block = jnp.zeros((6, nz), dtype)
        # Stance: pyramid rows on dFr columns of this leg.
        pyramid = block.at[:, 6 + 3 * leg: 9 + 3 * leg].set(uf_rows)
        # Swing: pin dFr = 0 (identity rows, l = u = 0).
        pin = block.at[0:3, 6 + 3 * leg: 9 + 3 * leg].set(jnp.eye(3, dtype=dtype))
        blocks.append(jnp.where(stance > 0.5, pyramid, pin))
        fr_leg = fr_des[3 * leg: 3 * leg + 3]
        uf_frdes = uf_rows @ fr_leg
        ineq_vec = jnp.asarray([0, 0, 0, 0, 0, -max_fz], dtype)
        low_st = ineq_vec - uf_frdes
        lows.append(jnp.where(stance > 0.5, low_st, jnp.zeros(6, dtype)))
        highs.append(jnp.where(stance > 0.5, jnp.full((6,), BIG, dtype),
                               jnp.zeros(6, dtype)))
    a_ineq = jnp.concatenate(blocks)
    l_ineq = jnp.concatenate(lows)
    u_ineq = jnp.concatenate(highs)

    a_all = jnp.concatenate([a_eq, a_ineq])
    l_all = jnp.concatenate([rhs_eq, l_ineq])
    u_all = jnp.concatenate([rhs_eq, u_ineq])

    sol = qp.admm_solve(p_cost, q_cost, a_all, l_all, u_all,
                        iters=config.qp_iters)
    qddot = qddot_pre.at[0:6].add(sol.x[0:6])
    fr_total = fr_des + sol.x[6:18]
    tot_tau = (a_mat @ qddot + cori + grav
               - jnp.swapaxes(jc_stacked, -1, -2) @ fr_total)
    return tot_tau[6:], qddot, fr_total


def wbc_step(config: WbcConfig, params: RobotParams,
             model: fb.FloatingBaseModel, obs: RobotObservation,
             cmd: WbcCommand):
    """Full WBC tick (Run :107-134).

    Returns (q_des [12], dq_des [12], tau_ff [12]).
    """
    state = fb.FbState(
        quat=obs.base_quat, position=obs.base_position,
        omega_body=obs.base_omega_body,
        vel_body=obs.base_vel_world @ obs.rot_body_to_world,
        q=obs.joint_angles, dq=obs.joint_velocities)

    jts, jdqds, errs, vels, accs, jc, jcdqd, _ = build_tasks(
        config, model, state, cmd)

    cmask = jnp.repeat(cmd.contact_state, 3)[:, None]
    jc_stacked = jc.reshape(12, NDOF) * cmask
    delta_q, qdot = multitask_projection(jts, errs, vels, jc_stacked)
    q_des = state.q + delta_q[6:]
    dq_des = qdot[6:]

    tau_ff, _, _ = wbic_torque(config, params, model, state, cmd,
                               jts, jdqds, accs, jc, jcdqd)
    tau_ff = jnp.clip(tau_ff, -params.torque_limit, params.torque_limit)
    return q_des, dq_des, tau_ff
