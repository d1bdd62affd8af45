"""Pure-array single-rigid-body rollout simulator (speed-of-light mode).

Replaces the reference's ROS/Gazebo closed loop (simulation/qr_gazebo +
qrRobotA1Sim's 17-topic bridge, quadruped/src/robots/qr_robot_a1_sim.cpp)
with batched array stepping for the control loop's fast fidelity mode: the
trunk is the 13-state SRB integrated under the stance contact forces; swing
legs track their joint targets through a first-order servo; stance feet are
kinematically welded to their world anchor (no slip), exactly the contract
the force controllers assume.

The whole-body (18-DoF Featherstone + penalty contact + hybrid motor law)
fidelity mode lives in sim/whole_body.py; this module is the rollout
workhorse for MPC benchmarking and scenario sweeps — thousands of instances
per chip under vmap.

Sim-state frame conventions match the observation struct: quaternion
(w,x,y,z) body->world, velocities in world frame.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import linalg, se3
from quadruped_jax.core import struct
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.control.types import RobotObservation, HybridCommand


@struct.dataclass
class SrbSimState:
    position: jnp.ndarray      # [3] CoM world position
    quat: jnp.ndarray          # [4] body->world
    vel_world: jnp.ndarray     # [3]
    omega_world: jnp.ndarray   # [3]
    q: jnp.ndarray             # [12] joint angles
    dq: jnp.ndarray            # [12]
    foot_anchor: jnp.ndarray   # [4, 3] world positions of stance feet
    t: jnp.ndarray             # [] sim time


def srb_sim_init(params: RobotParams, body_height=None) -> SrbSimState:
    h = params.body_height if body_height is None else body_height
    q0 = params.stand_angles
    foot_base = kinematics.foot_positions_in_base_frame(params, q0)
    pos = jnp.stack([jnp.zeros(()), jnp.zeros(()), jnp.asarray(h, jnp.float32)])
    anchors = foot_base + pos  # identity orientation at start
    anchors = anchors.at[:, 2].set(0.0)
    return SrbSimState(
        position=pos,
        quat=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
        vel_world=jnp.zeros(3, jnp.float32),
        omega_world=jnp.zeros(3, jnp.float32),
        q=q0, dq=jnp.zeros(12, jnp.float32),
        foot_anchor=anchors,
        t=jnp.zeros((), jnp.float32))


def observe(params: RobotParams, state: SrbSimState,
            contact: jnp.ndarray) -> RobotObservation:
    r = se3.quat_to_rotmat(state.quat)
    return RobotObservation(
        base_position=state.position,
        base_rpy=se3.quat_to_rpy(state.quat),
        base_quat=state.quat,
        base_vel_world=state.vel_world,
        base_omega_world=state.omega_world,
        base_omega_body=state.omega_world @ r,  # R^T w
        joint_angles=state.q,
        joint_velocities=state.dq,
        foot_contact=contact,
        foot_forces=contact * params.total_mass * 9.81 / 4.0,
    )


def srb_sim_step(params: RobotParams, state: SrbSimState,
                 forces_world: jnp.ndarray,      # [4, 3] stance GRFs
                 stance_mask: jnp.ndarray,       # [4]
                 q_swing_des: jnp.ndarray,       # [12] swing joint targets
                 dq_swing_des: jnp.ndarray,      # [12]
                 swing_joint_mask: jnp.ndarray,  # [12]
                 dt, stance_kd: float = 3.0) -> SrbSimState:
    """One sim tick.

    Trunk: SRB under the stance contact forces (+gravity). The applied
    per-foot force is the controller's held MPC/QP force on the current
    stance set, corrected by two terms modeling what stiff massless legs
    physically transmit between solves (the round-3 "welded-anchor +
    held-force" ceiling, STATUS r3: above ~0.4 m/s the raw held-force
    model pitch-dives where the 18-DoF sim runs the same controller
    stably — both fixes below close that gap):

      * wrench-deficit redistribution: when the contact set changes
        between MPC solves (a trot flip), the held solution still
        allocates support to feet that just lifted; rigid legs transmit
        that commanded wrench through whichever feet ARE grounded, so the
        dropped legs' wrench is re-allocated min-norm onto the current
        stance feet (exact when fresh: the deficit is zero right after a
        solve). Moment components two point-feet cannot realize (about
        their connecting line) are dropped by the damped 6x6 solve.
      * joint-servo damping: the stance command carries kd=3 on its
        joints (control/locomotion.py STANCE_KD, the reference's
        legCommand {0,0,0,3,tau}); with feet welded, trunk motion drives
        joint velocities and the motor law resists — the foot-space
        reaction kd J^-T dq that the whole-body sim's hybrid motor law
        produces and the raw held-force model dropped. This is the
        velocity feedback that damps the inter-solve sag.

    Swing joints: critically-damped first-order tracking of the commanded
    targets (time constant ~20 ms, the closed-loop bandwidth the reference's
    kp=100/kd=1-2 motor law achieves on the real actuators).
    Stance joints: recomputed by IK so stance feet stay welded to their
    world anchors under the new base pose.
    """
    r = se3.quat_to_rotmat(state.quat)
    mass = params.total_mass
    f_held = forces_world * stance_mask[:, None]

    foot_base = kinematics.foot_positions_in_base_frame(params, state.q)
    r_feet_world = jnp.einsum("ij,lj->li", r, foot_base - params.com_offset)

    # Wrench the held solution assigned to now-lifted feet.
    f_miss = forces_world * (1.0 - stance_mask[:, None])
    w_miss = jnp.concatenate([
        jnp.sum(f_miss, axis=0),
        jnp.sum(jnp.cross(r_feet_world, f_miss), axis=0)])
    # Min-norm re-allocation onto current stance feet: columns of the
    # 6x12 contact map A_i = [I; skew(r_i)] (masked), delta = A^T (A A^T
    # + eps I)^-1 w_miss.
    eye3 = jnp.eye(3, dtype=f_held.dtype)
    skews = se3.skew(r_feet_world)                        # [4, 3, 3]
    a_map = jnp.concatenate([
        jnp.broadcast_to(eye3, (4, 3, 3)), skews], axis=1)  # [4, 6, 3]
    a_map = a_map * stance_mask[:, None, None]
    aat = jnp.einsum("lik,ljk->ij", a_map, a_map) \
        + 1e-2 * jnp.eye(6, dtype=f_held.dtype)
    # Closed-form SPD inverse (core/linalg block-Schur + 3x3 adjugate) —
    # NOT jnp.linalg.solve: XLA's batched LU in the vmapped tick scan
    # cost ~7x the whole rollout on the accelerator this was first tuned
    # on (to re-check on the GPU).
    lam = jnp.einsum("ij,j->i", linalg.inv_spd(aat), w_miss)
    delta = jnp.einsum("lij,i->lj", a_map, lam)           # [4, 3]

    # Joint-servo damping reaction (stance legs): tau_d = -kd dq maps to
    # a ground force f_base = kd J^-T dq_leg. With welded feet the stance
    # joint velocity is dq = J^-1 v_fb (v_fb = foot velocity in the base
    # frame from trunk motion), so the reaction is computed DIRECTLY from
    # the trunk state: f_base = kd (J J^T + lam)^-1 v_fb, via the
    # closed-form 3x3 SPD adjugate (core/linalg). Two performance rules
    # learned on the accelerator this was first tuned on (batch-2048
    # rollout; to re-check on the GPU): jnp.linalg.solve (XLA batched LU)
    # inside the vmapped tick scan cost ~7x the ENTIRE rollout, and
    # routing the force through state.dq — even as a constant gain —
    # serializes the scan's longest path (the trunk update then waits on
    # the previous tick's stance-IK chain) for a further ~5x; the
    # trunk-state form keeps the dependency chain short and is the
    # steady-stance physics either way.
    jac = kinematics.all_leg_jacobians(params, state.q)
    v_fb = -jnp.einsum(
        "ji,lj->li", r,
        state.vel_world[None, :]
        + jnp.cross(jnp.broadcast_to(state.omega_world, (4, 3)),
                    r_feet_world))
    jjt = jnp.einsum("lik,ljk->lij", jac, jac) \
        + 1e-3 * jnp.eye(3, dtype=jac.dtype)
    f_damp_base = stance_kd * jnp.einsum("lij,lj->li", linalg.inv_spd(jjt),
                                         v_fb)
    f_damp = jnp.einsum("ij,lj->li", r, f_damp_base) * stance_mask[:, None]

    f = f_held + delta + f_damp

    # --- trunk dynamics ---
    acc = jnp.sum(f, axis=0) / mass + jnp.asarray([0.0, 0.0, -9.81],
                                                  f.dtype)
    torque = jnp.sum(jnp.cross(r_feet_world, f), axis=0)
    i_world = r @ params.total_inertia @ r.T
    ang_acc = jnp.einsum("ij,j->i", linalg.inv_spd(i_world), torque)

    vel = state.vel_world + acc * dt
    omega = state.omega_world + ang_acc * dt
    pos = state.position + vel * dt
    omega_body = omega @ r
    quat = se3.quat_integrate(state.quat, omega_body, dt)
    r_new = se3.quat_to_rotmat(quat)

    # --- legs ---
    # Swing joints servo toward their targets.
    servo_tau = dt / 0.02
    q_swing = state.q + jnp.clip(servo_tau, 0.0, 1.0) * (q_swing_des - state.q)
    dq_swing = dq_swing_des

    # Stance feet welded: q from IK of anchor in the new base frame.
    anchor = jnp.where(stance_mask[:, None] > 0.5, state.foot_anchor,
                       jnp.einsum("ij,lj->li", r_new, foot_base) + pos)
    foot_base_new = jnp.einsum("ji,lj->li", r_new, anchor - pos)
    q_stance = kinematics.joint_angles_from_foot_positions(params,
                                                           foot_base_new)
    # Stance joint velocity: J dq = -R^T(v + w x r)  (foot fixed in world).
    foot_vel_base = -jnp.einsum(
        "ji,lj->li", r_new,
        vel[None, :] + jnp.cross(jnp.broadcast_to(omega, (4, 3)),
                                 jnp.einsum("ij,lj->li", r_new, foot_base_new)))
    jac = kinematics.all_leg_jacobians(params, q_stance)
    dq_stance = kinematics.damped_jacobian_solve(jac, foot_vel_base)

    stance_joint_mask = jnp.repeat(stance_mask, 3)
    q_new = jnp.where(stance_joint_mask > 0.5, q_stance,
                      jnp.where(swing_joint_mask > 0.5, q_swing, state.q))
    dq_new = jnp.where(stance_joint_mask > 0.5, dq_stance.reshape(12),
                       jnp.where(swing_joint_mask > 0.5, dq_swing,
                                 jnp.zeros_like(state.dq)))

    return state.replace(
        position=pos, quat=quat, vel_world=vel, omega_world=omega,
        q=q_new, dq=dq_new, foot_anchor=anchor, t=state.t + dt)
