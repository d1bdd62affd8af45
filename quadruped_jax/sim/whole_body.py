"""Whole-body batched simulator: 18-DoF dynamics + penalty contact + motor law.

This is the engine's high-fidelity replacement for the reference's Gazebo
loop (simulation/qr_gazebo launch + per-joint ros_control plugin +
foot-contact sensor plugin). One sim tick:

  1. hybrid motor law  tau = Kp (q_des - q) + Kd (dq_des - dq) + tau_ff
     (simulation/unitree_legged_control/src/joint_controller.cpp:134), with
     the torque clip the reference's Safety layer applies;
  2. ground contact forces at the 4 feet from a regularized spring-damper +
     Coulomb friction model (the same contact abstraction Gazebo's ODE
     solver provides, in penalty form so it vmaps);
  3. forward dynamics of the 13-body Featherstone model
     (dynamics/floating_base.forward_dynamics) under the joint torques and
     world-frame foot forces;
  4. semi-implicit Euler integration of the floating-base state.

Terrain is a height field callback (sim/terrain.py); the default is flat
ground at z = 0.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from quadruped_jax.core import se3
from quadruped_jax.core import struct
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.control.types import RobotObservation, HybridCommand


@struct.dataclass
class ContactModel:
    """Penalty contact + actuator limit parameters (per scenario batchable)."""

    k_normal: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(8000.0))   # N/m
    # Hunt-Crossley damping-restitution coefficient alpha (s/m): the
    # normal force is f = k d (1 + 1.5 alpha d_dot), so damping vanishes
    # smoothly at zero depth (no force discontinuity at touchdown) and the
    # apparent restitution of an impact at speed v is e ~ 1 - alpha v.
    # alpha = 0.5 keeps the same effective damping as the former tuned
    # spring-damper (c_eff = 1.5 alpha k = 6000 N s/m^2) — trot traces are
    # unchanged — and makes the model's energy behavior testable
    # (tests/test_whole_body_contact.py).
    hc_alpha: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.5))      # s/m
    mu: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.6))
    v_slip: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(0.05))     # friction regularization m/s
    # Joint velocity limit (URDF limits enforced by the reference's joint
    # controller, unitree_legged_control/src/joint_controller.cpp:214; A1
    # motors ~21 rad/s).
    joint_vel_limit: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(21.0))


@struct.dataclass
class WholeBodySimState:
    fb: fb.FbState
    t: jnp.ndarray


def whole_body_init(params: RobotParams, body_height=None) -> WholeBodySimState:
    h = params.body_height if body_height is None else body_height
    state = fb.FbState(
        quat=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
        position=jnp.stack([jnp.zeros(()), jnp.zeros(()),
                            jnp.asarray(h, jnp.float32)]),
        omega_body=jnp.zeros(3, jnp.float32),
        vel_body=jnp.zeros(3, jnp.float32),
        q=params.stand_angles,
        dq=jnp.zeros(12, jnp.float32))
    return WholeBodySimState(fb=state, t=jnp.zeros((), jnp.float32))


def contact_forces(model: fb.FloatingBaseModel, state: fb.FbState,
                   contact: ContactModel,
                   terrain_height: Callable | None = None):
    """[4, 3] world-frame penalty contact forces + [4] contact flags."""
    jc, _, p_feet = fb.contact_jacobians(model, state)
    vgen = jnp.concatenate([state.omega_body, state.vel_body, state.dq])
    v_feet = jnp.einsum("lij,j->li", jc, vgen)

    ground_z = (jnp.zeros_like(p_feet[:, 2]) if terrain_height is None
                else terrain_height(p_feet[:, 0], p_feet[:, 1]))
    depth = ground_z - p_feet[:, 2]
    in_contact = depth > 0.0

    # Hunt-Crossley normal force (n = 1): f = k d + 1.5 alpha k d d_dot,
    # with penetration rate d_dot = -vz. Depth-proportional damping means
    # zero force at touchdown (no penalty-spring slam) and guarantees the
    # contact only ever DISSIPATES energy over a compression/restitution
    # cycle (alpha v_impact < 1). The clamp at zero handles separation.
    ddot = -jnp.clip(v_feet[:, 2], -10.0, 10.0)
    fz = jnp.where(
        in_contact,
        contact.k_normal * depth * (1.0 + 1.5 * contact.hc_alpha * ddot),
        0.0)
    fz = jnp.maximum(fz, 0.0)

    # Regularized Coulomb friction: f_t = -mu fz * v_t / max(|v_t|, v_slip).
    v_t = v_feet[:, :2]
    v_norm = jnp.linalg.norm(v_t, axis=-1, keepdims=True)
    scale = jnp.minimum(v_norm / contact.v_slip, 1.0)
    dir_t = v_t / jnp.maximum(v_norm, 1e-6)
    f_t = -contact.mu * fz[:, None] * scale * dir_t

    forces = jnp.concatenate([f_t, fz[:, None]], axis=-1)
    return forces, in_contact.astype(jnp.float32), p_feet


def whole_body_step(params: RobotParams, model: fb.FloatingBaseModel,
                    state: WholeBodySimState, command: HybridCommand,
                    contact: ContactModel, dt,
                    terrain_height: Callable | None = None,
                    substeps: int = 2) -> tuple[WholeBodySimState, jnp.ndarray]:
    """One control-period sim step (internally `substeps` physics steps).

    Returns (new_state, foot_contact_flags [4]).
    """
    s = state.fb
    flags = jnp.ones(4, jnp.float32)
    h = dt / substeps
    for _ in range(substeps):
        dq_cmd = jnp.clip(command.dq, -contact.joint_vel_limit,
                          contact.joint_vel_limit)
        tau_motor = command.replace(dq=dq_cmd).actuator_torque(s.q, s.dq)
        tau_motor = jnp.clip(tau_motor, -params.torque_limit,
                             params.torque_limit)
        tau_gen = jnp.concatenate([jnp.zeros(6, tau_motor.dtype), tau_motor])

        f_feet, flags, _ = contact_forces(model, s, contact, terrain_height)
        qdd = fb.forward_dynamics(model, s, tau_gen, f_feet)

        omega = s.omega_body + qdd[0:3] * h
        vel = s.vel_body + qdd[3:6] * h
        dq = s.dq + qdd[6:] * h
        quat = se3.quat_integrate(s.quat, omega, h)
        r = se3.quat_to_rotmat(s.quat)
        pos = s.position + r @ vel * h
        s = fb.FbState(quat=quat, position=pos, omega_body=omega,
                       vel_body=vel, q=s.q + dq * h, dq=dq)
    return WholeBodySimState(fb=s, t=state.t + dt), flags


def observe(params: RobotParams, model: fb.FloatingBaseModel,
            state: WholeBodySimState, contact: ContactModel,
            terrain_height: Callable | None = None) -> RobotObservation:
    s = state.fb
    r = se3.quat_to_rotmat(s.quat)
    forces, flags, _ = contact_forces(model, s, contact, terrain_height)
    return RobotObservation(
        base_position=s.position,
        base_rpy=se3.quat_to_rpy(s.quat),
        base_quat=s.quat,
        base_vel_world=r @ s.vel_body,
        base_omega_world=r @ s.omega_body,
        base_omega_body=s.omega_body,
        joint_angles=s.q,
        joint_velocities=s.dq,
        foot_contact=flags,
        foot_forces=forces[:, 2])
