"""Locomotion controller: one fused control tick, batched.

Capability parity with `qrLocomotionController::{Update, GetAction}`
(quadruped/src/controllers/qr_locomotion_controller.cpp:69-147) plus the
FSM locomotion state's WBC integration
(quadruped/src/fsm/qr_fsm_state_locomotion.cpp:129-158): advance the gait
clocks, update swing + stance controllers, optionally run the WBC (every
2nd tick, mutually exclusive with MPC solve ticks via `allowAfterMPC`,
qr_mpc_stance_leg_controller.cpp:310), and merge the per-joint swing
commands over the stance torque map into one 12-joint hybrid command.

The reference merges with a std::map overlay (swing joints win); here the
merge is a masked select: swing joints get {q, Kp, dq, Kd, 0}, stance joints
get {0, 0, 0, Kd_damp, tau_ff} (the MPC stance command shape at
qr_mpc_stance_leg_controller.cpp:137-153), with tau_ff replaced by the WBIC
torque on WBC ticks (qr_wbc_locomotion_controller.cpp:204-219).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quadruped_jax.core import struct
from quadruped_jax.gait.scheduler import (GaitConfig, GaitState, gait_init,
                                          gait_update, stance_contact_mask)
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.control.types import RobotObservation, HybridCommand
from quadruped_jax.control.desired_state import (DesiredStateCommand,
                                                 TwistCommand,
                                                 desired_state_init,
                                                 desired_state_update)
from quadruped_jax.control import gait_transition as gt_mod
from quadruped_jax.control import mpc as mpc_mod
from quadruped_jax.control import swing as swing_mod
from quadruped_jax.control import wbc as wbc_mod
from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.desired_state import ControlMode
from quadruped_jax.planner import com_adjuster

STANCE_KD = 3.0  # damping on stance joints (reference legCommand {0,0,0,3,tau})
# Forward CoM offset added to the WBC body-position target
# (qr_mpc_stance_leg_controller.cpp:312).
WBC_COM_OFFSET_X = 0.018


@struct.dataclass
class LocomotionConfig:
    mpc: mpc_mod.MpcConfig
    swing: swing_mod.SwingConfig
    gait: GaitConfig
    wbc: wbc_mod.WbcConfig | None = None
    use_wbc: bool = struct.field(pytree_node=False, default=False)
    # Locomotion mode (ControlMode): ADVANCED_TROT -> convex MPC stance;
    # VELOCITY / POSITION / WALK -> force-balance stance
    # (qrStanceLegControllerInterface dispatch,
    # qr_stance_leg_controller_interface.cpp).
    mode: int = struct.field(pytree_node=False,
                             default=3)  # ControlMode.ADVANCED_TROT
    force_balance: "stance_fb.ForceBalanceConfig | None" = None
    # Second gait table enabling online gait transitions
    # (control/gait_transition.py; reference SwitchMode,
    # qr_fsm_state_locomotion.cpp:271-340). A rising edge on
    # TwistCommand.gait_switch toggles between `gait` and `gait_b` via
    # decel -> stance-hold -> swap.
    gait_b: GaitConfig | None = None


@struct.dataclass
class LocomotionState:
    gait: GaitState
    mpc: mpc_mod.MpcState
    swing: swing_mod.SwingState
    command: DesiredStateCommand
    wbc_iteration: jnp.ndarray  # [] int32
    transition: gt_mod.GaitTransitionState | None = None


def locomotion_init(config: LocomotionConfig, params: RobotParams,
                    obs: RobotObservation,
                    cold_start: bool = True) -> LocomotionState:
    gait_state = gait_init(config.gait)
    mpc_state = mpc_mod.mpc_init(config.mpc, params.body_height)
    command = desired_state_init(params.body_height)
    if cold_start and config.mode == ControlMode.ADVANCED_TROT:
        # Seed the warm-start state with one high-budget solve so every
        # scanned tick runs the parity-verified warm 24-iteration budget
        # (see mpc_cold_start; replaces the reference's solve-every-tick
        # boot phase). Runs once per rollout, jit-safe.
        mpc_state = mpc_mod.mpc_cold_start(
            config.mpc, params, config.gait, gait_state, mpc_state, obs,
            command)
    return LocomotionState(
        gait=gait_state,
        mpc=mpc_state,
        swing=swing_mod.swing_init(params, obs),
        command=command,
        wbc_iteration=jnp.zeros((), jnp.int32),
        transition=(gt_mod.gait_transition_init()
                    if config.gait_b is not None else None),
    )


def _wbc_command(state_mpc: mpc_mod.MpcState, swing_state,
                 obs: RobotObservation, gait_state: GaitState,
                 body_height) -> wbc_mod.WbcCommand:
    """Assemble qrWbcCtrlData from MPC + swing outputs
    (qr_mpc_stance_leg_controller.cpp:310-331)."""
    r = obs.rot_body_to_world
    v_des_world = r @ jnp.stack([state_mpc.x_vel_des, state_mpc.y_vel_des,
                                 jnp.zeros_like(state_mpc.x_vel_des)])
    offset = r @ jnp.asarray([WBC_COM_OFFSET_X, 0.0, 0.0], jnp.float32)
    p_des = jnp.stack([state_mpc.pos_des_world[0] + offset[0],
                       state_mpc.pos_des_world[1] + offset[1],
                       body_height])
    stance = stance_contact_mask(gait_state)
    return wbc_mod.WbcCommand(
        p_body_des=p_des,
        v_body_des=v_des_world.at[2].set(0.0),
        a_body_des=jnp.zeros(3, jnp.float32),
        rpy_des=jnp.stack([jnp.zeros(()), jnp.zeros(()), state_mpc.yaw_des]),
        omega_des_world=jnp.stack([jnp.zeros(()), jnp.zeros(()),
                                   state_mpc.yaw_turn_rate]),
        p_foot_des=swing_state.wbc_pfoot_des,
        v_foot_des=swing_state.wbc_vfoot_des,
        a_foot_des=swing_state.wbc_afoot_des,
        fr_des=state_mpc.forces_world,
        contact_state=stance,
    )


def locomotion_step(config: LocomotionConfig, params: RobotParams,
                    state: LocomotionState, obs: RobotObservation,
                    cmd: TwistCommand, t: jnp.ndarray,
                    model: fb.FloatingBaseModel | None = None,
                    v_preview: jnp.ndarray | None = None,
                    z_preview: jnp.ndarray | None = None):
    """One 500 Hz-1 kHz control tick.

    Returns (HybridCommand, forces_world [4,3], new state).
    Pass `model` (from dynamics.floating_base.build_model) to enable the
    WBC path when config.use_wbc. `v_preview` ([H] body-frame forward
    velocity over the MPC horizon — a known speed schedule) feeds the
    MPC's desired trajectory (mpc._desired_trajectory preview form).
    """
    # Gait transition manager (reference SwitchMode/StandLoop): scales the
    # command, may freeze/swap the gait clock, and pins full stance during
    # the hold. Active only when a second gait table is configured.
    if config.gait_b is not None:
        gait_cfg, gait_pre, cmd, hold, trans_state = \
            gt_mod.gait_transition_step(state.transition, state.gait,
                                        config.gait, config.gait_b, cmd, t,
                                        obs.foot_contact)
    else:
        gait_cfg, gait_pre, hold, trans_state = \
            config.gait, state.gait, None, state.transition

    des = desired_state_update(state.command, cmd)
    gait_state = gait_update(gait_cfg, gait_pre, t, obs.foot_contact)
    if hold is not None:
        gait_state = gt_mod.hold_stance_gait(hold, gait_state)

    q_sw, dq_sw, swing_mask, swing_state = swing_mod.swing_step(
        config.swing, params, gait_cfg, gait_state, state.swing, obs, des)

    stance = stance_contact_mask(gait_state)
    stance_joint_mask = jnp.repeat(stance, 3)

    if config.mode == ControlMode.ADVANCED_TROT:
        tau_stance, forces_world, mpc_updated, mpc_state = mpc_mod.mpc_step(
            config.mpc, params, gait_cfg, gait_state, state.mpc, obs, des,
            foot_targets_world=swing_state.foot_target_world,
            v_preview=v_preview, z_preview=z_preview)
    else:
        # Force-balance ("virtual model") stance path
        # (TorqueStanceLegController; mode dispatch at
        # qr_locomotion_controller.cpp:108-122). POSITION mode additionally
        # tracks the CoM-adjuster shift (qrComAdjuster).
        fb_config = config.force_balance or stance_fb.ForceBalanceConfig()
        des_fb = des
        if config.mode == ControlMode.POSITION:
            from quadruped_jax.robots import kinematics as kin

            feet = kin.foot_positions_in_base_frame(params, obs.joint_angles)
            com_shift = com_adjuster.com_position_in_base_frame(gait_state,
                                                               feet)
            des_fb = des.replace(
                position=des.position.at[:2].set(com_shift[:2]))
        forces_world = stance_fb.compute_contact_forces(
            fb_config, params, obs, des_fb, stance)
        tau_stance = stance_fb.stance_torques(params, obs, forces_world,
                                              stance)
        mpc_updated = jnp.zeros((), jnp.bool_)
        mpc_state = state.mpc

    if config.use_wbc and model is not None:
        wbc_cmd = _wbc_command(mpc_state, swing_state, obs, gait_state,
                               des.position[2])

        def run_wbc(_):
            _, _, tau_wbc = wbc_mod.wbc_step(config.wbc, params, model, obs,
                                             wbc_cmd)
            return tau_wbc

        # WBC every 2nd tick, never on an MPC-solve tick (allowAfterMPC).
        do_wbc = ((state.wbc_iteration % 2 == 0) & (~mpc_updated))
        tau_wbc = jax.lax.cond(do_wbc, run_wbc,
                               lambda _: tau_stance, None)
        tau_stance = jnp.where(stance_joint_mask > 0.5, tau_wbc, tau_stance)

    sw = swing_mask > 0.5
    command = HybridCommand(
        q=jnp.where(sw, q_sw, 0.0),
        kp=jnp.where(sw, params.motor_kp, 0.0),
        dq=jnp.where(sw, dq_sw, 0.0),
        kd=jnp.where(sw, params.motor_kd, STANCE_KD * stance_joint_mask),
        tau=jnp.where(sw, 0.0, tau_stance),
    )
    if config.mode == ControlMode.ADVANCED_TROT:
        # Abad compensation torque +/-0.9 N*m alternating by leg side
        # (qr_fsm_state_locomotion.cpp:142-151).
        hip_comp = jnp.zeros(12, jnp.float32)
        for leg in range(4):
            hip_comp = hip_comp.at[3 * leg].set(0.9 * (-1.0) ** ((leg + 1) % 2))
        command = command.replace(tau=command.tau + hip_comp)
    new_state = LocomotionState(gait=gait_state, mpc=mpc_state,
                                swing=swing_state, command=des,
                                wbc_iteration=state.wbc_iteration + 1,
                                transition=trans_state)
    return command, forces_world, new_state
