"""Robot runner: the composition root for one control tick.

Capability parity with `qrRobotRunner`
(quadruped/src/exec/qr_robot_runner.cpp:97-180) + `SetUpController` (:32-85):
wire estimators -> desired-state command -> FSM -> locomotion controller
into a single pure function `runner_step`, the batched analogue of the
reference's per-tick `Update()` + `Step()` pair. The stand-up action that
the reference runs as a blocking loop at boot (:115-119) is the FSM's
STAND_UP state here.

Two observation paths, as in the reference (sim ground truth vs estimators):
  * `use_estimators=False` — the simulator's perfect state feeds the
    controllers directly (Gazebo-ground-truth mode, fastest);
  * `use_estimators=True` — raw sensors run through the estimation
    container first (estimation-in-the-loop fidelity mode).
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import struct
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.control.types import RobotObservation, HybridCommand
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              LocomotionState,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.control import fsm as fsm_mod
from quadruped_jax.estimation.container import (EstimatorConfig,
                                                EstimatorState, RawSensors,
                                                estimator_init,
                                                estimator_update)
from quadruped_jax.gait.scheduler import stance_contact_mask


@struct.dataclass
class RunnerConfig:
    locomotion: LocomotionConfig
    estimator: EstimatorConfig | None = None
    use_estimators: bool = struct.field(pytree_node=False, default=False)
    control_dt: float = struct.field(pytree_node=False, default=0.002)


@struct.dataclass
class RunnerState:
    fsm: fsm_mod.ControlFsmState
    locomotion: LocomotionState
    estimator: EstimatorState | None
    t: jnp.ndarray


def runner_init(config: RunnerConfig, params: RobotParams,
                obs: RobotObservation) -> RunnerState:
    est = (estimator_init(config.estimator, params.body_height)
           if config.use_estimators else None)
    return RunnerState(
        fsm=fsm_mod.fsm_init(obs.joint_angles),
        locomotion=locomotion_init(config.locomotion, params, obs),
        estimator=est,
        t=jnp.zeros((), jnp.float32))


def runner_step(config: RunnerConfig, params: RobotParams,
                state: RunnerState, cmd: TwistCommand,
                observation: RobotObservation | None = None,
                sensors: RawSensors | None = None,
                model: fb.FloatingBaseModel | None = None,
                fsm_request=None):
    """One tick: estimators -> FSM -> locomotion -> safe hybrid command.

    Provide `observation` (ground-truth mode) or `sensors` (estimator mode).
    `fsm_request` ([] int32 FsmState, optional) is the RC mode machine's
    state request (control/rc_mode.py).
    Returns (HybridCommand, forces_world, new RunnerState, obs used).
    """
    t = state.t + config.control_dt
    est_state = state.estimator
    if config.use_estimators:
        assert sensors is not None
        gait_state = state.locomotion.gait
        est_state, obs = estimator_update(
            config.estimator, params, state.estimator, sensors,
            normalized_phase=gait_state.normalized_phase,
            desired_stance=stance_contact_mask(gait_state),
            dt=config.control_dt)
    else:
        assert observation is not None
        obs = observation

    loco_cmd, forces, loco_state = locomotion_step(
        config.locomotion, params, state.locomotion, obs, cmd, t,
        model=model)
    command, fsm_state, in_loco = fsm_mod.fsm_step(params, state.fsm, obs,
                                                   t, loco_cmd,
                                                   desired_state=fsm_request)
    # Gait/MPC state only advances while in locomotion; otherwise hold the
    # freshly-initialized controller state (reference re-enters locomotion
    # with a Reset).
    import jax

    loco_state = jax.tree.map(
        lambda new, old: jnp.where(in_loco > 0.5, new, old),
        loco_state, state.locomotion)

    new_state = RunnerState(fsm=fsm_state, locomotion=loco_state,
                            estimator=est_state, t=t)
    return command, forces * in_loco, new_state, obs
