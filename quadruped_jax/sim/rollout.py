"""Closed-loop batched rollouts: controller + SRB sim under lax.scan.

This is the engine's replacement for the reference's example mains
(examples/example_a1_sim/example_a1_sim.cpp:211-261 run loop): instead of one
robot stepping against Gazebo over ROS, a whole batch of scenarios steps
against the pure-array simulator inside one jitted scan. Divergence (tip-over
/ NaN) is tracked per batch element as a mask instead of a process exit —
the batched analogue of the reference's tip-over guards (:232-241).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              LocomotionState,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait.scheduler import stance_contact_mask
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.sim import srb_sim


class RolloutResult(NamedTuple):
    sim: srb_sim.SrbSimState          # final sim state (batched)
    control: LocomotionState          # final control state
    alive: jnp.ndarray                # [...] 1.0 if never diverged
    base_height_trace: jnp.ndarray    # [T, ...] CoM height over time
    vel_trace: jnp.ndarray            # [T, ..., 3] world velocity
    forces_trace: jnp.ndarray         # [T, ..., 4, 3] stance forces


def _tip_over(state: srb_sim.SrbSimState) -> jnp.ndarray:
    """Reference tip-over guard (example_a1_sim.cpp:232-241): base z outside
    [0.10, 0.40] or |roll| > 0.6 rad counts as divergence."""
    from quadruped_jax.core import se3

    rpy = se3.quat_to_rpy(state.quat)
    bad = ((state.position[..., 2] < 0.08) | (state.position[..., 2] > 0.45)
           | (jnp.abs(rpy[..., 0]) > 0.6) | (jnp.abs(rpy[..., 1]) > 0.6))
    nan = ~jnp.isfinite(state.position[..., 2])
    return (bad | nan).astype(jnp.float32)


class RolloutCarry(NamedTuple):
    """Resumable closed-loop state: everything `rollout` threads through its
    scan, plus the global step counter (so a resumed segment continues the
    same time axis). Checkpointable via utils/checkpoint.py."""

    sim: srb_sim.SrbSimState
    ctrl: LocomotionState
    dead: jnp.ndarray                 # [...] 1.0 once diverged
    step: jnp.ndarray                 # scalar int32, global steps completed


def rollout_init(config: LocomotionConfig,
                 params: RobotParams) -> RolloutCarry:
    """Fresh carry at t=0 (the reference's boot: triple ReceiveObservation +
    StandUp before the loop, qr_robot_runner.cpp:115-119)."""
    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4, jnp.float32))
    ctrl0 = locomotion_init(config, params, obs0)
    return RolloutCarry(sim=sim0, ctrl=ctrl0,
                        dead=jnp.zeros((), jnp.float32),
                        step=jnp.zeros((), jnp.int32))


def rollout_segment(config: LocomotionConfig, params: RobotParams,
                    cmd: TwistCommand, carry: RolloutCarry, steps: int,
                    control_dt: float = 0.002):
    """Advance a rollout by `steps` ticks from an arbitrary carry.

    Running one segment of N steps from rollout_init is bitwise-identical
    to rollout(steps=N); two back-to-back segments equal one long one
    (tests/test_checkpoint.py), which is what makes checkpoint/resume
    exact rather than approximate.
    """
    # WBC needs the whole-body model (reference: qrFSMStateLocomotion ctor
    # calls BuildDynamicModel before constructing the WBC).
    model = fb.build_model(params) if config.use_wbc else None

    def step(carry_t, i):
        sim, ctrl, dead = carry_t
        t = (i + 1).astype(jnp.float32) * control_dt
        contact = stance_contact_mask(ctrl.gait)
        obs = srb_sim.observe(params, sim, contact)
        command, forces, ctrl_new = locomotion_step(config, params, ctrl,
                                                    obs, cmd, t, model=model)
        stance = stance_contact_mask(ctrl_new.gait)
        swing_mask = 1.0 - jnp.repeat(stance, 3)
        sim_new = srb_sim.srb_sim_step(
            params, sim, forces, stance, command.q, command.dq, swing_mask,
            control_dt)
        dead = jnp.maximum(dead, _tip_over(sim_new))
        # Freeze dead rollouts (keeps traces finite).
        sim_new = jax.tree.map(
            lambda new, old: jnp.where(dead > 0.5, old, new), sim_new, sim)
        out = (sim_new.position[..., 2], sim_new.vel_world, forces)
        return (sim_new, ctrl_new, dead), out

    (sim, ctrl, dead), (hs, vs, fs) = jax.lax.scan(
        step, (carry.sim, carry.ctrl, carry.dead),
        carry.step + jnp.arange(steps))
    new_carry = RolloutCarry(sim=sim, ctrl=ctrl, dead=dead,
                             step=carry.step + steps)
    result = RolloutResult(sim=sim, control=ctrl, alive=1.0 - dead,
                           base_height_trace=hs, vel_trace=vs,
                           forces_trace=fs)
    return new_carry, result


def rollout(config: LocomotionConfig, params: RobotParams,
            cmd: TwistCommand, steps: int, control_dt: float = 0.002):
    """Run one closed-loop rollout (vmap over leading axes for batches)."""
    _, result = rollout_segment(config, params, cmd,
                                rollout_init(config, params), steps,
                                control_dt)
    return result
