"""Cadence-hoisted batched rollouts: MPC solves once per control chunk.

The plain rollout (sim/rollout.py) reproduces the reference's tick
multiplexing with `lax.cond` inside every tick — but under vmap both
branches execute, so every tick pays a full QP solve even though the
reference only solves every 15 ticks. This driver restructures the loop to
match the cadence *physically*:

    outer scan (one MPC period):
        solve the MPC once (solve_mode="always")
        inner scan (ticks_per_solve ticks):
            gait + swing + held forces + sim step (solve_mode="never")

Same control semantics (the reference holds forces between solves), ~10x
cheaper per simulated second for large batches. This is the scenario-sweep
workhorse (BASELINE config 4/5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.gait.scheduler import stance_contact_mask
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.sim import srb_sim


class CadencedRolloutResult(NamedTuple):
    sim: srb_sim.SrbSimState
    alive: jnp.ndarray
    base_height_trace: jnp.ndarray   # [n_periods, ...]
    vel_trace: jnp.ndarray           # [n_periods, ..., 3]
    forces: jnp.ndarray              # [..., 4, 3] last MPC solution (held)


def rollout_cadenced(config: LocomotionConfig, params: RobotParams,
                     cmd: TwistCommand, n_periods: int,
                     ticks_per_solve: int | None = None,
                     control_dt: float = 0.002):
    """Closed-loop rollout solving the MPC once per `ticks_per_solve` ticks
    (default: the config's time-based cadence, MpcConfig.ticks_per_solve)."""
    if ticks_per_solve is None:
        ticks_per_solve = config.mpc.ticks_per_solve
    solve_config = config.replace(mpc=config.mpc.replace(solve_mode="always"))
    hold_config = config.replace(mpc=config.mpc.replace(solve_mode="never"))

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4, jnp.float32))
    ctrl0 = locomotion_init(config, params, obs0)

    def tick(carry, t, cfg):
        sim, ctrl = carry
        contact = stance_contact_mask(ctrl.gait)
        obs = srb_sim.observe(params, sim, contact)
        command, forces, ctrl = locomotion_step(cfg, params, ctrl, obs, cmd,
                                                t)
        stance = stance_contact_mask(ctrl.gait)
        sim = srb_sim.srb_sim_step(params, sim, forces, stance, command.q,
                                   command.dq, 1.0 - jnp.repeat(stance, 3),
                                   control_dt)
        return (sim, ctrl)

    def period(carry, k):
        t0 = k.astype(jnp.float32) * ticks_per_solve * control_dt
        # Solve tick.
        carry = tick(carry, t0 + control_dt, solve_config)
        # Held ticks.

        def held(c, i):
            t = t0 + (i + 2).astype(jnp.float32) * control_dt
            return tick(c, t, hold_config), None

        carry, _ = jax.lax.scan(held, carry,
                                jnp.arange(ticks_per_solve - 1))
        sim, ctrl = carry
        return carry, (sim.position[..., 2], sim.vel_world)

    (sim, ctrl), (hs, vs) = jax.lax.scan(period, (sim0, ctrl0),
                                         jnp.arange(n_periods))
    from quadruped_jax.sim.rollout import _tip_over

    alive = 1.0 - _tip_over(sim)
    return CadencedRolloutResult(sim=sim, alive=alive, base_height_trace=hs,
                                 vel_trace=vs, forces=ctrl.mpc.forces_world)
