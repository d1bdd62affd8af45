"""Lite3 statically-stable walk — the engine's `example_lite3_sim`
equivalent in WALK mode (reference: examples/example_lite3_sim/ with
JOY_WALK; gait table from quadruped/config/lite3_sim/openloop_gait_
generator.yaml walk section).

One leg swings at a time through the FULL_STANCE -> UNLOAD_FORCE ->
TRUE_SWING -> LOAD_FORCE sub-state machine while the pose planner shifts
the base over the support triangle.

    python examples/example_lite3_walk.py [--steps 4000] [--vx 0.015]
"""

from __future__ import annotations

import argparse

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from quadruped_jax.robots import lite3_params
from quadruped_jax.gait import WALK
from quadruped_jax.gait.walk import SubLegState
from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.walk_locomotion import (WalkConfig, walk_init,
                                                   walk_step)
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.sim import srb_sim

DT = 0.002


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--vx", type=float, default=0.015)
    args = ap.parse_args()

    params = lite3_params()
    config = WalkConfig(
        gait=WALK(),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=300))
    cmd = TwistCommand.constant(vx=args.vx,
                                body_height=float(params.body_height))

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4))
    st0 = walk_init(config, params, obs0)

    def step(carry, i):
        sim, st = carry
        support = (st.gait.leg_sub_state
                   != SubLegState.TRUE_SWING).astype(jnp.float32)
        obs = srb_sim.observe(params, sim, support)
        command, forces, st = walk_step(config, params, st, obs, cmd,
                                        (i + 1).astype(jnp.float32) * DT)
        support_new = (st.gait.leg_sub_state
                       != SubLegState.TRUE_SWING).astype(jnp.float32)
        sim = srb_sim.srb_sim_step(
            params, sim, forces, support_new, command.q, command.dq,
            1.0 - jnp.repeat(support_new, 3), DT)
        return (sim, st), (sim.position, st.gait.leg_sub_state)

    (sim, st), (pos, subs) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(args.steps)))()
    pos = np.asarray(pos)
    subs = np.asarray(subs)
    swings = (subs == SubLegState.TRUE_SWING)
    print(f"walked {pos[-1, 0]:+.3f} m in {args.steps * DT:.1f} s "
          f"(command {args.vx} m/s)")
    print(f"height band: [{pos[:, 2].min():.3f}, {pos[:, 2].max():.3f}] m")
    print(f"swing ticks per leg: {swings.sum(axis=0)}")
    print(f"max simultaneous swings: {swings.sum(axis=1).max()} "
          "(static stability requires <= 1)")


if __name__ == "__main__":
    main()
