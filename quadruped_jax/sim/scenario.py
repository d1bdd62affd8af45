"""Scenario grids: batched robots x gaits x commands x terrains.

The engine's replacement for the reference's one-robot/one-config process
(each reference example main hard-codes one robot and one mode): build the
cartesian product of robot parameter sets, gait tables, velocity commands
and terrain parameters as stacked pytrees, and roll them out in one vmapped
closed loop (BASELINE.json config 4: "thousands of parallel rollouts per
chip").

All robots share one morphology schema (robots/params.py), all gaits share
one clock schema (gait/scheduler.py), so a heterogeneous fleet is just a
stacked pytree — no re-compilation per robot or gait.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from quadruped_jax.robots.params import stack_params, RobotParams
from quadruped_jax.gait.scheduler import named_gait, GaitConfig
from quadruped_jax.control.desired_state import TwistCommand


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def scenario_grid(
    robots: Sequence[str] = ("a1",),
    gaits: Sequence[str] = ("trot",),
    vx_range: Sequence[float] = (0.0, 0.3, 0.6),
    wz_range: Sequence[float] = (0.0,),
    body_height: float = 0.27,
):
    """Cartesian product -> (params, gait_configs, commands, n_scenarios).

    Every returned pytree has leading axis n = len(robots) * len(gaits) *
    len(vx_range) * len(wz_range).
    """
    gait_list, cmd_list = [], []
    for _ in robots:
        for g in gaits:
            gc = named_gait(g)
            for vx in vx_range:
                for wz in wz_range:
                    gait_list.append(gc)
                    cmd_list.append(TwistCommand.constant(
                        vx=vx, wz=wz, body_height=body_height))
    # Robot params stack via the public fleet API: each robot name
    # repeated once per (gait, vx, wz) cell, matching the loop order.
    per_robot = len(gaits) * len(vx_range) * len(wz_range)
    params = stack_params([r for r in robots for _ in range(per_robot)])
    return params, _stack(gait_list), _stack(cmd_list), len(cmd_list)


def tile_scenarios(tree, repeats: int):
    """Tile a stacked scenario pytree to a larger batch (perf sweeps)."""
    return jax.tree.map(
        lambda x: jnp.tile(x, (repeats,) + (1,) * (x.ndim - 1)), tree)
