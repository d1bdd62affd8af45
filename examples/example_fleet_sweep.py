"""Batched scenario sweep — robots x gaits x velocity commands in one
compiled rollout, sharded over the available devices.

The batched replacement for running the reference's per-robot example mains
one at a time.

    python examples/example_fleet_sweep.py
"""

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc, swing
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.distributed import make_mesh, shard_batch
from quadruped_jax.sim.scenario import scenario_grid
from quadruped_jax.sim.rollout import rollout


def main():
    params, gaits, cmds, n = scenario_grid(
        robots=("a1", "go1", "aliengo", "lite3"),
        gaits=("trot",),
        vx_range=(0.0, 0.2, 0.4, 0.6))
    print(f"{n} scenarios on {jax.device_count()} device(s)")

    base = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=30),
        swing=swing.SwingConfig(),
        gait=jax.tree.map(lambda x: x[0], gaits))

    if jax.device_count() > 1 and n % jax.device_count() == 0:
        mesh = make_mesh()
        params, gaits, cmds = shard_batch(mesh, (params, gaits, cmds))

    def one(p, g, c):
        return rollout(base.replace(gait=g), p, c, steps=500)

    res = jax.jit(jax.vmap(one))(params, gaits, cmds)
    alive = np.asarray(res.alive)
    vx_final = np.asarray(res.vel_trace)[:, -1, 0]
    for i in range(n):
        print(f"scenario {i:2d}: alive={alive[i]:.0f} "
              f"final_vx={vx_final[i]:+.2f} m/s "
              f"height={float(res.base_height_trace[i, -1]):.3f} m")


if __name__ == "__main__":
    main()
