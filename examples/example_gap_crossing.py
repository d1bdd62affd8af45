"""Cross a gap strip with the walk stack and render it to a 3-D GIF.

    JAX_PLATFORMS=cpu python examples/example_gap_crossing.py [out.gif] [seconds]

The statically-stable walk crosses a 6 cm gap on the 18-DoF whole-body
sim, with planner/foot_stepper.gap_foothold_adjust coordinating the
footholds (hold at the near edge, cross past the center, pair
coordination) — the plum-pile half of the reference's qrFootStepper
capability (qr_foot_stepper.cpp:339,:483), demonstrated and rendered
with the terrain wireframe (the gap shows as a trench in the ground
mesh). Same configuration as tests/test_gap_crossing.py; the 3-D render
is the xpp/RViz analogue.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.walk_locomotion import (WalkConfig, walk_init,
                                                   walk_step)
from quadruped_jax.core import se3
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait.scheduler import _config
from quadruped_jax.planner import foot_stepper
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import terrain, whole_body as wb
from quadruped_jax.utils import viz3d

DT = 0.002
GAP_X = 0.25
GAP_W = 0.06


def main(out="/tmp/gap3d.gif", seconds="40"):
    seconds = float(seconds)
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    terr = terrain.gaps(gap_centers=(GAP_X,), gap_width=GAP_W, depth=0.5)
    centers = jnp.asarray([GAP_X])

    def adjust(target, feet):
        x_adj = foot_stepper.gap_foothold_adjust(
            target[:, 0], centers, GAP_W, margin=0.02,
            current_x=feet[:, 0])
        return target.at[:, 0].set(x_adj)

    config = WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.])))
    cmd = TwistCommand.constant(vx=0.03, body_height=0.27)

    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm, terrain_height=terr)
    st0 = walk_init(config, params, obs0)
    steps = int(seconds / DT)

    def step(carry, i):
        sim, st = carry
        obs = wb.observe(params, model, sim, cm, terrain_height=terr)
        command, forces, st = walk_step(
            config, params, st, obs, cmd,
            (i + 1).astype(jnp.float32) * DT,
            terrain_height=terr, foothold_adjust_fn=adjust)
        sim, flags = wb.whole_body_step(params, model, sim, command, cm,
                                        DT, terrain_height=terr)
        return (sim, st), (sim.fb.position, se3.quat_to_rpy(sim.fb.quat),
                           sim.fb.q, flags)

    (_, _), (pos, rpy, q, contact) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    pos = np.asarray(pos)
    print(f"crossing: x {pos[0, 0]:+.2f} -> {pos[-1, 0]:+.2f} m, "
          f"h band [{pos[:, 2].min():.3f}, {pos[:, 2].max():.3f}] "
          f"(gap {GAP_W} m at x={GAP_X})")
    trace = viz3d.Viz3DTrace(position=pos, rpy=np.asarray(rpy),
                             joint_angles=np.asarray(q),
                             contact=np.asarray(contact))
    gif = viz3d.animate_rollout(params, trace, out, every=60, fps=10,
                                terrain=terr)
    png = viz3d.snapshot(params, trace, out.rsplit(".", 1)[0] + ".png",
                         ticks=(0, steps // 2, steps - 1), terrain=terr)
    print(f"wrote {gif} and {png}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
