"""Render a trotting A1 to an animated 3-D GIF (the xpp/RViz analogue).

    JAX_PLATFORMS=cpu python examples/example_viz3d.py [out.gif]

Runs a 2 s whole-body advanced trot, captures per-tick base pose + joint
angles, and writes an animated skeleton GIF plus a 3-panel snapshot.
Reference analogue: qr_control2gazebo_msg.cpp:30+ feeding xpp_vis.
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

from quadruped_jax.control import mpc, swing
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.core import se3
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import whole_body as wb
from quadruped_jax.utils import viz3d


def main(out="/tmp/trot3d.gif", steps=1000):
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=0.3, body_height=0.27)

    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm)
    ctrl0 = locomotion_init(config, params, obs0)

    def step(carry, i):
        sim, ctrl = carry
        obs = wb.observe(params, model, sim, cm)
        command, forces, ctrl = locomotion_step(
            config, params, ctrl, obs, cmd,
            (i + 1).astype(jnp.float32) * 0.002)
        sim, flags = wb.whole_body_step(params, model, sim, command, cm,
                                        0.002)
        return (sim, ctrl), (sim.fb.position, se3.quat_to_rpy(sim.fb.quat),
                             sim.fb.q, flags)

    _, (pos, rpy, q, contact) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, ctrl0), jnp.arange(steps)))()
    trace = viz3d.Viz3DTrace(position=np.asarray(pos), rpy=np.asarray(rpy),
                             joint_angles=np.asarray(q),
                             contact=np.asarray(contact))
    gif = viz3d.animate_rollout(params, trace, out, every=20, fps=12)
    png = viz3d.snapshot(params, trace, out.rsplit(".", 1)[0] + ".png",
                         ticks=(0, steps // 2, steps - 1))
    print(f"wrote {gif} and {png}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
