"""A1 advanced-trot demo — the engine's `example_a1_sim` equivalent
(reference: examples/example_a1_sim/example_a1_sim.cpp).

Runs a closed-loop MPC trot in the pure-array SRB simulator and writes
trace plots. Works on the GPU or, with JAX_PLATFORMS=cpu, the CPU.

    python examples/example_a1_trot.py [--steps 1000] [--vx 0.4]
"""

import argparse

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

from quadruped_jax.robots import a1_params
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.control import mpc, swing
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.sim.rollout import rollout
from quadruped_jax.utils import viz
from quadruped_jax.utils.logging import summarize_rollout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--horizon", type=int, default=10)
    args = ap.parse_args()

    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=args.horizon, qp_iters=40),
        swing=swing.SwingConfig(),
        gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=args.vx, body_height=0.27)

    res = jax.jit(lambda: rollout(config, a1_params(), cmd,
                                  steps=args.steps))()
    jax.block_until_ready(res.base_height_trace)

    print("summary:", summarize_rollout(res))
    path = viz.plot_rollout(res, "/tmp/a1_trot.png")
    if path:
        print("plots:", path)


if __name__ == "__main__":
    main()
