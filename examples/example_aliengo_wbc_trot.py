"""Aliengo advanced trot with WBC — the engine's `example_aliengo_sim`
equivalent in JOY_ADVANCED_TROT with useWBC (reference:
examples/example_aliengo_sim/ + quadruped/src/fsm/qr_fsm_state_locomotion.cpp
Run(): MPC stance forces, then qrWbcLocomotionController refines torques on
its 2-tick cadence).

    python examples/example_aliengo_wbc_trot.py [--steps 800] [--vx 0.3]
"""

from __future__ import annotations

import argparse

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np

from quadruped_jax.robots import aliengo_params
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.control import mpc, swing, wbc
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.sim.rollout import rollout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--vx", type=float, default=0.3)
    ap.add_argument("--no-wbc", action="store_true",
                    help="MPC-only baseline for comparison")
    args = ap.parse_args()

    params = aliengo_params()
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
        swing=swing.SwingConfig(),
        gait=ADVANCED_TROT(),
        wbc=None if args.no_wbc else wbc.WbcConfig(),
        use_wbc=not args.no_wbc)
    cmd = TwistCommand.constant(vx=args.vx,
                                body_height=float(params.body_height))

    res = jax.jit(lambda: rollout(config, params, cmd, steps=args.steps))()
    res = jax.device_get(res)
    h = np.asarray(res.base_height_trace)
    v = np.asarray(res.vel_trace)
    label = "MPC-only" if args.no_wbc else "MPC+WBC"
    print(f"[{label}] alive={float(res.alive):.0f} "
          f"final pos={np.asarray(res.sim.position).round(3)}")
    print(f"height band [{h.min():.3f}, {h.max():.3f}] m; "
          f"mean vx (last half) = {v[len(v) // 2:, 0].mean():+.3f} "
          f"(command {args.vx:+.2f})")


if __name__ == "__main__":
    main()
