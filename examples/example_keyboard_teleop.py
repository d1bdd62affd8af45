"""Interactive keyboard teleop — the engine's `example_keyboard` equivalent
(reference: examples/example_keyboard/ + quadruped/src/ros/qr_telekeyboard.cpp).

Drives the closed-loop A1 trot interactively: a host thread reads single
keys (w/s forward speed, a/d lateral, q/e yaw rate, space = stop, x = quit)
while the jitted control+sim step advances in chunks, printing the robot
state each chunk. Without a TTY (e.g. CI), pass --script to replay a
scripted key sequence instead.

    python examples/example_keyboard_teleop.py [--script "wwqq  x"]
"""

from __future__ import annotations

import argparse
import sys
import time

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp

from quadruped_jax.robots import a1_params
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.control import mpc, swing, teleop
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.sim import srb_sim
from quadruped_jax.gait.scheduler import stance_contact_mask

CHUNK = 100  # control ticks (0.002 s each) per key poll
DT = 0.002


def make_chunk_step(config, params):
    """One jitted chunk: CHUNK closed-loop ticks under a fixed command."""

    def chunk(sim, state, cmd, t0):
        def tick(carry, i):
            sim, state = carry
            support = stance_contact_mask(state.gait)
            obs = srb_sim.observe(params, sim, support)
            t = t0 + (i + 1).astype(jnp.float32) * DT
            command, forces, state = locomotion_step(
                config, params, state, obs, cmd, t)
            support_new = stance_contact_mask(state.gait)
            sim = srb_sim.srb_sim_step(
                params, sim, forces, support_new, command.q, command.dq,
                1.0 - jnp.repeat(support_new, 3), DT)
            return (sim, state), None

        (sim, state), _ = jax.lax.scan(tick, (sim, state),
                                       jnp.arange(CHUNK))
        return sim, state

    return jax.jit(chunk)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--script", type=str, default=None,
                    help="scripted key sequence (no TTY needed)")
    ap.add_argument("--chunks", type=int, default=40,
                    help="max chunks in scripted mode")
    args = ap.parse_args()

    params = a1_params()
    config = LocomotionConfig(mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
                              swing=swing.SwingConfig(),
                              gait=ADVANCED_TROT())
    sim = srb_sim.srb_sim_init(params)
    obs = srb_sim.observe(params, sim, jnp.ones(4))
    state = locomotion_init(config, params, obs)
    chunk_step = make_chunk_step(config, params)

    cmd = TwistCommand.constant(body_height=float(params.body_height))
    t0 = jnp.zeros(())

    def report(sim, cmd):
        pos = jax.device_get(sim.position)
        vel = jax.device_get(sim.vel_world)
        print(f"  pos=({pos[0]:+.2f},{pos[1]:+.2f},{pos[2]:.3f}) "
              f"v=({vel[0]:+.2f},{vel[1]:+.2f}) "
              f"cmd vx={float(cmd.linear[0]):+.2f} "
              f"vy={float(cmd.linear[1]):+.2f} "
              f"wz={float(cmd.angular_z):+.2f}", flush=True)

    if args.script is not None or not sys.stdin.isatty():
        keys = list(args.script or "wwww  x")
        print("scripted teleop:", keys)
        for n, key in enumerate(keys[:args.chunks]):
            if key == "x":
                break
            cmd = teleop.apply_key(cmd, key)
            sim, state = chunk_step(sim, state, cmd, t0)
            t0 = t0 + CHUNK * DT
            report(sim, cmd)
        return

    print("keys: w/s = vx, a/d = vy, q/e = yaw rate, space = stop, x = quit")

    def on_key(new_cmd):
        nonlocal sim, state, cmd, t0
        cmd = new_cmd
        sim, state = chunk_step(sim, state, cmd, t0)
        t0 = t0 + CHUNK * DT
        report(sim, cmd)

    teleop.keyboard_teleop_loop(on_key,
                                body_height=float(params.body_height))


if __name__ == "__main__":
    main()
