"""Hardware-in-the-loop tick latency: native bridge + device solve.

Measures what one end-to-end control tick costs through the REAL deployed
path: UDP state packet -> native bridge seqlock
snapshot (FleetBridge.gather) -> observation build -> the jitted
locomotion step (including the MPC solve — the WORST-case tick; 14 of
every 15 ticks skip the solve at the 15 ms cadence) -> command fetch ->
native fan-out (FleetBridge.send, torque-clipped). Reported against the
reference's budgets: 2 ms control tick (500 Hz) and the 15 ms MPC
cadence (BASELINE.md 500-1000 Hz envelope; unitree_interface.h:14-36).

Run:
    python benchmarks/hil_latency.py                 # device backend (GPU)
    python benchmarks/hil_latency.py --backend cpu   # host backend

The cpu-backend line bounds the bridge + control-stack cost itself; the
device line adds the GPU's dispatch and fetch.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np

STATE_FLOATS = 51


def make_state_packet(tick, q):
    vals = np.zeros(STATE_FLOATS, np.float32)
    vals[0] = tick
    vals[1] = 1.0                      # quat w
    vals[11:23] = q
    vals[47:51] = 30.0                 # foot forces: in contact
    return vals.tobytes()


def feeder(stop, ports, hz=1000.0):
    """Plays the robot MCUs: streams state packets at hz per robot."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    q = np.full(12, 0.3, np.float32)
    i = 0
    period = 1.0 / hz
    while not stop.is_set():
        i += 1
        pkt = make_state_packet(i, q)
        for p in ports:
            tx.sendto(pkt, ("127.0.0.1", p))
        time.sleep(period)
    tx.close()


def build_tick(n, backend):
    """Batched locomotion tick (incl. MPC solve) jitted for n robots."""
    import jax

    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from quadruped_jax.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
    from quadruped_jax.control.desired_state import TwistCommand
    from quadruped_jax.control.locomotion import (LocomotionConfig,
                                                  locomotion_init,
                                                  locomotion_step)
    from quadruped_jax.core import se3
    from quadruped_jax.control.types import RobotObservation
    from quadruped_jax.gait import ADVANCED_TROT
    from quadruped_jax.robots import a1_params

    params = a1_params()
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=0.2, body_height=0.27)

    def obs_from_rows(rows):      # rows [n, 51] float32
        quat = rows[:, 1:5]
        r = jax.vmap(se3.quat_to_rotmat)(quat)
        omega = rows[:, 5:8]
        return RobotObservation(
            base_position=jnp.tile(jnp.asarray([0.0, 0.0, 0.27]), (n, 1)),
            base_rpy=jax.vmap(se3.quat_to_rpy)(quat), base_quat=quat,
            base_vel_world=jnp.zeros((n, 3)),
            base_omega_world=jnp.einsum("bij,bj->bi", r, omega),
            base_omega_body=omega,
            joint_angles=rows[:, 11:23],
            joint_velocities=rows[:, 23:35],
            foot_contact=(rows[:, 47:51] > 5.0).astype(jnp.float32),
            foot_forces=rows[:, 47:51])

    rows0 = np.zeros((n, STATE_FLOATS), np.float32)
    rows0[:, 1] = 1.0
    rows0[:, 11:23] = 0.3
    rows0[:, 47:51] = 30.0
    obs0 = obs_from_rows(jnp.asarray(rows0))
    ctrl0 = jax.vmap(lambda o: locomotion_init(config, params, o))(obs0)

    def tick(ctrl, rows, t):
        obs = obs_from_rows(rows)
        command, forces, ctrl = jax.vmap(
            lambda c, o: locomotion_step(config, params, c, o, cmd, t)
        )(ctrl, obs)
        return ctrl, (command.q, command.kp, command.dq, command.kd,
                      command.tau)

    tick_j = jax.jit(tick)
    ctrl = ctrl0
    out = tick_j(ctrl, jnp.asarray(rows0), jnp.asarray(0.015))
    jax.block_until_ready(out)
    return tick_j, ctrl0, jnp

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="device",
                    choices=["device", "cpu"])
    ap.add_argument("--fleets", default="1,16")
    ap.add_argument("--ticks", type=int, default=300)
    args = ap.parse_args()

    from quadruped_jax.runtime import FleetBridge, native_available
    from quadruped_jax.runtime.bridge import build_native

    build_native()
    if not native_available():
        print(json.dumps({"error": "native bridge unavailable"}))
        return

    results = {}
    for n in (int(x) for x in args.fleets.split(",")):
        base_state, base_cmd = 41100, 41300
        # Sink sockets so command fan-out has a destination.
        sinks = []
        for i in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", base_cmd + i))
            s.setblocking(False)
            sinks.append(s)
        fleet = FleetBridge(n, base_recv_port=base_state,
                           base_send_port=base_cmd, torque_limit=23.0)
        stop = threading.Event()
        th = threading.Thread(target=feeder, args=(
            stop, [base_state + i for i in range(n)]), daemon=True)
        th.start()
        time.sleep(0.3)   # let states arrive

        tick_j, ctrl, jnp = build_tick(
            n, "cpu" if args.backend == "cpu" else "device")

        lat = []
        t_sim = 0.015
        for k in range(args.ticks):
            t0 = time.perf_counter()
            got, rows, live = fleet.gather()
            ctrl, cmd_parts = tick_j(ctrl, jnp.asarray(rows),
                                     jnp.asarray(t_sim))
            parts = [np.asarray(p) for p in cmd_parts]   # device fetch
            fleet.send(np.concatenate(parts, axis=1))
            lat.append(time.perf_counter() - t0)
            t_sim += 0.002
            for s in sinks:   # drain
                try:
                    while True:
                        s.recv(4096)
                except BlockingIOError:
                    pass
        stop.set()
        th.join(timeout=1.0)
        fleet.close()
        for s in sinks:
            s.close()

        lat_ms = np.asarray(lat) * 1e3
        results[f"fleet_{n}"] = {
            "ticks": args.ticks,
            "mean_ms": round(float(lat_ms.mean()), 3),
            "p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
            "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
            "max_ms": round(float(lat_ms.max()), 3),
            "within_2ms_tick_budget": bool(
                np.percentile(lat_ms, 50) < 2.0),
            "within_15ms_cadence_budget": bool(
                np.percentile(lat_ms, 99) < 15.0),
        }

    out = {
        "backend": args.backend,
        "note": ("every tick includes the full MPC solve (worst case; "
                 "14/15 production ticks skip it); device backend adds "
                 "the GPU's dispatch and fetch per tick"),
        **results,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
