"""Hardware-in-the-loop skeleton: native UDP bridge + 1 kHz host loop.

The real-robot entry point (reference: examples/example_a1_real). The GPU
side jits one control tick; the host side runs the absolute-deadline timer,
pulls the latest state snapshot from the native bridge, feeds it through the
controller, and sends the hybrid command back over UDP.

Run against a real robot MCU (or the loopback MCU emulator in
tests/test_native_bridge.py) by pointing --robot-ip at it.

    python examples/example_hardware_bridge.py --dry-run
"""

import argparse
import time

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp
import numpy as np

from quadruped_jax.robots import a1_params
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.control import mpc, swing
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.types import RobotObservation
from quadruped_jax.core import se3
from quadruped_jax.runtime import RobotBridge, LoopTimer, native_available


def build_controller(params):
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=40,
                          iterations_per_mpc=30),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT())

    @jax.jit
    def tick(ctrl_state, obs, cmd, t):
        return locomotion_step(config, params, ctrl_state, obs, cmd, t)

    return config, tick


def obs_from_bridge_state(params, s):
    quat = jnp.asarray(s["quat"])
    r = se3.quat_to_rotmat(quat)
    omega = jnp.asarray(s["gyro"])
    return RobotObservation(
        base_position=jnp.asarray([0.0, 0.0, 0.27]),  # from estimator in HIL
        base_rpy=se3.quat_to_rpy(quat), base_quat=quat,
        base_vel_world=jnp.zeros(3), base_omega_world=r @ omega,
        base_omega_body=omega,
        joint_angles=jnp.asarray(s["q"]),
        joint_velocities=jnp.asarray(s["dq"]),
        foot_contact=(jnp.asarray(s["foot_force"]) > 5.0).astype(jnp.float32),
        foot_forces=jnp.asarray(s["foot_force"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot-ip", default="127.0.0.1")
    ap.add_argument("--wire", default="native",
                    choices=["native", "unitree", "deeprobotics"],
                    help="UDP wire format: the engine protocol, the real "
                         "Unitree LowState/LowCmd packets (A1/Go1/"
                         "Aliengo), or the real DeepRobotics EthCommand "
                         "packets (Lite2/Lite3)")
    ap.add_argument("--state-port", type=int, default=8007)
    ap.add_argument("--cmd-port", type=int, default=8008)
    ap.add_argument("--hz", type=float, default=500.0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dry-run", action="store_true",
                    help="compile + one tick on synthetic state, no UDP")
    args = ap.parse_args()

    params = a1_params()
    config, tick = build_controller(params)

    if args.dry_run:
        from quadruped_jax.sim import srb_sim

        sim = srb_sim.srb_sim_init(params)
        obs = srb_sim.observe(params, sim, jnp.ones(4))
        ctrl = locomotion_init(config, params, obs)
        cmd = TwistCommand.constant(vx=0.2)
        out = tick(ctrl, obs, cmd, jnp.asarray(0.002))
        jax.block_until_ready(out[0].tau)
        print("dry run OK; tau[0:6] =", np.asarray(out[0].tau[:6]).round(2))
        return

    if not native_available():
        raise SystemExit("native bridge not built (g++ required)")
    bridge = RobotBridge(recv_port=args.state_port, send_ip=args.robot_ip,
                        send_port=args.cmd_port,
                        torque_limit=float(params.torque_limit),
                        wire_mode=args.wire)
    timer = LoopTimer(args.hz)
    cmd = TwistCommand.constant(vx=0.0)

    if args.wire == "deeprobotics":
        # Take low-level control before streaming joint commands (the
        # vendor handshake, send_to_robot.h control_get ABLE). Losing the
        # >5 ms command cadence releases control on the robot side.
        from quadruped_jax.runtime.bridge import DR_CMD_TAKE_CONTROL
        bridge.send_simple(DR_CMD_TAKE_CONTROL)

    n, s = bridge.get_state()
    obs = obs_from_bridge_state(params, s)
    ctrl = locomotion_init(config, params, obs)
    t = 0.0
    dt = 1.0 / args.hz
    ticks = int(args.seconds * args.hz)
    for i in range(ticks):
        timer.wait()
        _, s = bridge.get_state()
        obs = obs_from_bridge_state(params, s)
        command, _, ctrl = tick(ctrl, obs, cmd, jnp.asarray(t))
        bridge.send_command(np.asarray(command.q), np.asarray(command.kp),
                            np.asarray(command.dq), np.asarray(command.kd),
                            np.asarray(command.tau))
        t += dt
    print(f"ran {ticks} ticks; timer jitter mean "
          f"{timer.mean_jitter_us:.1f}us max {timer.max_jitter_us:.1f}us")
    if args.wire == "deeprobotics":
        # Vendor-faithful soft handoff (send_to_robot.h control_get(UNABLE)):
        # stream a damping-only command (kp=0, kd~5, zero targets) for ~2 s
        # so the robot settles under joint damping, THEN release low-level
        # control — an immediate 0x0113 release hands the joints back
        # abruptly on a real Lite2/Lite3.
        from quadruped_jax.runtime.bridge import DR_CMD_RELEASE_CONTROL
        zeros = np.zeros(12, np.float32)
        kd_damp = np.full(12, 5.0, np.float32)
        for _ in range(int(2.0 * args.hz)):
            timer.wait()
            bridge.send_command(zeros, zeros, zeros, kd_damp, zeros)
        bridge.send_simple(DR_CMD_RELEASE_CONTROL)
    bridge.close()


if __name__ == "__main__":
    main()
