"""End-to-end loopback test of the native UDP bridge + loop timer.

Drives the real compiled C++ runtime: a Python UDP socket plays the robot
MCU (sending state packets, receiving command packets) while the bridge's
receiver thread and seqlock snapshot run natively.
"""

import socket
import time

import numpy as np
import pytest

from quadruped_jax.runtime import RobotBridge, LoopTimer, native_available

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native bridge not built")

STATE_FLOATS = 51


def make_state_packet(tick, q_fill=0.5):
    vals = np.zeros(STATE_FLOATS, np.float32)
    vals[0] = tick
    vals[1] = 1.0  # quat w
    vals[11:23] = q_fill
    vals[47:51] = 30.0
    return vals.tobytes()


def test_state_roundtrip_and_command_clip():
    robot_state_port = 39011   # bridge listens here
    robot_cmd_port = 39012     # fake MCU listens here

    mcu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mcu.bind(("127.0.0.1", robot_cmd_port))
    mcu.settimeout(2.0)

    bridge = RobotBridge(recv_port=robot_state_port, send_ip="127.0.0.1",
                         send_port=robot_cmd_port, torque_limit=23.0)
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(5):
            tx.sendto(make_state_packet(i + 1, q_fill=0.1 * (i + 1)),
                      ("127.0.0.1", robot_state_port))
            time.sleep(0.01)

        deadline = time.time() + 2.0
        n = 0
        while time.time() < deadline:
            n, state = bridge.get_state()
            if n >= 5:
                break
            time.sleep(0.01)
        assert n >= 5, "receiver thread did not deliver packets"
        np.testing.assert_allclose(state["tick"], 5.0)
        np.testing.assert_allclose(state["q"], 0.5, atol=1e-6)
        np.testing.assert_allclose(state["foot_force"], 30.0)

        # Command path: oversized torque must be clipped by the native
        # safety guard before hitting the wire.
        ok = bridge.send_command(
            q=np.ones(12) * 0.3, kp=np.full(12, 100.0), dq=np.zeros(12),
            kd=np.full(12, 2.0), tau=np.full(12, 99.0))
        assert ok
        data, _ = mcu.recvfrom(4096)
        cmd = np.frombuffer(data, np.float32)
        assert cmd.shape == (60,)
        np.testing.assert_allclose(cmd[0:12], 0.3, atol=1e-6)
        np.testing.assert_allclose(cmd[48:60], 23.0)  # clipped
    finally:
        bridge.close()
        mcu.close()


def test_loop_timer_rate_and_jitter():
    timer = LoopTimer(frequency_hz=1000.0)
    try:
        t0 = time.perf_counter()
        n = 200
        for _ in range(n):
            timer.wait()
        elapsed = time.perf_counter() - t0
        # 200 ticks at 1 kHz = 0.2 s (generous bounds for CI noise).
        assert 0.15 < elapsed < 0.5
        assert timer.mean_jitter_us < 2000.0
    finally:
        timer.close()


def test_fleet_gather_and_fanout():
    from quadruped_jax.runtime import FleetBridge

    n = 3
    base_state, base_cmd = 39021, 39031
    mcus = []
    for i in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", base_cmd + i))
        s.settimeout(2.0)
        mcus.append(s)

    fleet = FleetBridge(n, base_recv_port=base_state,
                        base_send_port=base_cmd, torque_limit=23.0)
    try:
        assert fleet.n == n
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(n):
            tx.sendto(make_state_packet(i + 1, q_fill=0.1 * (i + 1)),
                      ("127.0.0.1", base_state + i))

        deadline = time.time() + 2.0
        live = 0
        while time.time() < deadline:
            live, states, mask = fleet.gather()
            if live >= n:
                break
            time.sleep(0.01)
        assert live == n, "not all fleet receivers delivered"
        assert states.shape == (n, STATE_FLOATS)
        np.testing.assert_allclose(mask, 1.0)  # every robot flagged live
        np.testing.assert_allclose(states[:, 0], [1.0, 2.0, 3.0])
        np.testing.assert_allclose(states[1, 11:23], 0.2, atol=1e-6)

        # One batched send fans out to each robot, clipped per robot.
        cmds = np.zeros((n, 60), np.float32)
        for i in range(n):
            cmds[i, 0:12] = 0.1 * (i + 1)
            cmds[i, 48:60] = 50.0 + i
        assert fleet.send(cmds) == n
        for i in range(n):
            data, _ = mcus[i].recvfrom(4096)
            got = np.frombuffer(data, np.float32)
            np.testing.assert_allclose(got[0:12], 0.1 * (i + 1), atol=1e-6)
            np.testing.assert_allclose(got[48:60], 23.0)  # clipped
    finally:
        fleet.close()
        for s in mcus:
            s.close()
