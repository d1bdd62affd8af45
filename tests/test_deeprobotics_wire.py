"""DeepRobotics EthCommand wire protocol (native/robot_bridge.cpp wire
mode 2) — the Lite2/Lite3 real-robot path.

The bridge speaks the REAL vendor UDP payloads — 348-byte RobotState and
252-byte RobotCmd EthCommand packets — replacing the DeepRobotics SDK the
reference links (deeprobotics_legged_sdk: parse_cmd receive thread +
send_to_robot, robot_types.h:135-197 packed layouts). These tests build
byte-exact RobotState packets in Python (independent encoder: struct.pack
at the spec offsets, nothing shared with the C++ codec), feed them through
a loopback socket, and decode the RobotCmd the bridge emits — both
directions checked against the packed-struct layout, malformed packets
dropped, and the single-value control handshake verified.
"""

import math
import socket
import struct
import time

import numpy as np
import pytest

from quadruped_jax.runtime.bridge import (DR_CMD_RELEASE_CONTROL,
                                          DR_CMD_TAKE_CONTROL, RobotBridge,
                                          native_available)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native bridge unavailable")

STATE_PACKET_BYTES = 348   # 12B EthCommand header + 336B RobotState
CMD_PACKET_BYTES = 252     # 12B header + 240B RobotCmd
CODE_ROBOT_STATE = 0x0906
CODE_ROBOT_CMD = 0x0111


def _free_udp_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_robot_state(tick_ms=2500, count=7, rpy_deg=(2.0, -3.0, 10.0)):
    """Byte-exact RobotState packet. Wire joint order is FL,FR,HL,HR
    (robot_types.h RobotData); values encode the WIRE index so the test
    can verify the engine-side FR,FL,RR,RL swap explicitly."""
    payload = bytearray(336)
    struct.pack_into("<I", payload, 0, tick_ms)
    # ImuData @4: timestamp i32, angles (deg), angular rates, accels.
    struct.pack_into("<i", payload, 4, 999)
    struct.pack_into("<3f", payload, 8, *rpy_deg)
    struct.pack_into("<3f", payload, 20, 0.01, 0.02, 0.03)
    struct.pack_into("<3f", payload, 32, 0.1, 0.2, 9.81)
    # 12 x MotorData {pos, vel, tor, temperature} @44.
    for wj in range(12):
        struct.pack_into("<4f", payload, 44 + 16 * wj,
                         1.0 + 0.01 * wj, 2.0 + 0.01 * wj,
                         3.0 + 0.1 * wj, 35.0)
    # Foot torque doubles @240: fl_tor[3], fr_tor[3], hl_tor[3], hr_tor[3].
    for block, base in enumerate((240, 264, 288, 312)):
        struct.pack_into("<3d", payload, base,
                         0.5 * block, 0.6 * block, 10.0 + block)
    header = struct.pack("<III", CODE_ROBOT_STATE, len(payload),
                         1 | (count << 8))
    return header + bytes(payload)


def rpy_to_quat_np(rpy):
    r, p, y = [0.5 * a for a in rpy]
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p),
                              math.sin(p), math.cos(y), math.sin(y))
    return np.asarray([cr * cp * cy + sr * sp * sy,
                       sr * cp * cy - cr * sp * sy,
                       cr * sp * cy + sr * cp * sy,
                       cr * cp * sy - sr * sp * cy])


def test_robotstate_decode_and_robotcmd_encode():
    state_port = _free_udp_port()
    mcu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mcu.bind(("127.0.0.1", 0))
    cmd_port = mcu.getsockname()[1]
    mcu.settimeout(2.0)
    bridge = RobotBridge(recv_port=state_port, send_port=cmd_port,
                         torque_limit=23.0, wire_mode="deeprobotics")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pkt = make_robot_state()
        assert len(pkt) == STATE_PACKET_BYTES

        deadline = time.time() + 2.0
        n = 0
        while time.time() < deadline:
            tx.sendto(pkt, ("127.0.0.1", state_port))
            n, state = bridge.get_state()
            if n > 0:
                break
            time.sleep(0.02)
        assert n > 0, "no RobotState decoded"

        # tick ms -> s; degree angles -> the engine's wxyz quaternion.
        np.testing.assert_allclose(state["tick"], 2.5, rtol=1e-6)
        rpy = np.deg2rad([2.0, -3.0, 10.0])
        np.testing.assert_allclose(state["quat"], rpy_to_quat_np(rpy),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state["gyro"], [0.01, 0.02, 0.03],
                                   rtol=1e-6)
        np.testing.assert_allclose(state["acc"], [0.1, 0.2, 9.81],
                                   rtol=1e-6)
        # Leg swap: engine joint j maps to wire joint (j/3 even ? j+3 : j-3)
        # — FR<->FL and RR<->HL pair swaps (qr_robot_lite2.cpp:216).
        wire_of_engine = np.asarray(
            [j + 3 if (j // 3) % 2 == 0 else j - 3 for j in range(12)])
        np.testing.assert_allclose(state["q"], 1.0 + 0.01 * wire_of_engine,
                                   rtol=1e-5)
        np.testing.assert_allclose(state["dq"], 2.0 + 0.01 * wire_of_engine,
                                   rtol=1e-5)
        np.testing.assert_allclose(state["tau"], 3.0 + 0.1 * wire_of_engine,
                                   rtol=1e-5)
        # Foot force channel [2] per leg, engine FR,FL,RR,RL = wire blocks
        # fr(1), fl(0), hr(3), hl(2).
        np.testing.assert_allclose(state["foot_force"],
                                   [11.0, 10.0, 13.0, 12.0])

        # Command path: RobotCmd packet with header, sequence counter,
        # leg swap, and the torque safety clip.
        q = 0.1 * np.arange(12)
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.full(12, 50.0))
        data, _ = mcu.recvfrom(4096)
        assert len(data) == CMD_PACKET_BYTES
        code, size, word2 = struct.unpack_from("<III", data, 0)
        assert code == CODE_ROBOT_CMD
        assert size == 240
        assert word2 & 0xFF == 1          # kMessValues
        first_count = word2 >> 8
        for ej in range(12):
            wj = int(wire_of_engine[ej])
            pos, vel, tor, kp, kd = struct.unpack_from(
                "<5f", data, 12 + 20 * wj)
            np.testing.assert_allclose(pos, q[ej], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(vel, 0.0)
            np.testing.assert_allclose(tor, 23.0)   # clipped from 50
            np.testing.assert_allclose(kp, 60.0)
            np.testing.assert_allclose(kd, 5.0)
        # The 24-bit sequence counter advances per packet.
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.zeros(12))
        data2, _ = mcu.recvfrom(4096)
        assert (struct.unpack_from("<I", data2, 8)[0] >> 8) \
            == (first_count + 1) & 0xFFFFFF

        # Control handshake: 12-byte single-value EthCommand.
        assert bridge.send_simple(DR_CMD_TAKE_CONTROL)
        hs, _ = mcu.recvfrom(4096)
        assert len(hs) == 12
        code, value, word2 = struct.unpack("<III", hs)
        assert code == DR_CMD_TAKE_CONTROL
        assert value == 0
        assert word2 & 0xFF == 0          # kSingleValue
        assert bridge.send_simple(DR_CMD_RELEASE_CONTROL)
        hs2, _ = mcu.recvfrom(4096)
        assert struct.unpack("<III", hs2)[0] == DR_CMD_RELEASE_CONTROL
    finally:
        bridge.close()
        mcu.close()


def test_deeprobotics_fleet():
    """A 2-robot DeepRobotics fleet: gather decodes vendor RobotState
    packets per robot; send fans out vendor RobotCmd packets per robot."""
    from quadruped_jax.runtime.bridge import FleetBridge

    base_state = _free_udp_port()
    mcus = []
    for i in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.settimeout(2.0)
        mcus.append(s)
    # Command ports must be consecutive: re-bind until we get a pair.
    for s in mcus:
        s.close()
    base_cmd = _free_udp_port()
    mcus = []
    for i in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.bind(("127.0.0.1", base_cmd + i))
        except OSError:
            for q in mcus:
                q.close()
            import pytest as _pytest
            _pytest.skip("consecutive UDP ports unavailable")
        s.settimeout(2.0)
        mcus.append(s)

    fleet = FleetBridge(2, base_recv_port=base_state,
                        base_send_port=base_cmd,
                        wire_mode="deeprobotics")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        deadline = time.time() + 2.0
        count = 0
        while time.time() < deadline:
            for i in range(2):
                tx.sendto(make_robot_state(tick_ms=1000 + i),
                          ("127.0.0.1", base_state + i))
            count, states, live = fleet.gather()
            if count == 2:
                break
            time.sleep(0.02)
        assert count == 2 and (live == 1.0).all()
        np.testing.assert_allclose(states[0, 0], 1.000, rtol=1e-6)
        np.testing.assert_allclose(states[1, 0], 1.001, rtol=1e-6)

        cmds = np.zeros((2, 60), np.float32)
        cmds[:, :12] = 0.2
        assert fleet.send(cmds) == 2
        for s in mcus:
            data, _ = s.recvfrom(4096)
            assert len(data) == CMD_PACKET_BYTES
            assert struct.unpack_from("<I", data, 0)[0] == CODE_ROBOT_CMD
    finally:
        fleet.close()
        for s in mcus:
            s.close()


def test_malformed_robotstate_dropped():
    state_port = _free_udp_port()
    bridge = RobotBridge(recv_port=state_port,
                         send_port=_free_udp_port(),
                         wire_mode="deeprobotics")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        good = make_robot_state()
        # Wrong code, wrong declared size, wrong type, truncation: all
        # must be dropped (no CRC in this protocol — header validation is
        # the integrity check).
        bad_code = struct.pack("<I", 0x0907) + good[4:]
        bad_size = good[:4] + struct.pack("<I", 100) + good[8:]
        bad_type = good[:8] + struct.pack("<I", 0 | (7 << 8)) + good[12:]
        for p in (bad_code, bad_size, bad_type, good[:100]):
            for _ in range(3):
                tx.sendto(p, ("127.0.0.1", state_port))
        time.sleep(0.2)
        n, _ = bridge.get_state()
        assert n == 0, "malformed packets must be dropped"
    finally:
        bridge.close()
