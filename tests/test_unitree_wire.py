"""Unitree low-level wire protocol (native/robot_bridge.cpp wire mode 1).

The bridge speaks the REAL vendor UDP payloads — LowState (891 B) and
LowCmd (730 B) packed packets with Unitree's CRC-32 — replacing the
binary SDK the reference links (unitree_legged_sdk RobotInterface,
unitree_interface.h:14-36). These tests build byte-exact LowState
packets in Python (independent encoder: struct.pack at the spec offsets
+ an independent CRC implementation), feed them through a loopback
socket, and decode the LowCmd the bridge emits — both directions checked
against the packed-struct layout, CRC verified, corrupted packets
dropped.
"""

import socket
import struct
import time


def _free_udp_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port

import numpy as np
import pytest

from quadruped_jax.runtime.bridge import (RobotBridge, STATE_FLOATS,
                                          native_available)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native bridge unavailable")

LOWSTATE_BYTES = 891
LOWCMD_BYTES = 730


def crc32_unitree(data: bytes) -> int:
    """Unitree CRC-32 (poly 0x04c11db7, init 0xFFFFFFFF, word-wise, no
    reflection) over all 32-bit words except the trailing CRC word."""
    n_words = (len(data) >> 2) - 1
    crc = 0xFFFFFFFF
    poly = 0x04C11DB7
    for i in range(n_words):
        (word,) = struct.unpack_from("<I", data, 4 * i)
        xbit = 1 << 31
        for _ in range(32):
            if crc & 0x80000000:
                crc = ((crc << 1) ^ poly) & 0xFFFFFFFF
            else:
                crc = (crc << 1) & 0xFFFFFFFF
            if word & xbit:
                crc ^= poly
            xbit >>= 1
    return crc


def make_lowstate(tick_us=123456, q0=0.3):
    """Byte-exact LowState: header(10) + IMU(53) + 20x38 motors +
    foot forces + tick + remote + reserve + crc."""
    buf = bytearray(LOWSTATE_BYTES)
    buf[0] = 0xFF                                     # levelFlag LOWLEVEL
    # IMU at offset 10: quat(4f), gyro(3f), acc(3f), rpy(3f), temp(i8)
    struct.pack_into("<4f", buf, 10, 1.0, 0.0, 0.0, 0.0)
    struct.pack_into("<3f", buf, 26, 0.01, 0.02, 0.03)
    struct.pack_into("<3f", buf, 38, 0.1, 0.2, 9.81)
    # 20 motor states at 63, stride 38: mode u8, q, dq, ddq, tauEst,
    # q_raw, dq_raw, ddq_raw, temp i8, reserve u32[2]
    for j in range(20):
        off = 63 + 38 * j
        buf[off] = 0x0A
        struct.pack_into("<f", buf, off + 1, q0 + 0.01 * j)   # q
        struct.pack_into("<f", buf, off + 5, 0.5 + 0.01 * j)  # dq
        struct.pack_into("<f", buf, off + 13, 2.0 + 0.1 * j)  # tauEst
    struct.pack_into("<4h", buf, 823, 10, 20, 30, 40)         # footForce
    struct.pack_into("<I", buf, 839, tick_us)                 # tick
    struct.pack_into("<I", buf, LOWSTATE_BYTES - 4,
                     crc32_unitree(bytes(buf)))
    return bytes(buf)


def test_lowstate_decode_and_lowcmd_encode():
    state_port, cmd_port = _free_udp_port(), 0
    mcu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mcu.bind(("127.0.0.1", 0))
    cmd_port = mcu.getsockname()[1]
    mcu.settimeout(2.0)
    bridge = RobotBridge(recv_port=state_port, send_port=cmd_port,
                         torque_limit=23.0, wire_mode="unitree")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pkt = make_lowstate()
        assert len(pkt) == LOWSTATE_BYTES

        deadline = time.time() + 2.0
        n = 0
        while time.time() < deadline:
            tx.sendto(pkt, ("127.0.0.1", state_port))
            n, state = bridge.get_state()
            if n > 0:
                break
            time.sleep(0.02)
        assert n > 0, "no LowState decoded"

        # Decoded into the engine's state layout.
        np.testing.assert_allclose(state["tick"], 0.123456, rtol=1e-5)
        np.testing.assert_allclose(state["quat"], [1, 0, 0, 0])
        np.testing.assert_allclose(state["gyro"], [0.01, 0.02, 0.03],
                                   rtol=1e-6)
        np.testing.assert_allclose(state["acc"], [0.1, 0.2, 9.81],
                                   rtol=1e-6)
        np.testing.assert_allclose(
            state["q"], 0.3 + 0.01 * np.arange(12), rtol=1e-5)
        np.testing.assert_allclose(
            state["dq"], 0.5 + 0.01 * np.arange(12), rtol=1e-5)
        np.testing.assert_allclose(
            state["tau"], 2.0 + 0.1 * np.arange(12), rtol=1e-5)
        np.testing.assert_allclose(state["foot_force"], [10, 20, 30, 40])

        # Command path: LowCmd bytes with vendor CRC and torque clip.
        q = 0.1 * np.arange(12)
        tau = np.full(12, 50.0)    # above the 23 N*m clip
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), tau)
        data, _ = mcu.recvfrom(4096)
        assert len(data) == LOWCMD_BYTES
        assert data[0] == 0xFF                        # LOWLEVEL
        (crc,) = struct.unpack_from("<I", data, LOWCMD_BYTES - 4)
        assert crc == crc32_unitree(data)
        for j in range(12):
            off = 10 + 33 * j
            assert data[off] == 0x0A                  # servo mode
            qj, dqj, tauj, kpj, kdj = struct.unpack_from("<5f", data,
                                                         off + 1)
            np.testing.assert_allclose(qj, q[j], rtol=1e-6)
            np.testing.assert_allclose(kpj, 60.0)
            np.testing.assert_allclose(kdj, 5.0)
            np.testing.assert_allclose(tauj, 23.0)    # clipped
        # Idle slots carry the PosStopF/VelStopF sentinels.
        q12, dq12 = struct.unpack_from("<2f", data, 10 + 33 * 12 + 1)
        np.testing.assert_allclose(q12, 2.146e9)
        np.testing.assert_allclose(dq12, 16000.0)
    finally:
        bridge.close()
        mcu.close()


def test_corrupted_lowstate_dropped():
    state_port = _free_udp_port()
    bridge = RobotBridge(recv_port=state_port,
                         send_port=_free_udp_port(),
                         wire_mode="unitree")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        bad = bytearray(make_lowstate())
        bad[100] ^= 0xFF                              # flip a byte
        for _ in range(5):
            tx.sendto(bytes(bad), ("127.0.0.1", state_port))
        tx.sendto(make_lowstate()[:500], ("127.0.0.1", state_port))
        time.sleep(0.2)
        n, _ = bridge.get_state()
        assert n == 0, "corrupted/truncated packets must be dropped"
    finally:
        bridge.close()
