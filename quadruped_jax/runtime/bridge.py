"""ctypes bindings for the native host runtime (native/robot_bridge.cpp).

The GPU runs the batched controller; this bridge is the host-side seam to a
real robot — the role the vendor SDKs play in the reference
(quadruped/extern/unitree_legged_sdk, deeprobotics_legged_sdk): a UDP
low-level state/command protocol with a receive thread, a torque safety
clip, and a low-jitter loop timer. Hardware-in-the-loop mode feeds one
scenario of the batch from the bridge instead of the simulator.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO_PATH = _NATIVE_DIR / "libqtpu_bridge.so"

STATE_FLOATS = 51
COMMAND_FLOATS = 60

_lib = None


def build_native(force: bool = False) -> bool:
    """Compile the native runtime with g++ (no external deps) when the
    library is missing or older than its source (or `force`), so a
    library left over from other source is never loaded."""
    src = _NATIVE_DIR / "robot_bridge.cpp"
    if (not force and _SO_PATH.exists()
            and _SO_PATH.stat().st_mtime >= src.stat().st_mtime):
        return True
    # Build to a private name, then rename: concurrent loaders never see
    # a half-written library.
    tmp = _SO_PATH.with_name(f"{_SO_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(src), "-lpthread"],
            check=True, capture_output=True)
        os.replace(tmp, _SO_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        raise RuntimeError("native bridge unavailable (g++ build failed)")
    lib = ctypes.CDLL(str(_SO_PATH))
    lib.qtpu_bridge_create.restype = ctypes.c_void_p
    lib.qtpu_bridge_create.argtypes = [ctypes.c_uint16, ctypes.c_char_p,
                                       ctypes.c_uint16, ctypes.c_float]
    lib.qtpu_bridge_create_wire.restype = ctypes.c_void_p
    lib.qtpu_bridge_create_wire.argtypes = [
        ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_float,
        ctypes.c_int]
    lib.qtpu_bridge_destroy.argtypes = [ctypes.c_void_p]
    lib.qtpu_bridge_get_state.restype = ctypes.c_uint64
    lib.qtpu_bridge_get_state.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_float)]
    lib.qtpu_bridge_send_command.restype = ctypes.c_int
    lib.qtpu_bridge_send_command.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_float)]
    lib.qtpu_bridge_send_simple.restype = ctypes.c_int
    lib.qtpu_bridge_send_simple.argtypes = [ctypes.c_void_p,
                                            ctypes.c_uint32, ctypes.c_uint32]
    lib.qtpu_fleet_create.restype = ctypes.c_void_p
    lib.qtpu_fleet_create.argtypes = [ctypes.c_int, ctypes.c_uint16,
                                      ctypes.c_char_p, ctypes.c_uint16,
                                      ctypes.c_float]
    lib.qtpu_fleet_create_wire.restype = ctypes.c_void_p
    lib.qtpu_fleet_create_wire.argtypes = [
        ctypes.c_int, ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16,
        ctypes.c_float, ctypes.c_int]
    lib.qtpu_fleet_destroy.argtypes = [ctypes.c_void_p]
    lib.qtpu_fleet_size.restype = ctypes.c_int
    lib.qtpu_fleet_size.argtypes = [ctypes.c_void_p]
    lib.qtpu_fleet_gather.restype = ctypes.c_int
    lib.qtpu_fleet_gather.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float)]
    lib.qtpu_fleet_gather_masked.restype = ctypes.c_int
    lib.qtpu_fleet_gather_masked.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.qtpu_fleet_send.restype = ctypes.c_int
    lib.qtpu_fleet_send.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float)]
    lib.qtpu_timer_create.restype = ctypes.c_void_p
    lib.qtpu_timer_create.argtypes = [ctypes.c_double]
    lib.qtpu_timer_destroy.argtypes = [ctypes.c_void_p]
    lib.qtpu_timer_wait.restype = ctypes.c_double
    lib.qtpu_timer_wait.argtypes = [ctypes.c_void_p]
    lib.qtpu_timer_max_jitter_us.restype = ctypes.c_double
    lib.qtpu_timer_max_jitter_us.argtypes = [ctypes.c_void_p]
    lib.qtpu_timer_mean_jitter_us.restype = ctypes.c_double
    lib.qtpu_timer_mean_jitter_us.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


WIRE_MODES = {"native": 0, "unitree": 1, "deeprobotics": 2}

# DeepRobotics single-value control codes (send_to_robot.h:33-34,
# control_get / robot_state_init): take/release low-level control and the
# boot-time state init handshake around the joint-command stream.
DR_CMD_TAKE_CONTROL = 0x0114
DR_CMD_RELEASE_CONTROL = 0x0113
DR_CMD_STATE_INIT = 0x31010C05


class RobotBridge:
    """UDP robot I/O with a wait-free latest-state snapshot.

    wire_mode="native" speaks the engine's 51/60-float protocol (the
    loopback sim / custom-MCU path); "unitree" speaks the real Unitree
    low-level LowState/LowCmd UDP protocol (891/730-byte packed packets
    with the vendor CRC) so an A1/Go1/Aliengo is driven directly with no
    vendor SDK in the loop; "deeprobotics" speaks the DeepRobotics
    EthCommand protocol (252-byte RobotCmd / 348-byte RobotState packets,
    robot_types.h:135-197) so a Lite2/Lite3 is driven directly the same
    way. Vendor-order leg swaps happen inside the codec — the engine
    always sees FR,FL,RR,RL."""

    def __init__(self, recv_port: int, send_ip: str = "127.0.0.1",
                 send_port: int = 8008, torque_limit: float = 23.0,
                 wire_mode: str = "native"):
        lib = _load()
        self._lib = lib
        self._handle = lib.qtpu_bridge_create_wire(
            recv_port, send_ip.encode(), send_port,
            ctypes.c_float(torque_limit), WIRE_MODES[wire_mode])
        if not self._handle:
            raise RuntimeError(f"failed to bind UDP port {recv_port}")
        self._state_buf = (ctypes.c_float * STATE_FLOATS)()

    def get_state(self):
        """Returns (packet_count, dict of state arrays)."""
        n = self._lib.qtpu_bridge_get_state(self._handle, self._state_buf)
        raw = np.frombuffer(self._state_buf, dtype=np.float32).copy()
        state = {
            "tick": raw[0],
            "quat": raw[1:5],
            "gyro": raw[5:8],
            "acc": raw[8:11],
            "q": raw[11:23],
            "dq": raw[23:35],
            "tau": raw[35:47],
            "foot_force": raw[47:51],
        }
        return int(n), state

    def send_command(self, q, kp, dq, kd, tau) -> bool:
        cmd = np.concatenate([np.asarray(x, np.float32).reshape(12)
                              for x in (q, kp, dq, kd, tau)])
        buf = (ctypes.c_float * COMMAND_FLOATS)(*cmd)
        return self._lib.qtpu_bridge_send_command(self._handle, buf) == 0

    def send_simple(self, code: int, value: int = 0) -> bool:
        """DeepRobotics control handshake (wire_mode='deeprobotics' only):
        a 12-byte single-value EthCommand, e.g. DR_CMD_TAKE_CONTROL before
        streaming joint commands, DR_CMD_RELEASE_CONTROL after."""
        return self._lib.qtpu_bridge_send_simple(self._handle, code,
                                                 value) == 0

    def close(self):
        if self._handle:
            self._lib.qtpu_bridge_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FleetBridge:
    """N-robot UDP multiplexer: hardware-in-the-loop at fleet scale.

    Robots sit on consecutive ports (recv base_recv_port+i, commands to
    base_send_port+i). The hot loop is TWO C calls per control tick
    regardless of fleet size: `gather()` fills one contiguous [n, 51]
    state batch (the layout the batched control step consumes) and
    `send(commands)` fans a [n, 60] command batch out, torque-clipped per
    robot (the reference Safety guard, per robot). `wire_mode` selects
    the per-robot UDP codec like RobotBridge: "native", "unitree"
    (LowState/LowCmd) or "deeprobotics" (EthCommand) — a homogeneous
    fleet of real vendor robots with no SDK in the loop.
    """

    def __init__(self, n: int, base_recv_port: int,
                 send_ip: str = "127.0.0.1", base_send_port: int = 8100,
                 torque_limit: float = 23.0, wire_mode: str = "native"):
        lib = _load()
        self._lib = lib
        self._n = n
        self._handle = lib.qtpu_fleet_create_wire(
            n, base_recv_port, send_ip.encode(), base_send_port,
            ctypes.c_float(torque_limit), WIRE_MODES[wire_mode])
        if not self._handle:
            raise RuntimeError(
                f"failed to bind {n} UDP ports from {base_recv_port}")
        self._state_buf = (ctypes.c_float * (n * STATE_FLOATS))()
        self._live_buf = (ctypes.c_uint8 * n)()

    @property
    def n(self) -> int:
        return self._n

    def gather(self):
        """Returns (robots_with_data, states [n, 51] float32, live [n]).

        `live[i]` is 1.0 only if robot i has delivered at least one state
        packet; rows with live == 0 are all-zero filler (invalid quat!)
        and must be masked out before feeding the batched controller —
        the scalar count cannot say WHICH robots are dead."""
        count = self._lib.qtpu_fleet_gather_masked(
            self._handle, self._state_buf, self._live_buf)
        states = np.frombuffer(self._state_buf, dtype=np.float32) \
            .reshape(self._n, STATE_FLOATS).copy()
        live = np.frombuffer(self._live_buf,
                             dtype=np.uint8).astype(np.float32).copy()
        return int(count), states, live

    def send(self, commands) -> int:
        """commands: [n, 60] (q, kp, dq, kd, tau blocks of 12).
        Returns how many robot sends succeeded."""
        cmd = np.ascontiguousarray(commands, np.float32) \
            .reshape(self._n * COMMAND_FLOATS)
        # Zero-copy pointer pass (a per-element ctypes unpack of 60 n
        # floats per tick would dominate the two-C-calls hot loop at
        # fleet scale); `cmd` stays referenced for the call's duration.
        ptr = cmd.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return self._lib.qtpu_fleet_send(self._handle, ptr)

    def close(self):
        if self._handle:
            self._lib.qtpu_fleet_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LoopTimer:
    """Absolute-deadline periodic timer (clock_nanosleep TIMER_ABSTIME)."""

    def __init__(self, frequency_hz: float):
        lib = _load()
        self._lib = lib
        self._handle = lib.qtpu_timer_create(frequency_hz)

    def wait(self) -> float:
        """Sleep to the next deadline; returns lateness in microseconds."""
        return self._lib.qtpu_timer_wait(self._handle)

    @property
    def max_jitter_us(self) -> float:
        return self._lib.qtpu_timer_max_jitter_us(self._handle)

    @property
    def mean_jitter_us(self) -> float:
        return self._lib.qtpu_timer_mean_jitter_us(self._handle)

    def close(self):
        if self._handle:
            self._lib.qtpu_timer_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
