// Host-side real-robot I/O runtime for quadruped_jax.
//
// Replaces the reference's vendor SDK boundary (unitree_legged_sdk
// RobotInterface: UDP(LOWLEVEL) + Safety guard + internal receive thread,
// reference: quadruped/extern/unitree_legged_sdk/include/unitree_legged_sdk/
// unitree_interface.h:14-36, and the DeepRobotics receive-thread SDK) with a
// dependency-free C++ runtime the GPU control process drives through ctypes:
//
//   * a UDP receiver thread parses low-level state packets into a
//     seqlock-protected latest-state snapshot (wait-free reads from the
//     1 kHz control loop — no locks on the hot path);
//   * a command sender serializes 12x{q, Kp, dq, Kd, tau} hybrid commands,
//     applying the torque safety clip (the reference Safety guard);
//   * an absolute-deadline loop timer (clock_nanosleep TIMER_ABSTIME) with
//     jitter accounting runs the host side of the control loop at
//     500-1000 Hz.
//
// Native wire format (little-endian float32):
//   state packet  : [tick(1), quat(4), gyro(3), acc(3), q(12), dq(12),
//                    tau(12), foot_force(4)]                    = 51 floats
//   command packet: [q(12), kp(12), dq(12), kd(12), tau(12)]    = 60 floats
// Wire modes 1 and 2 speak the real vendor UDP payloads instead: Unitree
// LowState/LowCmd (A1/Go1/Aliengo) and the DeepRobotics EthCommand
// protocol (Lite2/Lite3) — see the codec sections below.
//
// Build: g++ -O2 -shared -fPIC -o libqtpu_bridge.so robot_bridge.cpp -lpthread

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

namespace {

constexpr int kStateFloats = 51;
constexpr int kCommandFloats = 60;

// Unitree low-level wire format (the ACTUAL vendor UDP payloads, layout
// from the public packed-struct spec in the SDK header comm.h — LowState
// 891 bytes, LowCmd 730 bytes, little-endian, 20 motor slots of which the
// first 12 are the leg joints in FR,FL,RR,RL x {abad,hip,knee} order).
// Implemented as explicit byte-offset codecs (no struct mirroring): no
// #pragma pack compiler variance, and the encode/decode maps straight
// onto the engine's 51/60-float layouts.
constexpr int kUnitreeLowStateBytes = 891;
constexpr int kUnitreeLowCmdBytes = 730;
constexpr uint8_t kUnitreeLowLevel = 0xff;
constexpr uint8_t kUnitreeServoMode = 0x0a;

enum WireMode { kWireNative = 0, kWireUnitree = 1, kWireDeepRobotics = 2 };

// Unitree's CRC: bitwise CRC-32 (poly 0x04c11db7, init 0xFFFFFFFF, no
// reflection/final xor) over the packet as 32-bit words, excluding the
// trailing word that holds the CRC itself — the de-facto checksum every
// open-source Unitree bridge implements.
uint32_t UnitreeCrc32(const uint8_t* bytes, int n_words) {
  uint32_t crc = 0xFFFFFFFFu;
  const uint32_t poly = 0x04c11db7u;
  for (int i = 0; i < n_words; ++i) {
    uint32_t data;
    std::memcpy(&data, bytes + 4 * i, 4);
    uint32_t xbit = 1u << 31;
    for (int b = 0; b < 32; ++b) {
      if (crc & 0x80000000u) {
        crc <<= 1;
        crc ^= poly;
      } else {
        crc <<= 1;
      }
      if (data & xbit) crc ^= poly;
      xbit >>= 1;
    }
  }
  return crc;
}

inline float ReadF32(const uint8_t* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}

inline void WriteF32(uint8_t* p, float v) { std::memcpy(p, &v, 4); }

// LowState byte offsets (header 10B; IMU 53B; 20 x 38B motor states;
// 2 x 4 x i16 foot forces; tick u32; 40B remote; reserve; crc).
constexpr int kLsImu = 10;
constexpr int kLsMotors = 63;
constexpr int kLsMotorStride = 38;
constexpr int kLsFootForce = 823;
constexpr int kLsTick = 839;

// Decode a LowState packet into the engine's 51-float snapshot layout
// [tick, quat(4), gyro(3), acc(3), q(12), dq(12), tau(12), force(4)].
// Returns false on size/CRC mismatch.
bool DecodeUnitreeLowState(const uint8_t* p, ssize_t n, float* out) {
  if (n != kUnitreeLowStateBytes) return false;
  uint32_t crc;
  std::memcpy(&crc, p + kUnitreeLowStateBytes - 4, 4);
  if (crc != UnitreeCrc32(p, (kUnitreeLowStateBytes >> 2) - 1)) return false;

  uint32_t tick;
  std::memcpy(&tick, p + kLsTick, 4);
  out[0] = (float)tick * 1e-6f;  // us -> s
  for (int i = 0; i < 4; ++i) out[1 + i] = ReadF32(p + kLsImu + 4 * i);
  for (int i = 0; i < 3; ++i) out[5 + i] = ReadF32(p + kLsImu + 16 + 4 * i);
  for (int i = 0; i < 3; ++i) out[8 + i] = ReadF32(p + kLsImu + 28 + 4 * i);
  for (int j = 0; j < 12; ++j) {
    const uint8_t* m = p + kLsMotors + kLsMotorStride * j;
    out[11 + j] = ReadF32(m + 1);        // q
    out[23 + j] = ReadF32(m + 5);        // dq
    out[35 + j] = ReadF32(m + 13);       // tauEst
  }
  for (int i = 0; i < 4; ++i) {
    int16_t f;
    std::memcpy(&f, p + kLsFootForce + 2 * i, 2);
    out[47 + i] = (float)f;
  }
  return true;
}

// LowCmd byte offsets (header 10B; 20 x 33B motor cmds; 4 x 3B led; 40B
// remote; reserve; crc).
constexpr int kLcMotors = 10;
constexpr int kLcMotorStride = 33;

// Encode the engine's 60-float hybrid command
// [q(12), kp(12), dq(12), kd(12), tau(12)] as a LowCmd packet.
void EncodeUnitreeLowCmd(const float* cmd, uint8_t* p) {
  std::memset(p, 0, kUnitreeLowCmdBytes);
  p[0] = kUnitreeLowLevel;
  for (int j = 0; j < 12; ++j) {
    uint8_t* m = p + kLcMotors + kLcMotorStride * j;
    m[0] = kUnitreeServoMode;
    WriteF32(m + 1, cmd[j]);             // q
    WriteF32(m + 5, cmd[24 + j]);        // dq
    WriteF32(m + 9, cmd[48 + j]);        // tau
    WriteF32(m + 13, cmd[12 + j]);       // Kp
    WriteF32(m + 17, cmd[36 + j]);       // Kd
  }
  // Unused motor slots 12..19: PosStopF/VelStopF idle commands.
  for (int j = 12; j < 20; ++j) {
    uint8_t* m = p + kLcMotors + kLcMotorStride * j;
    m[0] = kUnitreeServoMode;
    WriteF32(m + 1, 2.146e9f);           // PosStopF
    WriteF32(m + 5, 16000.0f);           // VelStopF
  }
  uint32_t crc = UnitreeCrc32(p, (kUnitreeLowCmdBytes >> 2) - 1);
  std::memcpy(p + kUnitreeLowCmdBytes - 4, &crc, 4);
}

// ---- DeepRobotics (Lite2/Lite3) Ethernet command protocol ------------------
//
// Byte layout re-derived from the public packed-struct spec
// (quadruped/extern/deeprobotics_legged_sdk/include/robot_types.h:135-197,
// command.h:22-50, parse_cmd.h:30-33, send_to_robot.h:30-34) and verified
// against a compiled sizeof/offsetof probe of those headers; implemented —
// like the Unitree codec above — as explicit byte-offset constants, no
// struct mirroring. Every packet is a 12-byte EthCommand header
// {code u32, value_or_size u32, word2 = type(8 bits) | count(24 bits)}
// followed by an optional payload:
//
//   command (-> robot :43893): code 0x0111, size 240, payload = 12 x
//     JointCmd {pos, vel, tor, kp, kd} f32  (252 bytes total);
//   state (<- robot :43897):   code 0x0906, size 336, payload = RobotState
//     {tick u32 @0; ImuData @4 (timestamp i32, angle_{r,p,y} DEGREES f32,
//      angular_velocity_{r,p,y} f32, acc_{x,y,z} f32); 12 x MotorData
//      {pos, vel, tor, temperature} f32 @44; 4-byte pad @236; foot torque
//      f64 fl/fr/hl/hr[3] @240}  (348 bytes total).
//
// Joint order on the wire is FL,FR,HL,HR x {abad,hip,knee}; the engine
// (like the reference controller, qr_robot_lite2.cpp:216 "motorId_ =
// (motorId/3)%2==0 ? motorId+3 : motorId-3") uses FR,FL,RR,RL, so the
// codec swaps leg pairs both ways. Per-robot joint direction/offset
// calibration stays in robot params (it is robot-specific, not protocol).
constexpr int kDrHeaderBytes = 12;
constexpr int kDrRobotCmdBytes = 240;
constexpr int kDrRobotStateBytes = 336;
constexpr int kDrCmdPacketBytes = kDrHeaderBytes + kDrRobotCmdBytes;
constexpr int kDrStatePacketBytes = kDrHeaderBytes + kDrRobotStateBytes;
constexpr uint32_t kDrCodeRobotCmd = 0x0111;
constexpr uint32_t kDrCodeRobotState = 0x0906;
constexpr uint32_t kDrTypeMessValues = 1;  // command_type::kMessValues
// RobotState payload offsets (compiled-probe verified).
constexpr int kDrStTick = 0;
constexpr int kDrStImu = 4;
constexpr int kDrStMotors = 44;
constexpr int kDrStMotorStride = 16;
constexpr int kDrStFootTor = 240;
constexpr int kDrCmdJointStride = 20;

// Engine leg j (FR,FL,RR,RL) <-> wire leg (FL,FR,HL,HR): swap pairs.
inline int DrJointSwap(int j) { return ((j / 3) % 2 == 0) ? j + 3 : j - 3; }

bool DecodeDeepRoboticsState(const uint8_t* p, ssize_t n, float* out) {
  if (n != kDrStatePacketBytes) return false;
  uint32_t code, size, word2;
  std::memcpy(&code, p, 4);
  std::memcpy(&size, p + 4, 4);
  std::memcpy(&word2, p + 8, 4);
  if (code != kDrCodeRobotState || size != (uint32_t)kDrRobotStateBytes ||
      (word2 & 0xffu) != kDrTypeMessValues) {
    return false;
  }
  const uint8_t* s = p + kDrHeaderBytes;
  uint32_t tick;
  std::memcpy(&tick, s + kDrStTick, 4);
  out[0] = (float)tick * 1e-3f;  // ms -> s
  // IMU: angles arrive in degrees (the reference converts with /57.3,
  // qr_robot_lite2.cpp:176-178; we use the exact factor), rates in rad/s,
  // accels in m/s^2. The engine snapshot stores a wxyz quaternion.
  const float kDeg2Rad = 0.017453292519943295f;
  float roll = ReadF32(s + kDrStImu + 4) * kDeg2Rad;
  float pitch = ReadF32(s + kDrStImu + 8) * kDeg2Rad;
  float yaw = ReadF32(s + kDrStImu + 12) * kDeg2Rad;
  float cr = std::cos(0.5f * roll), sr = std::sin(0.5f * roll);
  float cp = std::cos(0.5f * pitch), sp = std::sin(0.5f * pitch);
  float cy = std::cos(0.5f * yaw), sy = std::sin(0.5f * yaw);
  out[1] = cr * cp * cy + sr * sp * sy;  // w
  out[2] = sr * cp * cy - cr * sp * sy;  // x
  out[3] = cr * sp * cy + sr * cp * sy;  // y
  out[4] = cr * cp * sy - sr * sp * cy;  // z
  for (int i = 0; i < 3; ++i) out[5 + i] = ReadF32(s + kDrStImu + 16 + 4 * i);
  for (int i = 0; i < 3; ++i) out[8 + i] = ReadF32(s + kDrStImu + 28 + 4 * i);
  for (int j = 0; j < 12; ++j) {
    const uint8_t* m = s + kDrStMotors + kDrStMotorStride * DrJointSwap(j);
    out[11 + j] = ReadF32(m);            // pos
    out[23 + j] = ReadF32(m + 4);        // vel
    out[35 + j] = ReadF32(m + 8);        // tor
  }
  // Foot vertical torque-sensor channel [2] per leg, engine order
  // FR,FL,RR,RL = wire blocks fr,fl,hr,hl (qr_robot_lite2.cpp:232).
  const int foot_block[4] = {1, 0, 3, 2};
  for (int i = 0; i < 4; ++i) {
    double f;
    std::memcpy(&f, s + kDrStFootTor + 8 * (3 * foot_block[i] + 2), 8);
    out[47 + i] = (float)f;
  }
  return true;
}

void EncodeDeepRoboticsCmd(const float* cmd, uint8_t* p, uint32_t count) {
  std::memset(p, 0, kDrCmdPacketBytes);
  uint32_t code = kDrCodeRobotCmd;
  uint32_t size = kDrRobotCmdBytes;
  uint32_t word2 = kDrTypeMessValues | (count << 8);  // type | 24-bit seq
  std::memcpy(p, &code, 4);
  std::memcpy(p + 4, &size, 4);
  std::memcpy(p + 8, &word2, 4);
  for (int j = 0; j < 12; ++j) {
    uint8_t* m = p + kDrHeaderBytes + kDrCmdJointStride * DrJointSwap(j);
    WriteF32(m, cmd[j]);                 // pos
    WriteF32(m + 4, cmd[24 + j]);        // vel
    WriteF32(m + 8, cmd[48 + j]);        // tor
    WriteF32(m + 12, cmd[12 + j]);       // kp
    WriteF32(m + 16, cmd[36 + j]);       // kd
  }
}

struct StateSnapshot {
  float data[kStateFloats];
};

struct Bridge {
  int recv_fd = -1;
  int send_fd = -1;
  sockaddr_in send_addr{};
  std::thread receiver;
  std::atomic<bool> running{false};
  int wire_mode = kWireNative;

  // Seqlock: writer bumps seq to odd before writing, even after.
  std::atomic<uint64_t> seq{0};
  StateSnapshot snap{};
  std::atomic<uint64_t> packets{0};
  float torque_limit = 23.0f;  // reference Safety clip (qr_safety_checker)
  // DeepRobotics 24-bit command sequence counter (single sender thread).
  uint32_t dr_cmd_count = 0;
};

void ReceiverLoop(Bridge* b) {
  uint8_t raw[2048];
  float buf[kStateFloats];
  while (b->running.load(std::memory_order_relaxed)) {
    ssize_t n = recv(b->recv_fd, raw, sizeof(raw), 0);
    bool ok = false;
    if (b->wire_mode == kWireUnitree) {
      ok = DecodeUnitreeLowState(raw, n, buf);
    } else if (b->wire_mode == kWireDeepRobotics) {
      ok = DecodeDeepRoboticsState(raw, n, buf);
    } else if (n == (ssize_t)(kStateFloats * sizeof(float))) {
      std::memcpy(buf, raw, kStateFloats * sizeof(float));
      ok = true;
    }
    if (ok) {
      uint64_t s = b->seq.load(std::memory_order_relaxed);
      b->seq.store(s + 1, std::memory_order_release);  // odd: writing
      std::memcpy(b->snap.data, buf, sizeof(buf));
      b->seq.store(s + 2, std::memory_order_release);  // even: stable
      b->packets.fetch_add(1, std::memory_order_relaxed);
    }
  }
}

}  // namespace

extern "C" {

static void* BridgeCreate(uint16_t recv_port, const char* send_ip,
                          uint16_t send_port, float torque_limit,
                          int wire_mode) {
  Bridge* b = new Bridge();
  b->torque_limit = torque_limit;
  b->wire_mode = wire_mode;

  b->recv_fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (b->recv_fd < 0) { delete b; return nullptr; }
  timeval tv{0, 100000};  // 100 ms receive timeout so the thread can exit
  setsockopt(b->recv_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(recv_port);
  if (bind(b->recv_fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(b->recv_fd);
    delete b;
    return nullptr;
  }

  b->send_fd = socket(AF_INET, SOCK_DGRAM, 0);
  b->send_addr.sin_family = AF_INET;
  b->send_addr.sin_port = htons(send_port);
  inet_pton(AF_INET, send_ip, &b->send_addr.sin_addr);

  b->running.store(true);
  b->receiver = std::thread(ReceiverLoop, b);
  return b;
}

void* qtpu_bridge_create(uint16_t recv_port, const char* send_ip,
                         uint16_t send_port, float torque_limit) {
  return BridgeCreate(recv_port, send_ip, send_port, torque_limit,
                      kWireNative);
}

void qtpu_bridge_destroy(void* handle) {
  Bridge* b = (Bridge*)handle;
  if (!b) return;
  b->running.store(false);
  if (b->receiver.joinable()) b->receiver.join();
  if (b->recv_fd >= 0) close(b->recv_fd);
  if (b->send_fd >= 0) close(b->send_fd);
  delete b;
}

// Returns the number of state packets received so far; fills out[51].
uint64_t qtpu_bridge_get_state(void* handle, float* out) {
  Bridge* b = (Bridge*)handle;
  uint64_t s0, s1;
  do {
    s0 = b->seq.load(std::memory_order_acquire);
    std::memcpy(out, b->snap.data, sizeof(b->snap.data));
    s1 = b->seq.load(std::memory_order_acquire);
  } while (s0 != s1 || (s0 & 1));  // retry across concurrent writes
  return b->packets.load(std::memory_order_relaxed);
}

// Sends one 60-float hybrid command, clipping feed-forward torques. In
// Unitree wire mode the command goes out as a real LowCmd packet.
int qtpu_bridge_send_command(void* handle, const float* cmd) {
  Bridge* b = (Bridge*)handle;
  float safe[kCommandFloats];
  std::memcpy(safe, cmd, sizeof(safe));
  // Sanitize EVERY field, not just torques: with the vendor SDK's
  // safety layer out of the loop (the point of the wire modes), a NaN
  // joint target or runaway gain would otherwise reach the motor
  // controllers CRC-valid. Bounds: q within +/-pi (A1 motor range is
  // tighter), kp/kd to sane stiffness ranges, dq to motor speed.
  auto clamp = [](float v, float lo, float hi) {
    if (!std::isfinite(v)) return 0.0f;
    return v < lo ? lo : (v > hi ? hi : v);
  };
  for (int i = 0; i < 12; ++i) safe[i] = clamp(safe[i], -3.2f, 3.2f);
  for (int i = 12; i < 24; ++i) safe[i] = clamp(safe[i], 0.0f, 300.0f);
  for (int i = 24; i < 36; ++i) safe[i] = clamp(safe[i], -30.0f, 30.0f);
  for (int i = 36; i < 48; ++i) safe[i] = clamp(safe[i], 0.0f, 40.0f);
  for (int i = 48; i < 60; ++i)
    safe[i] = clamp(safe[i], -b->torque_limit, b->torque_limit);
  ssize_t n;
  if (b->wire_mode == kWireUnitree) {
    uint8_t pkt[kUnitreeLowCmdBytes];
    EncodeUnitreeLowCmd(safe, pkt);
    n = sendto(b->send_fd, pkt, sizeof(pkt), 0, (sockaddr*)&b->send_addr,
               sizeof(b->send_addr));
    return n == (ssize_t)sizeof(pkt) ? 0 : -1;
  }
  if (b->wire_mode == kWireDeepRobotics) {
    uint8_t pkt[kDrCmdPacketBytes];
    EncodeDeepRoboticsCmd(safe, pkt, b->dr_cmd_count);
    b->dr_cmd_count = (b->dr_cmd_count + 1) & 0xffffffu;
    n = sendto(b->send_fd, pkt, sizeof(pkt), 0, (sockaddr*)&b->send_addr,
               sizeof(b->send_addr));
    return n == (ssize_t)sizeof(pkt) ? 0 : -1;
  }
  n = sendto(b->send_fd, safe, sizeof(safe), 0, (sockaddr*)&b->send_addr,
             sizeof(b->send_addr));
  return n == (ssize_t)sizeof(safe) ? 0 : -1;
}

// Create a bridge speaking a specific wire format: 0 = the native
// 51/60-float protocol, 1 = the Unitree low-level LowState/LowCmd UDP
// protocol (drive a real A1/Go1/Aliengo directly, no vendor SDK), 2 = the
// DeepRobotics EthCommand protocol (drive a real Lite2/Lite3 directly).
void* qtpu_bridge_create_wire(uint16_t recv_port, const char* send_ip,
                              uint16_t send_port, float torque_limit,
                              int wire_mode) {
  return BridgeCreate(recv_port, send_ip, send_port, torque_limit,
                      wire_mode);
}

// DeepRobotics single-value control command (12-byte EthCommand, no
// payload): the enable/disable/state-init handshake the vendor SDK sends
// around the joint-command stream (send_to_robot.h:33-34 control_get —
// 0x0114 take control, 0x0113 release, 0x31010C05 robot_state_init).
// Only meaningful on a wire_mode=2 bridge; returns 0 on success.
int qtpu_bridge_send_simple(void* handle, uint32_t code, uint32_t value) {
  Bridge* b = (Bridge*)handle;
  if (b->wire_mode != kWireDeepRobotics) return -2;
  uint8_t pkt[kDrHeaderBytes];
  uint32_t word2 = 0 | (b->dr_cmd_count << 8);  // type kSingleValue
  b->dr_cmd_count = (b->dr_cmd_count + 1) & 0xffffffu;
  std::memcpy(pkt, &code, 4);
  std::memcpy(pkt + 4, &value, 4);
  std::memcpy(pkt + 8, &word2, 4);
  ssize_t n = sendto(b->send_fd, pkt, sizeof(pkt), 0,
                     (sockaddr*)&b->send_addr, sizeof(b->send_addr));
  return n == (ssize_t)sizeof(pkt) ? 0 : -1;
}

// ---- fleet multiplexer -----------------------------------------------------
//
// Hardware-in-the-loop at fleet scale: N robots on consecutive UDP ports,
// one receive thread per robot, and ONE C call per control tick to gather
// all latest-state snapshots into a contiguous [n, 51] batch buffer (the
// layout the batched control step consumes directly) and one to fan a
// [n, 60] command batch back out. This keeps the Python hot loop at two
// ctypes calls per tick regardless of fleet size.

struct Fleet {
  std::vector<Bridge*> robots;
};

// Fleet speaking a specific wire format on every robot (0 = native,
// 1 = Unitree, 2 = DeepRobotics — same codes as qtpu_bridge_create_wire).
void* qtpu_fleet_create_wire(int n, uint16_t base_recv_port,
                             const char* send_ip, uint16_t base_send_port,
                             float torque_limit, int wire_mode) {
  if (n <= 0) return nullptr;
  Fleet* f = new Fleet();
  for (int i = 0; i < n; ++i) {
    void* b = BridgeCreate((uint16_t)(base_recv_port + i), send_ip,
                           (uint16_t)(base_send_port + i), torque_limit,
                           wire_mode);
    if (!b) {
      for (Bridge* r : f->robots) qtpu_bridge_destroy(r);
      delete f;
      return nullptr;
    }
    f->robots.push_back((Bridge*)b);
  }
  return f;
}

void* qtpu_fleet_create(int n, uint16_t base_recv_port, const char* send_ip,
                        uint16_t base_send_port, float torque_limit) {
  return qtpu_fleet_create_wire(n, base_recv_port, send_ip, base_send_port,
                                torque_limit, kWireNative);
}

void qtpu_fleet_destroy(void* handle) {
  Fleet* f = (Fleet*)handle;
  if (!f) return;
  for (Bridge* r : f->robots) qtpu_bridge_destroy(r);
  delete f;
}

int qtpu_fleet_size(void* handle) {
  return (int)((Fleet*)handle)->robots.size();
}

// Fills out[n*51] with every robot's latest snapshot; returns how many
// robots have received at least one state packet.
int qtpu_fleet_gather(void* handle, float* out) {
  Fleet* f = (Fleet*)handle;
  int live = 0;
  for (size_t i = 0; i < f->robots.size(); ++i) {
    if (qtpu_bridge_get_state(f->robots[i], out + i * kStateFloats) > 0) {
      ++live;
    }
  }
  return live;
}

// Like qtpu_fleet_gather, but also writes a per-robot liveness flag into
// live[n] (1 = at least one state packet received, 0 = the row in `out`
// is all-zero filler — including an invalid quat — and must be masked by
// the caller). The count alone cannot say WHICH robots are dead.
int qtpu_fleet_gather_masked(void* handle, float* out, uint8_t* live) {
  Fleet* f = (Fleet*)handle;
  int count = 0;
  for (size_t i = 0; i < f->robots.size(); ++i) {
    int ok = qtpu_bridge_get_state(f->robots[i], out + i * kStateFloats);
    live[i] = ok > 0 ? 1 : 0;
    count += live[i];
  }
  return count;
}

// Sends cmds[n*60] (one hybrid command per robot, torque-clipped per
// robot); returns how many sends succeeded.
int qtpu_fleet_send(void* handle, const float* cmds) {
  Fleet* f = (Fleet*)handle;
  int sent = 0;
  for (size_t i = 0; i < f->robots.size(); ++i) {
    if (qtpu_bridge_send_command(f->robots[i],
                                 cmds + i * kCommandFloats) == 0) {
      ++sent;
    }
  }
  return sent;
}

// ---- absolute-deadline loop timer -----------------------------------------

struct LoopTimer {
  timespec next{};
  long period_ns = 1000000;
  double max_jitter_us = 0;
  double sum_jitter_us = 0;
  uint64_t ticks = 0;
};

void* qtpu_timer_create(double frequency_hz) {
  LoopTimer* t = new LoopTimer();
  t->period_ns = (long)(1e9 / frequency_hz);
  clock_gettime(CLOCK_MONOTONIC, &t->next);
  return t;
}

void qtpu_timer_destroy(void* handle) { delete (LoopTimer*)handle; }

// Sleeps until the next absolute deadline; returns lateness in microseconds.
double qtpu_timer_wait(void* handle) {
  LoopTimer* t = (LoopTimer*)handle;
  t->next.tv_nsec += t->period_ns;
  while (t->next.tv_nsec >= 1000000000L) {
    t->next.tv_nsec -= 1000000000L;
    t->next.tv_sec += 1;
  }
  clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &t->next, nullptr);
  timespec now{};
  clock_gettime(CLOCK_MONOTONIC, &now);
  double late_us = (now.tv_sec - t->next.tv_sec) * 1e6 +
                   (now.tv_nsec - t->next.tv_nsec) * 1e-3;
  if (late_us > t->max_jitter_us) t->max_jitter_us = late_us;
  t->sum_jitter_us += late_us > 0 ? late_us : 0;
  t->ticks++;
  return late_us;
}

double qtpu_timer_max_jitter_us(void* handle) {
  return ((LoopTimer*)handle)->max_jitter_us;
}

double qtpu_timer_mean_jitter_us(void* handle) {
  LoopTimer* t = (LoopTimer*)handle;
  return t->ticks ? t->sum_jitter_us / t->ticks : 0.0;
}

}  // extern "C"
