// Golden-parity oracle: drives the REFERENCE MPC kernel (compiled in place
// from /root/reference — qr_mpc_interface.cpp + vendored qpOASES) on a test
// case read from a file, printing the full force solution. The Python test
// (tests/test_golden_parity.py) compares quadruped_jax's batched
// ZOH+condensation+ADMM pipeline against this oracle's
// expm+condensation+qpOASES output.
//
// Input file: whitespace-separated floats in this order:
//   horizon dt mu fmax mass inertia_diag[3] weights[12] alpha
//   p[3] v[3] quat[4 wxyz] w[3] rpy[3] rfeet[12 leg-major xyz]
//   traj[12*horizon] gait[4*horizon]
// Output: 12*horizon floats (one per line).

#include <cstdio>
#include <fstream>
#include <vector>

#include "controllers/mpc/qr_mpc_interface.h"

using namespace Quadruped;

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <case-file>\n", argv[0]);
    return 1;
  }
  std::ifstream in(argv[1]);
  if (!in) return 2;

  double horizon_d, dt, mu, fmax, mass;
  in >> horizon_d >> dt >> mu >> fmax >> mass;
  int horizon = (int)horizon_d;
  float inertia[3];
  for (auto& v : inertia) in >> v;
  float weights[12];
  for (auto& v : weights) in >> v;
  float alpha;
  in >> alpha;

  Vec3<float> p, v, w, rpy;
  Quat<float> quat;
  Eigen::Matrix<float, 3, 4> rfeet;
  for (int i = 0; i < 3; ++i) in >> p[i];
  for (int i = 0; i < 3; ++i) in >> v[i];
  for (int i = 0; i < 4; ++i) in >> quat[i];
  for (int i = 0; i < 3; ++i) in >> w[i];
  for (int i = 0; i < 3; ++i) in >> rpy[i];
  for (int leg = 0; leg < 4; ++leg)
    for (int i = 0; i < 3; ++i) in >> rfeet(i, leg);

  std::vector<float> traj(12 * horizon), gait(4 * horizon);
  for (auto& t : traj) in >> t;
  for (auto& g : gait) in >> g;

  SetupProblem(dt, horizon, mu, fmax, mass, inertia, weights, alpha);
  SolveMPCKernel(p, v, quat, w, rfeet, rpy, traj.data(), gait.data());

  for (int i = 0; i < 12 * horizon; ++i)
    std::printf("%.9g\n", GetMPCSolution(i));
  return 0;
}
