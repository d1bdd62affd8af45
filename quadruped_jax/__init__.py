"""quadruped_jax — a batched quadruped locomotion engine in JAX.

A from-scratch JAX/XLA re-design of the capability set of
TopHillRobotics/quadruped-robot (convex MPC over contact forces, WBC task
hierarchy, gait scheduling, Raibert swing trajectories, state estimation,
batched rollout simulation). Where the reference runs one robot in one C++
control loop at 1 kHz, this engine batches thousands of scenario rollouts per
GPU and scales over device meshes with XLA collectives.

Layout (see SURVEY.md §7):
  core/        pytree types, SE3 math, splines, filters, config schema
  robots/      robot parameter sets (A1/Go1/Aliengo/Lite2/Lite3), analytic leg kinematics
  dynamics/    13-state SRB model, spatial algebra, batched floating-base dynamics
  solvers/     batched dense QP (ADMM), MPC condensation, cone QP
  gait/        phase-clock gait scheduler, walk sub-states
  control/     swing/stance controllers, MPC driver, WBC, locomotion merge, FSM
  estimation/  EKFs, pose/velocity/ground/contact estimators
  sim/         pure-array batched simulator (SRB + whole-body), motor law, terrain
  distributed/ mesh setup, shard_map harness, scaling report
"""

__version__ = "0.1.0"

import jax as _jax

# True f32 matmuls by default. On a GPU the DEFAULT f32 dot may run as one
# TF32 tensor-core pass (10-bit mantissa, ~1e-3 relative error) —
# unacceptable as a silent default for a control stack whose reference
# solves QPs in f64 (SURVEY.md §7.3 "float precision"). Hot paths that can
# tolerate less opt in EXPLICITLY: bf16 operands + f32 accumulation (see
# solvers/cone_qp.py newton_schulz_inverse / bf16_iters), which this default
# does not slow, or an explicit precision (cone_qp.POLISH_PRECISION).
_jax.config.update("jax_default_matmul_precision", "float32")
