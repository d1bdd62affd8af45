"""Torque/force parity against the REFERENCE MPC kernel.

The oracle (tests/golden/) compiles the reference's own
qr_mpc_interface.cpp + vendored qpOASES in place from /root/reference and
solves the same cases: 25x25 matrix-exponential discretization + dense
condensation + warm-started active-set QP. quadruped_jax solves them with
exact closed-form ZOH + the batched ADMM cone solver. This is the
BASELINE.md "stance forces match reference within tolerance" gate.
"""

import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params, aliengo_params, lite3_params
from quadruped_jax.solvers import condense, cone_qp

HERE = Path(__file__).parent
ORACLE = Path("/tmp/golden_build/mpc_golden")
H = 10
DT = 0.03
MU = 0.45
ALPHA = 4e-6
WEIGHTS = np.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1],
                     np.float32)


def ensure_oracle():
    if ORACLE.exists():
        return True
    ref = Path("/root/reference/quadruped")
    if not ref.exists():
        return False
    r = subprocess.run(["bash", str(HERE / "golden" / "build.sh")],
                       capture_output=True, text=True)
    return r.returncode == 0 and ORACLE.exists()


pytestmark = pytest.mark.skipif(not ensure_oracle(),
                                reason="golden oracle unavailable")


def make_case(seed, robot="a1"):
    rng = np.random.default_rng(seed)
    params = {"a1": a1_params, "aliengo": aliengo_params,
              "lite3": lite3_params}[robot]()
    rpy = rng.normal(size=3) * 0.08
    p = np.asarray([rng.normal() * 0.1, rng.normal() * 0.1,
                    0.27 + rng.normal() * 0.02])
    v = rng.normal(size=3) * 0.3
    w = rng.normal(size=3) * 0.3
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    feet = (rng.normal(size=(4, 3)) * 0.03
            + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]))
    # Rotate feet to world frame (the oracle expects foot->CoM world vecs).
    r_mat = np.asarray(se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32)))
    feet_world = feet @ r_mat.T

    # Desired trajectory: hold pose, track vx.
    traj = np.zeros((H, 12), np.float32)
    traj[:, 0:3] = [0.0, 0.0, rpy[2]]
    traj[:, 3:6] = [p[0], p[1], 0.27]
    traj[:, 9] = 0.4
    for k in range(1, H):
        traj[k, 3] = traj[k - 1, 3] + DT * 0.4

    gait = np.ones((H, 4), np.float32)
    gait[:, 1] = (np.arange(H) % 2).astype(np.float32)  # FL alternates
    return params, rpy, p, v, w, quat, feet_world, traj, gait


def run_oracle(params, rpy, p, v, w, quat, feet_world, traj, gait,
               tmp_path):
    h = gait.shape[0]            # horizon from the case data
    inertia = np.diag(np.asarray(params.total_inertia))
    vals = ([float(h), DT, MU, float(params.max_force),
             float(params.total_mass)]
            + list(inertia) + list(WEIGHTS) + [ALPHA]
            + list(p) + list(v) + list(quat) + list(w) + list(rpy)
            + list(feet_world.reshape(-1))
            + list(traj.reshape(-1)) + list(gait.reshape(-1)))
    case = tmp_path / "case.txt"
    case.write_text("\n".join(f"{x:.9g}" for x in vals))
    out = subprocess.run([str(ORACLE), str(case)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    # The reference prints a SetupProblem banner; the solution is the last
    # 12H lines.
    lines = out.stdout.strip().splitlines()
    sol = np.asarray([float(t) for t in lines[-12 * h:]], np.float32)
    return sol.reshape(h, 4, 3)


def build_prob(params, rpy, p, v, w, quat, feet_world, traj, gait):
    h = gait.shape[0]
    r_mat = se3.quat_to_rotmat(jnp.asarray(quat, jnp.float32))
    a, b = srb.srb_continuous(r_mat, params.total_inertia,
                              params.total_mass,
                              jnp.asarray(feet_world, jnp.float32))
    ad, bd = srb.srb_discretize(a, b, DT)
    x0 = jnp.asarray(np.concatenate([rpy, p, w, v, [srb.GRAVITY]]),
                     jnp.float32)
    x_des = jnp.concatenate([jnp.asarray(traj, jnp.float32),
                             jnp.full((h, 1), srb.GRAVITY)], axis=-1)
    weights13 = jnp.asarray(np.concatenate([WEIGHTS, [0.0]]), jnp.float32)
    pmat, qvec = condense.condense_cost(ad, bd, x0, x_des, weights13,
                                        ALPHA, h)
    fz_hi = jnp.asarray(gait.reshape(h * 4), jnp.float32) * params.max_force
    return cone_qp.ConeQP(p=pmat, q=qvec, mu=jnp.asarray(MU, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


def run_ours(*case):
    h = case[8].shape[0]
    sol = cone_qp.solve(build_prob(*case), iters=600)
    return np.asarray(sol.x).reshape(h, 4, 3)


@pytest.mark.parametrize("seed,robot", [(0, "a1"), (1, "a1"), (2, "a1"),
                                        (4, "aliengo"), (5, "lite3")])
def test_first_step_forces_match_reference(seed, robot, tmp_path):
    case = make_case(seed, robot)
    params = case[0]
    ref = run_oracle(*case, tmp_path)
    ours = run_ours(*case)
    # First-step forces are what the robot applies; tolerance covers
    # active-set-vs-ADMM differences and f32 expm-vs-closed-form ZOH.
    scale = float(params.total_mass) * 9.81
    err = np.abs(ours[0] - ref[0]).max()
    assert err < 0.03 * scale, (
        f"first-step force mismatch {err:.3f} N\nref:\n{ref[0]}\nours:\n{ours[0]}")
    # Whole-horizon agreement at a looser tolerance.
    assert np.abs(ours - ref).max() < 0.08 * scale


def test_torque_parity(tmp_path):
    """Map both force solutions through the same J^T: joint torques agree."""
    from quadruped_jax.robots import kinematics

    case = make_case(3)
    params, rpy = case[0], case[1]
    ref = run_oracle(*case, tmp_path)
    ours = run_ours(*case)
    q = params.stand_angles
    r_mat = se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32))
    to_tau = lambda f: np.asarray(kinematics.map_contact_forces_to_torques(
        params, q, -jnp.einsum("ji,lj->li", r_mat,
                               jnp.asarray(f, jnp.float32))))
    tau_ref = to_tau(ref[0])
    tau_ours = to_tau(ours[0])
    assert np.abs(tau_ours - tau_ref).max() < 1.0  # N*m (clip is +/-23)


# ---------------------------------------------------------------------------
# PRODUCTION-BUDGET parity: the deployed solver configuration (MpcConfig
# defaults: qp_iters=24 Fast-ADMM warm-started at the 15-tick cadence, one
# qp_cold_iters boot solve seeded by gravity_warm_start) against the same
# compiled reference oracle. This welds the bench headline (which times
# exactly this configuration) to the parity claim.
# ---------------------------------------------------------------------------

from quadruped_jax.control.mpc import MpcConfig, gravity_warm_start  # noqa: E402

PROD = MpcConfig()
CADENCE_S = 0.015  # 15 ticks at 1 kHz (UpdateMPC :342)


def solve_production(prob, iters, x0=None, y0=None, inv_carry=None):
    """The deployed WARM per-tick configuration (Fast-ADMM + the
    cross-cadence M^{-1} reuse when a carry is threaded)."""
    return cone_qp.solve(prob, iters=iters, alpha=PROD.qp_alpha,
                         accel_restart=PROD.qp_accel_restart, x0=x0, y0=y0,
                         inv_carry=inv_carry, return_inv_carry=True)


def solve_cold(prob, params, gait):
    """The deployed COLD boot configuration (mpc_cold_start): relaxed
    scheme + gravity-split primal init at qp_cold_iters."""
    x0 = gravity_warm_start(params, jnp.asarray(gait))
    return cone_qp.solve(prob, iters=PROD.qp_cold_iters,
                         alpha=PROD.qp_cold_alpha, accel_restart=0, x0=x0,
                         return_inv_carry=True)


@pytest.mark.parametrize("seed,robot", [(0, "a1"), (1, "a1"), (2, "a1"),
                                        (3, "a1"), (4, "aliengo"),
                                        (5, "lite3")])
def test_production_cold_budget(seed, robot, tmp_path):
    """The boot solve (qp_cold_iters + gravity init, mpc_cold_start) passes
    the same first-step gate as the converged solver on random hard poses —
    cold-start parity at the deployed budget."""
    case = make_case(seed, robot)
    params, gait = case[0], case[8]
    ref = run_oracle(*case, tmp_path)
    prob = build_prob(*case)
    sol, _ = solve_cold(prob, params, gait)
    ours = np.asarray(sol.x).reshape(H, 4, 3)
    scale = float(params.total_mass) * 9.81
    err = np.abs(ours[0] - ref[0]).max()
    assert err < 0.03 * scale, (
        f"cold-budget first-step mismatch {err:.3f} N "
        f"({err / scale * 100:.2f}% m*g)")


def cadence_case_at(t, seed=0):
    """Smoothly varying trot case with contact flips every gait period —
    the problem sequence one closed-loop scenario feeds the solver at the
    15-tick cadence (state advances, feet move +/-2 cm, diagonals swap)."""
    rng = np.random.default_rng(seed)
    params = a1_params()
    amp = rng.uniform(0.5, 1.0, size=4)
    rpy = np.array([0.04 * amp[0] * np.sin(3 * t),
                    0.04 * amp[1] * np.cos(2 * t), 0.15 * t])
    p = np.array([0.4 * t, 0.02 * np.sin(t), 0.27 + 0.01 * np.sin(4 * t)])
    v = np.array([0.4, 0.02 * np.cos(t), 0.04 * np.cos(4 * t)])
    w = np.array([0.1 * amp[2] * np.cos(3 * t),
                  0.1 * amp[3] * np.sin(2 * t), 0.15])
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    feet0 = np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                      [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
    feet = feet0 + 0.02 * np.sin(5 * t + np.arange(12).reshape(4, 3))
    r_mat = np.asarray(se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32)))
    feet_world = feet @ r_mat.T
    traj = np.zeros((H, 12), np.float32)
    traj[:, 0:3] = [0.0, 0.0, rpy[2]]
    traj[:, 3:6] = [p[0], p[1], 0.27]
    traj[:, 9] = 0.4
    for k in range(1, H):
        traj[k, 3] = traj[k - 1, 3] + DT * 0.4
        traj[k, 2] = traj[k - 1, 2] + DT * 0.15
    # Trot contact table: diagonal pairs, phase advancing with t.
    phase = (np.arange(H) * DT / 0.6 + t / 0.6) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    gait = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a],
                    axis=1).astype(np.float32)
    return params, rpy, p, v, w, quat, feet_world, traj, gait


@pytest.mark.parametrize("seed,move_block,use_carry", [
    (0, (), True), (1, (), False),
    (0, (6, 2), False), (1, (6, 2), True)])
def test_production_cadence_parity(seed, move_block, use_carry, tmp_path):
    """THE production schedule vs the oracle: one qp_cold_iters boot solve,
    then qp_iters=24 warm-started solves every 15 ms across trot contact
    flips. Every solve in the sequence must pass the 3% m*g first-step
    gate the converged tests use, and torques through the same J^T stay
    within 1 N*m on the final solve. Also run with the move-blocked
    condensed system (head 6 + tail pairs — the throughput lever,
    solvers/condense.py), which must clear the same gates: this is what
    licenses blocking in the headline bench."""
    from quadruped_jax.robots import kinematics
    from quadruped_jax.solvers import condense as cnd

    if move_block:
        groups, n_g = cnd.move_block_groups(H, *move_block)

    def prep(prob):
        if not move_block:
            return prob
        p_r, q_r, fz_r = cnd.reduce_move_blocking(
            prob.p, prob.q, prob.fz_hi, groups, n_g, H)
        return cone_qp.ConeQP(p=p_r, q=q_r, mu=prob.mu,
                              fz_lo=jnp.zeros_like(fz_r), fz_hi=fz_r)

    x_warm = y_warm = carry = pin_prev = None
    errs = []
    for k in range(10):
        case = cadence_case_at(k * CADENCE_S, seed)
        params = case[0]
        ref = run_oracle(*case, tmp_path)
        prob = prep(build_prob(*case))
        pin_new = (prob.fz_hi < 1e-6).astype(jnp.float32)
        if x_warm is None:
            if move_block:
                grav = gravity_warm_start(
                    params, (prob.fz_hi > 0).astype(jnp.float32)
                    .reshape(n_g, 4))
                sol, carry = cone_qp.solve(prob, iters=PROD.qp_cold_iters,
                                           alpha=PROD.qp_cold_alpha,
                                           x0=grav, return_inv_carry=True)
            else:
                sol, carry = solve_cold(prob, params, case[8])
        else:
            # use_carry toggles the cross-cadence M^{-1} reuse (rescale
            # + pinned-row Woodbury + short NS polish) so BOTH warm
            # configurations are oracle-gated: cold-NS (the default
            # bench/headline path — the reuse is off by default, its
            # speed unproven) and the reuse mechanism itself. The
            # flip-aware warm-start shift is NOT in this chain: it is
            # off by default (measured worst-case/typical trade-off,
            # MpcConfig.qp_warm_shift) and gated separately in
            # tests/test_warm_shift.py.
            sol, carry = solve_production(
                prob, iters=PROD.qp_iters, x0=x_warm, y0=y_warm,
                inv_carry=carry if use_carry else None)
        x_warm, y_warm = sol.x, sol.y
        pin_prev = pin_new
        ours = np.asarray(sol.x[:12]).reshape(1, 4, 3)
        scale = float(params.total_mass) * 9.81
        errs.append(np.abs(ours[0] - ref[0]).max() / scale)
    assert max(errs) < 0.03, [f"{e * 100:.2f}%" for e in errs]

    # Torque parity on the final warm solve.
    rpy = case[1]
    q = params.stand_angles
    r_mat = se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32))
    to_tau = lambda f: np.asarray(kinematics.map_contact_forces_to_torques(
        params, q, -jnp.einsum("ji,lj->li", r_mat,
                               jnp.asarray(f, jnp.float32))))
    assert np.abs(to_tau(ours[0]) - to_tau(ref[0])).max() < 1.0


# ---------------------------------------------------------------------------
# Force-balance stance QP parity (oracle: tests/golden/fb_golden_main.cpp,
# compiling the reference's own qr_qp_torque_optimizer.cpp + QuadProg++).
# ---------------------------------------------------------------------------

FB_ORACLE = Path("/tmp/golden_build/fb_golden")


def make_fb_case(seed, contacts=(1, 1, 1, 1)):
    from quadruped_jax.control import stance_force_balance as fb
    from quadruped_jax.control.desired_state import desired_state_init
    from quadruped_jax.control.types import RobotObservation
    from quadruped_jax.robots import kinematics

    rng = np.random.default_rng(seed)
    params = a1_params()
    rpy = rng.normal(size=3) * 0.06
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    r_mat = se3.quat_to_rotmat(jnp.asarray(quat, jnp.float32))
    q = jnp.asarray(np.tile([0.0, 0.9, -1.8], 4)
                    + rng.normal(size=12) * 0.08, jnp.float32)
    obs = RobotObservation(
        base_position=jnp.asarray([0.0, 0.0, 0.27 + rng.normal() * 0.02],
                                  jnp.float32),
        base_rpy=jnp.asarray(rpy, jnp.float32),
        base_quat=jnp.asarray(quat, jnp.float32),
        base_vel_world=jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32),
        base_omega_world=jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32),
        base_omega_body=jnp.zeros(3, jnp.float32),
        joint_angles=q,
        joint_velocities=jnp.zeros(12, jnp.float32),
        foot_contact=jnp.asarray(contacts, jnp.float32),
        foot_forces=jnp.full((4,), 30.0, jnp.float32))
    des = desired_state_init(body_height=0.28).replace(
        velocity=jnp.asarray([0.3, 0.0, 0.0], jnp.float32))
    config = fb.ForceBalanceConfig()
    a_des = fb.desired_acceleration(config, obs, des)
    feet_base = kinematics.foot_positions_in_base_frame(params, q) \
        - params.com_offset
    return params, config, obs, des, np.asarray(a_des), \
        np.asarray(feet_base), np.asarray(contacts, np.float32)


def run_fb_oracle(params, a_des, quat, feet_base, contacts, tmp_path):
    inertia = np.asarray(params.total_inertia).reshape(-1)
    acc_weight = [1., 1., 1., 10., 10., 1.]
    vals = ([float(params.total_mass)] + list(inertia) + list(quat)
            + list(feet_base.reshape(-1)) + list(a_des) + acc_weight
            + list(contacts) + [0.01] * 4 + [10.0] * 4
            + [float(params.friction_coef)]
            + [0.0, 0.0, 1.0] + [1.0, 0.0, 0.0] + [0.0, 1.0, 0.0])
    case = tmp_path / "fb_case.txt"
    case.write_text("\n".join(f"{x:.9g}" for x in vals))
    out = subprocess.run([str(FB_ORACLE), str(case)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    sol = np.asarray([float(t) for t in out.stdout.split()], np.float32)
    return sol.reshape(4, 3)   # base-frame force per leg (3x4 col-major)


@pytest.mark.parametrize("seed,contacts", [
    (0, (1, 1, 1, 1)), (1, (1, 1, 1, 1)),
    (2, (1, 0, 1, 1)), (3, (0, 1, 1, 0)),
    (4, (1, 1, 1, 1)), (5, (1, 1, 0, 1)),
    (8, (1, 1, 1, 1)), (9, (1, 0, 0, 1)),
])
def test_force_balance_matches_reference(seed, contacts, tmp_path):
    """Our batched-ADMM force-balance QP vs the reference's own builder
    + QuadProg++ active set, on identical inputs. The oracle returns
    RigidTransform(quat, -F_world) = per-leg -R^T F — the exact quantity
    our stance_torques feeds J^T (GetAction :508)."""
    if not FB_ORACLE.exists():
        pytest.skip("fb oracle unavailable")
    from quadruped_jax.control import stance_force_balance as fb

    params, config, obs, des, a_des, feet_base, cvec = \
        make_fb_case(seed, contacts)
    ref = run_fb_oracle(params, a_des, np.asarray(obs.base_quat),
                        feet_base, cvec, tmp_path)

    forces_world = np.asarray(fb.compute_contact_forces(
        config, params, obs, des, jnp.asarray(cvec)))
    r_mat = np.asarray(se3.quat_to_rotmat(obs.base_quat))
    ours = -(forces_world @ r_mat)          # -R^T F, per leg
    scale = float(params.total_mass) * 9.8
    err = np.abs(ours - ref).max()
    # Exact-minimizer parity: the whitened active-set polish
    # (solvers/polish.py) matches the f64 active-set solution to well
    # under 1% of body weight even on clipped-acceleration cases where
    # truncated ADMM alone sat ~30 N away.
    assert err < 0.008 * scale, (err, ref, ours)


# ---------------------------------------------------------------------------
# Long-horizon (H=16) move-blocked configuration: 0.48 s of lookahead at
# H=10-class solve cost. 12*16 = 192 full variables vs 12*(4+4) = 96
# blocked. This is where move blocking pays most (at H=10 it shrinks the
# system only 120 -> 96).
# ---------------------------------------------------------------------------

H_LONG = 16


def make_case_long(seed, robot="a1"):
    """A long-horizon case (same distribution as make_case, H=16 — the
    oracle's K_MAX_GAIT_SEGMENTS limit)."""
    rng = np.random.default_rng(seed)
    params = {"a1": a1_params, "aliengo": aliengo_params,
              "lite3": lite3_params}[robot]()
    rpy = rng.normal(size=3) * 0.08
    p = np.asarray([rng.normal() * 0.1, rng.normal() * 0.1,
                    0.27 + rng.normal() * 0.02])
    v = rng.normal(size=3) * 0.3
    w = rng.normal(size=3) * 0.3
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    feet = (rng.normal(size=(4, 3)) * 0.03
            + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]))
    r_mat = np.asarray(se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32)))
    feet_world = feet @ r_mat.T
    traj = np.zeros((H_LONG, 12), np.float32)
    traj[:, 0:3] = [0.0, 0.0, rpy[2]]
    traj[:, 3:6] = [p[0], p[1], 0.27]
    traj[:, 9] = 0.4
    for k in range(1, H_LONG):
        traj[k, 3] = traj[k - 1, 3] + DT * 0.4
    # Trot table at the long horizon (diagonals swap mid-horizon).
    phase = (np.arange(H_LONG) * DT / 0.6) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    gait = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a], axis=1)
    gait[0] = 1.0
    return params, rpy, p, v, w, quat, feet_world, traj, \
        gait.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_long_horizon_blocked_consistency(seed):
    """H=16 move-blocked (head 6 + pairs -> 132 variables) vs OUR full
    192-variable converged solve: blocking must not move first-step
    forces by more than the 3% m*g gate.

    NOT oracle-gated: at H=16 the reference kernel's own production
    nWSR=100 working-set budget binds (192 vars / 320 rows — our FULL
    converged solution already sits ~6% m*g from its early-terminated
    answer, vs < 3% at the H<=10 sizes the reference ships with), so the
    oracle stops being a trustworthy optimum there. The blocking lever's
    claim at long horizons is internal consistency + the H=10 oracle
    gates above."""
    from quadruped_jax.solvers import condense as cnd

    groups, n_g = cnd.move_block_groups(H_LONG, 6, 2)
    case = make_case_long(seed)
    params = case[0]
    prob = build_prob(*case)
    full = cone_qp.solve(prob, iters=2000)

    p_r, q_r, fz_r = cnd.reduce_move_blocking(
        prob.p, prob.q, prob.fz_hi, groups, n_g, H_LONG)
    red = cone_qp.ConeQP(p=p_r, q=q_r, mu=prob.mu,
                         fz_lo=jnp.zeros_like(fz_r), fz_hi=fz_r)
    conv = cone_qp.solve(red, iters=2000)

    scale = float(params.total_mass) * 9.81
    ref_first = np.asarray(full.x[:12]).reshape(4, 3)
    ours = np.asarray(conv.x[:12]).reshape(4, 3)
    err = np.abs(ours - ref_first).max()
    # 5% gate (not the 3% oracle gate): a tail block that straddles a
    # trot diagonal flip takes the MIN fz over its steps and pins both
    # diagonals for that segment — the approximation costs up to ~4% m*g
    # on first-step forces at H=16 (vs < 0.7% at H=10 where no block
    # straddles a flip). Characterized, not hidden.
    assert err < 0.05 * scale, f"{err / scale * 100:.2f}% m*g"
    # Round-4 diagnosis of why the production FIXED budget did not
    # transfer here: at alpha=4e-6 the H=16 system has near-nullspace
    # force directions (many force schedules give near-identical state
    # cost over 0.48 s) whose position moves first-step forces by up to
    # 8% m*g while ADMM drains them at ~1 bit / 300 iterations — budget-
    # and rho-insensitive (benchmarks/exp_h16_{warm,warm2,alpha}.py).
    # The SHIPPED H=16 configuration (control/mpc.py long_horizon_config)
    # therefore raises the force regularizer to 1e-4, which removes the
    # pathology — gated by the production-cadence and consistency tests
    # below. This test keeps pinning the blocking approximation at the
    # reference's own alpha.


# ---------------------------------------------------------------------------
# H=16 PRODUCTION configuration gates (long_horizon_config: move-blocked,
# force_weight=1e-4). Oracle = OUR converged solve: the reference kernel's
# production nWSR=100 cap binds at 192 vars (see above), so internal
# convergence is the trustworthy optimum at this horizon; the reference-
# oracle chain is anchored at H<=10 by the tests above.
# ---------------------------------------------------------------------------

from quadruped_jax.control.mpc import long_horizon_config  # noqa: E402

H16 = long_horizon_config()
H16_GROUPS, H16_NG = condense.move_block_groups(H_LONG, *H16.move_block)


def cadence_case_long(t, seed=0):
    """H=16 cadence ensemble (same motion model as cadence_case_at, trot
    diagonals flipping across the longer horizon)."""
    rng = np.random.default_rng(seed)
    params = a1_params()
    amp = rng.uniform(0.5, 1.0, size=4)
    rpy = np.array([0.04 * amp[0] * np.sin(3 * t),
                    0.04 * amp[1] * np.cos(2 * t), 0.15 * t])
    p = np.array([0.4 * t, 0.02 * np.sin(t), 0.27 + 0.01 * np.sin(4 * t)])
    v = np.array([0.4, 0.02 * np.cos(t), 0.04 * np.cos(4 * t)])
    w = np.array([0.1 * amp[2] * np.cos(3 * t),
                  0.1 * amp[3] * np.sin(2 * t), 0.15])
    quat = np.asarray(se3.rpy_to_quat(jnp.asarray(rpy, jnp.float32)))
    feet0 = np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                      [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
    feet = feet0 + 0.02 * np.sin(5 * t + np.arange(12).reshape(4, 3))
    r_mat = np.asarray(se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32)))
    feet_world = feet @ r_mat.T
    traj = np.zeros((H_LONG, 12), np.float32)
    traj[:, 0:3] = [0.0, 0.0, rpy[2]]
    traj[:, 3:6] = [p[0], p[1], 0.27]
    traj[:, 9] = 0.4
    for k in range(1, H_LONG):
        traj[k, 3] = traj[k - 1, 3] + DT * 0.4
        traj[k, 2] = traj[k - 1, 2] + DT * 0.15
    phase = (np.arange(H_LONG) * DT / 0.6 + t / 0.6) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    gait = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a],
                    axis=1).astype(np.float32)
    gait[0] = 1.0
    return params, rpy, p, v, w, quat, feet_world, traj, gait


def build_prob_long(case, alpha, blocked=True):
    params, rpy, p, v, w, quat, feet_world, traj, gait = case
    r_mat = se3.quat_to_rotmat(jnp.asarray(quat, jnp.float32))
    a, b = srb.srb_continuous(r_mat, params.total_inertia,
                              params.total_mass,
                              jnp.asarray(feet_world, jnp.float32))
    ad, bd = srb.srb_discretize(a, b, DT)
    x0 = jnp.asarray(np.concatenate([rpy, p, w, v, [srb.GRAVITY]]),
                     jnp.float32)
    x_des = jnp.concatenate([jnp.asarray(traj, jnp.float32),
                             jnp.full((H_LONG, 1), srb.GRAVITY)], axis=-1)
    weights13 = jnp.asarray(np.concatenate([WEIGHTS, [0.0]]), jnp.float32)
    pmat, qvec = condense.condense_cost(ad, bd, x0, x_des, weights13,
                                        alpha, H_LONG)
    fz_hi = jnp.asarray(gait.reshape(H_LONG * 4),
                        jnp.float32) * params.max_force
    if blocked:
        pmat, qvec, fz_hi = condense.reduce_move_blocking(
            pmat, qvec, fz_hi, H16_GROUPS, H16_NG, H_LONG)
    return cone_qp.ConeQP(p=pmat, q=qvec,
                          mu=jnp.asarray(MU, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


@pytest.mark.parametrize("seed", [0, 1])
def test_long_horizon_production_cadence(seed):
    """THE shipped H=16 schedule end to end: one qp_cold_iters relaxed
    boot solve (gravity init), then qp_iters=24 Fast-ADMM warm-started
    solves every 15 ms across trot contact flips, each within 3% m*g of
    a converged (6000-iteration) oracle on the same problem. This is the
    gate that licenses the QTPU_BENCH_H=16 headline variant (measured
    margin: max ~1%)."""
    scale = float(a1_params().total_mass) * 9.81
    x_warm = y_warm = carry = None
    errs = []
    for k in range(10):
        case = cadence_case_long(k * CADENCE_S, seed)
        prob = build_prob_long(case, H16.force_weight)
        oracle = cone_qp.solve(prob, iters=6000)
        if x_warm is None:
            grav = gravity_warm_start(
                case[0], (prob.fz_hi > 0).astype(jnp.float32)
                .reshape(H16_NG, 4))
            sol, carry = cone_qp.solve(prob, iters=H16.qp_cold_iters,
                                       alpha=H16.qp_cold_alpha, x0=grav,
                                       return_inv_carry=True)
        else:
            # seed 0 gates the M^{-1}-reuse mechanism at H=16; seed 1
            # the default cold-NS warm path (see the H=10 cadence test).
            sol, carry = cone_qp.solve(prob, iters=H16.qp_iters,
                                       alpha=H16.qp_alpha,
                                       accel_restart=H16.qp_accel_restart,
                                       x0=x_warm, y0=y_warm,
                                       inv_carry=carry if seed == 0 else None,
                                       return_inv_carry=True)
        x_warm, y_warm = sol.x, sol.y
        errs.append(float(np.abs(np.asarray(
            sol.x[:12] - oracle.x[:12])).max()) / scale)
    assert max(errs) < 0.03, [f"{e * 100:.2f}%" for e in errs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_long_horizon_blocked_consistency_production(seed):
    """At the production alpha the blocking approximation is nearly
    exact: blocked vs full H=16 system, both converged, first-step
    forces within 1% m*g (measured <= 0.3% — vs up to ~4% at the
    reference's alpha, where near-nullspace directions also made the
    comparison itself fragile)."""
    scale = float(a1_params().total_mass) * 9.81
    case = cadence_case_long(0.0, seed)
    full = cone_qp.solve(build_prob_long(case, H16.force_weight,
                                         blocked=False), iters=4000)
    conv = cone_qp.solve(build_prob_long(case, H16.force_weight),
                         iters=4000)
    err = float(np.abs(np.asarray(conv.x[:12] - full.x[:12])).max())
    assert err < 0.01 * scale, f"{err / scale * 100:.2f}% m*g"
