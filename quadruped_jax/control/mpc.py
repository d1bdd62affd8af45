"""Convex-MPC stance controller (driver + batched QP solve).

Capability parity with `MPCStanceLegController`
(quadruped/src/controllers/mpc/qr_mpc_stance_leg_controller.cpp) and the QP
kernel `qr_mpc_interface.cpp`:

  * `SetupCommand` (:158-204): per-axis low-pass of commanded twist, clip to
    the velocity envelope, desired-yaw integration with the +/-pi wrap logic.
  * `UpdateMPC` (:337-382): desired-state trajectory built by integrating the
    commanded twist over the horizon; desired world position clipped to
    +/-0.1 m of the actual; solve cadence every 15 ms (the reference's
    iterations_per_mpc/2 ticks of its 1 kHz loop; its first-50-ticks
    every-tick boot phase is replaced by mpc_cold_start — re-enable via
    boot_solve_ticks).
  * `SolveDenseMPC` + `SolveMPC` (:385-410, qr_mpc_interface.cpp:359-442):
    13-state SRB matrices at the current yaw, exact ZOH discretization
    (closed form — see dynamics/srb.py), horizon condensation, friction-cone
    QP, solved here by the batched ADMM solver instead of qpOASES; forces map
    to feed-forward torques via tau = -J^T R^T f.

The stateful file-static globals of the reference's MPC interface
(qr_mpc_interface.cpp:35-104) become the explicit `MpcState` pytree, one per
scenario, so thousands of independent MPC instances batch through one jitted
solve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from quadruped_jax.core import se3
from quadruped_jax.core import struct
from quadruped_jax.dynamics import srb
from quadruped_jax.gait.scheduler import GaitConfig, GaitState, LegState, predicted_contact_table
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.robots import kinematics
from quadruped_jax.control.types import RobotObservation
from quadruped_jax.control.desired_state import DesiredStateCommand
from quadruped_jax.solvers import condense, cone_qp


@struct.dataclass
class MpcConfig:
    horizon: int = struct.field(pytree_node=False, default=10)
    dt_mpc: float = struct.field(pytree_node=False, default=0.03)
    control_dt: float = struct.field(pytree_node=False, default=0.002)
    # Reference cadence semantics: iterationsInaMPC=30 counts ticks of the
    # reference's 1 kHz loop, so it solves every 15 ticks = 15 ms
    # (UpdateMPC :342). The cadence here is TIME-based so a 500 Hz
    # control_dt keeps the same 15 ms solve period — running it at 30 ms
    # (the old tick-based interpretation) measurably degrades the trot
    # (mean height 0.241 -> 0.264, vx overshoot 0.086 -> 0.034 at 15 ms).
    iterations_per_mpc: int = struct.field(pytree_node=False, default=30)

    @property
    def ticks_per_solve(self) -> int:
        period_s = (self.iterations_per_mpc / 2) * 0.001
        return max(1, int(round(period_s / self.control_dt)))
    # 24 accelerated iterations match the accuracy of the former
    # 40-iteration relaxed budget on both the bench and contact-switching
    # trot ensembles (benchmarks/exp_admm_iters.py) with 40% fewer loop
    # iterations.
    qp_iters: int = struct.field(pytree_node=False, default=24)
    # Fast-ADMM momentum (restart period / relaxation): restart=20 with
    # alpha=1.0 is the stable optimum; set qp_accel_restart=0 and
    # qp_alpha=1.6 to recover the unaccelerated scheme.
    qp_accel_restart: int = struct.field(pytree_node=False, default=20)
    qp_alpha: float = struct.field(pytree_node=False, default=1.0)
    # Budget for the one-off COLD solve (mpc_cold_start) that seeds the
    # warm-start state before the per-tick loop runs. ADMM cold starts
    # have a long convergence tail on hard poses (hundreds of iterations
    # to reach the 3% m*g golden-parity gate, tests/test_golden_parity.py
    # ::test_production_cold_budget) — the reference handles the same
    # transient by solving every tick for its first 50 ticks
    # (qr_mpc_stance_leg_controller.cpp:342); we spend the budget once,
    # up front, outside the scanned tick. The cold solve runs the RELAXED
    # scheme (alpha=1.6, no momentum): Fast-ADMM's restarted momentum wins
    # at short warm budgets but stalls 3-30% m*g away from the optimum on
    # long cold solves (measured on the golden ensemble — relaxed reaches
    # 0.3-0.6% at 400 iterations where accel sits at 4-34%).
    qp_cold_iters: int = struct.field(pytree_node=False, default=400)
    qp_cold_alpha: float = struct.field(pytree_node=False, default=1.6)
    # ADMM penalty for the warm per-tick solves. None = the solver default
    # (cone_qp.RHO_CONE = 0.05, the H=10 optimum). Measured at H=16
    # (benchmarks/exp_h16_warm{,2}.py): rho in [0.05, 0.3] does NOT move
    # the warm plateau against a properly converged oracle — the knob
    # exists for per-config tuning but the long-horizon lever is the
    # force regularizer, not rho (see exp_h16_alpha.py / the H=16 notes
    # in tests/test_golden_parity.py). The COLD boot keeps the solver
    # default at every horizon (its measured optimum, exp_h16_tune.py 1b).
    qp_rho: float | None = struct.field(pytree_node=False, default=None)
    # Flip-aware warm start (cone_qp.shift_warm_start): when the trot
    # contact table advances one horizon row between cadence solves
    # (every other 15 ms solve at dt_mpc = 30 ms), warm-start from the
    # previous solution time-shifted one step. A measured TRADE-OFF, not
    # a win (40-step cadence chains, tests/test_warm_shift.py +
    # benchmarks): the shift caps the worst-case warm-budget transient
    # at full-diagonal flips (~10.8% -> ~5% m*g) but RAISES the typical
    # flip-step error (~1% -> ~4%, worse mean, and it breaks the 3%
    # 10-step oracle parity gate) — the plain warm start converges
    # better at ordinary flips; neither dual treatment nor merit-based
    # per-step selection separates the two regimes (all measured). OFF
    # by default; enable for applications that need the bounded worst
    # case. Applies only to unblocked horizons (move-blocked tails have
    # non-uniform group widths).
    qp_warm_shift: bool = struct.field(pytree_node=False, default=False)
    # Move blocking (head, block): tail horizon steps share force
    # variables, shrinking the condensed system (solvers/condense.py
    # move_block_groups). () disables. (6, 2) at H=10 costs < 0.7% m*g
    # on converged first-step forces for ~1.4x solve throughput; gated by
    # the production-budget golden parity tests before becoming default.
    move_block: tuple = struct.field(pytree_node=False, default=())

    @property
    def n_force_groups(self) -> int:
        from quadruped_jax.solvers import condense as _c

        if not self.move_block:
            return self.horizon
        return _c.move_block_groups(self.horizon, *self.move_block)[1]
    # Q diag from stance_leg_controller.yaml advanced_trot (12) + gravity 0.
    state_weights: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(
            [10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0], jnp.float32))
    force_weight: float = struct.field(pytree_node=False, default=4e-6)
    # SetupCommand filters (qr_mpc_stance_leg_controller.cpp:173).
    vel_filters: tuple = struct.field(pytree_node=False,
                                      default=(0.01, 0.005, 0.03))
    # Solve scheduling: "cadence" reproduces the reference's 15-tick
    # multiplexing inside the tick (lax.cond); "always"/"never" let a
    # cadence-hoisted rollout (sim/rollout_cadenced.py) solve once per
    # chunk and hold forces in between — identical cadence semantics,
    # no dead solve branches under vmap.
    solve_mode: str = struct.field(pytree_node=False, default="cadence")
    # Ticks at boot during which the MPC solves EVERY tick (the
    # reference's iterationCounter < 50 phase). Default 0: mpc_cold_start
    # already seeds a converged warm state once per rollout, so the
    # every-tick boot phase would just re-pay ~44 redundant solves in the
    # first 100 ms of every scanned rollout. Set 50 to reproduce the
    # reference's literal boot behavior (e.g. when disabling cold_start).
    boot_solve_ticks: int = struct.field(pytree_node=False, default=0)


def long_horizon_config(**overrides) -> MpcConfig:
    """The tuned H=16 move-blocked production configuration — 0.48 s of
    lookahead (the reference's K_MAX_GAIT_SEGMENTS cap,
    qr_mpc_interface.h:32) at H=10-class solve cost.

    Three measured choices (benchmarks/exp_h16_{tune,warm,warm2,alpha}.py):

      * move_block (4, 2): head 4 individual steps + 6 tail pairs ->
        10 groups = 120 variables — the SAME condensed size as H=10, so
        the solve costs what an H=10 solve costs (a (6, 2) blocking has
        132 vars; the unblocked system 192). The blocked solution moves
        converged
        first-step forces < 0.4% m*g vs the full 192-var system at this
        configuration's alpha (vs up to ~4% at the reference's alpha —
        see below), and the warm cadence gate passes at < 1.5%.
      * force_weight 1e-4 (vs the reference's 4e-6): at H=16 the tiny
        regularizer leaves near-nullspace force directions (many force
        schedules produce near-identical state cost over 0.48 s) whose
        position shifts first-step forces by up to 8% m*g while ADMM
        drains them at ~1 bit / 300 iterations — budget- and
        rho-insensitive (measured). alpha=1e-4 removes the pathology
        outright: cold 400 iters -> 0.02%, warm 24 iters -> < 1% against
        a converged oracle. The regularizer choice is part of the H=16
        problem definition, gated end-to-end by the closed-loop test and
        the internal-oracle cadence gate (tests/test_golden_parity.py).
      * everything else at MpcConfig defaults — the H=10 production
        budgets transfer unchanged once the conditioning is fixed.
    """
    kw = dict(horizon=16, move_block=(4, 2), force_weight=1e-4)
    kw.update(overrides)
    return MpcConfig(**kw)


@struct.dataclass
class MpcState:
    x_vel_des: jnp.ndarray        # [] filtered forward velocity command
    y_vel_des: jnp.ndarray
    yaw_turn_rate: jnp.ndarray
    yaw_des: jnp.ndarray          # [] integrated desired yaw (unwrapped)
    pos_des_world: jnp.ndarray    # [3]
    forces_world: jnp.ndarray     # [4, 3] last MPC solution (held)
    warm_primal: jnp.ndarray      # [12H]
    warm_dual: jnp.ndarray        # [4H, 5] cone duals per force triple
    warm_pinned: jnp.ndarray      # [4H] pin pattern of the last solve
    iteration: jnp.ndarray        # [] int32
    # Base (x, y, vx, vy) latched when a front leg enters swing — the spline
    # start for the CoM-destination interpolation
    # (footholdPlanner->firstSwingBaseState, qr_mpc_stance_leg_controller.cpp
    # :267-280).
    first_swing_base: jnp.ndarray  # [4]


def mpc_init(config: MpcConfig, body_height: float = 0.27) -> MpcState:
    h = config.n_force_groups   # warm-start state lives in reduced space
    return MpcState(
        x_vel_des=jnp.zeros((), jnp.float32),
        y_vel_des=jnp.zeros((), jnp.float32),
        yaw_turn_rate=jnp.zeros((), jnp.float32),
        yaw_des=jnp.zeros((), jnp.float32),
        pos_des_world=jnp.asarray([0.0, 0.0, body_height], jnp.float32),
        forces_world=jnp.zeros((4, 3), jnp.float32),
        warm_primal=jnp.zeros((12 * h,), jnp.float32),
        warm_dual=jnp.zeros((4 * h, condense.CONE_ROWS), jnp.float32),
        warm_pinned=jnp.zeros((4 * h,), jnp.float32),
        iteration=jnp.zeros((), jnp.int32),
        first_swing_base=jnp.zeros((4,), jnp.float32),
    )


def setup_command(config: MpcConfig, state: MpcState, obs: RobotObservation,
                  des: DesiredStateCommand) -> MpcState:
    """Velocity filtering + desired-yaw integration (SetupCommand :158-204)."""
    fx, fy, fw = config.vel_filters
    x_vel = jnp.clip(state.x_vel_des * (1 - fx) + des.velocity[0] * fx,
                     -1.0, 2.0)
    y_vel = jnp.clip(state.y_vel_des * (1 - fy) + des.velocity[1] * fy,
                     -0.6, 0.6)
    wz = state.yaw_turn_rate * (1 - fw) + des.omega[2] * fw

    yaw_des = state.yaw_des + config.control_dt * wz
    yaw_des = se3.wrap_angle(yaw_des)
    # Unwrap relative to the current yaw so dtheta/dt = R^T w stays
    # continuous across +/-pi (:194-200).
    yaw_cur = obs.base_rpy[2]
    yaw_des = jnp.where((yaw_cur > jnp.pi / 2) & (yaw_des < 0),
                        yaw_des + 2 * jnp.pi, yaw_des)
    yaw_des = jnp.where((yaw_cur < -jnp.pi / 2) & (yaw_des > 0),
                        yaw_des - 2 * jnp.pi, yaw_des)
    return state.replace(x_vel_des=x_vel, y_vel_des=y_vel,
                         yaw_turn_rate=wz, yaw_des=yaw_des)


def _desired_trajectory(config: MpcConfig, state: MpcState,
                        obs: RobotObservation, des: DesiredStateCommand,
                        rpy_comp: jnp.ndarray, body_height,
                        v_preview: jnp.ndarray | None = None,
                        z_preview: jnp.ndarray | None = None) -> jnp.ndarray:
    """[H, 13] integrated command trajectory (UpdateMPC :361-376).

    v_preview: optional [H] BODY-frame forward velocity per horizon step —
    a scheduled speed profile / route plan the controller knows in
    advance. The reference integrates the CURRENT command as constant
    over the horizon; with a preview the velocity rows take v_k directly
    and positions integrate sum_{j<k} v_j dt (which reduces to the
    constant-drift form for a constant preview). This is what makes a
    longer horizon WORTH something at speed transitions: H=16 sees
    0.48 s of the schedule vs H=10's 0.30 s
    (tests/test_long_horizon_closed_loop.py::test_h16_preview_transition).

    z_preview: optional [H] desired base height (world z) per horizon
    step — the height half of a route plan (crouch under an obstacle,
    ramp/stair approach). Sets the height row directly and the vertical
    velocity row to its finite difference, so the MPC tracks the height
    schedule instead of a constant body height.
    """
    h = config.horizon
    r = obs.rot_body_to_world
    v_des_world = r @ jnp.stack([state.x_vel_des, state.y_vel_des,
                                 jnp.zeros_like(state.x_vel_des)])
    # Clip desired world position toward the actual (:345-356).
    start_xy = jnp.clip(state.pos_des_world[:2],
                        obs.base_position[:2] - 0.1,
                        obs.base_position[:2] + 0.1)
    k = jnp.arange(h, dtype=jnp.float32)[:, None]
    base = jnp.concatenate([
        rpy_comp[:2], state.yaw_des[None],
        start_xy, body_height[None],
        jnp.zeros(2, jnp.float32), state.yaw_turn_rate[None],
        v_des_world[:2], jnp.zeros(1, jnp.float32),
        jnp.full((1,), srb.GRAVITY, jnp.float32),
    ])
    drift = jnp.zeros((13,), jnp.float32)
    drift = drift.at[2].set(state.yaw_turn_rate)
    drift = drift.at[3].set(v_des_world[0])
    drift = drift.at[4].set(v_des_world[1])
    traj = base[None, :] + k * config.dt_mpc * drift[None, :]
    if v_preview is not None:
        v_body = jnp.stack(
            [v_preview, jnp.full_like(v_preview, state.y_vel_des),
             jnp.zeros_like(v_preview)], axis=-1)          # [H, 3]
        v_w = jnp.einsum("ij,hj->hi", r, v_body)            # [H, 3] world
        csum = jnp.cumsum(v_w[:, :2], axis=0)
        traj = traj.at[:, 3:5].set(
            start_xy[None, :] + config.dt_mpc * (csum - v_w[:, :2]))
        traj = traj.at[:, 9:11].set(v_w[:, :2])
    if z_preview is not None:
        vz = jnp.diff(z_preview, append=z_preview[-1:]) / config.dt_mpc
        traj = traj.at[:, 5].set(z_preview).at[:, 11].set(vz)
    return traj


def gravity_warm_start(params: RobotParams,
                       contact_table: jnp.ndarray) -> jnp.ndarray:
    """Analytic primal initialization for cold solves: body weight split
    evenly among the contact legs of each horizon step (fz only).

    Cuts the cold-start ADMM error roughly in half at a fixed budget on
    stance-dominated poses (measured on the golden-parity ensemble); free
    to build (one masked divide)."""
    n_c = jnp.sum(contact_table, axis=-1, keepdims=True)
    fz = contact_table * params.total_mass * 9.81 / jnp.maximum(n_c, 1.0)
    x0 = jnp.zeros(contact_table.shape + (3,), jnp.float32)
    x0 = x0.at[..., 2].set(fz)
    return x0.reshape(x0.shape[:-3] + (-1,))


def mpc_solve(config: MpcConfig, params: RobotParams, state: MpcState,
              obs: RobotObservation, des: DesiredStateCommand,
              contact_table: jnp.ndarray, rpy_comp: jnp.ndarray,
              body_height, *, iters: int | None = None,
              x0_warm: jnp.ndarray | None = None,
              y0_warm: jnp.ndarray | None = None,
              alpha: float | None = None,
              accel_restart: int | None = None,
              v_preview: jnp.ndarray | None = None,
              z_preview: jnp.ndarray | None = None) -> MpcState:
    """One full MPC problem build + solve (SolveDenseMPC + SolveMPC).

    `iters`/`x0_warm`/`y0_warm` default to the per-tick production budget
    warm-started from the previous solution; mpc_cold_start overrides them
    for the one-off boot solve."""
    h = config.horizon
    r_mat = obs.rot_body_to_world
    foot_base = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    r_feet = jnp.einsum("ij,lj->li", r_mat, foot_base - params.com_offset)

    # Re-anchor the stored desired position to +/-0.1 m of the actual
    # (UpdateMPC :345-356 writes the clip BACK into posDesiredinWorld).
    # Without the write-back the integrated target winds up ahead of the
    # robot and the persistent +0.1 m positional pull drives steady-state
    # velocity ~25% above the command (measured on the SRB trot).
    start_xy = jnp.clip(state.pos_des_world[:2],
                        obs.base_position[:2] - 0.1,
                        obs.base_position[:2] + 0.1)
    state = state.replace(
        pos_des_world=state.pos_des_world.at[:2].set(start_xy))

    x0 = srb.srb_initial_state(obs.base_rpy, obs.base_position,
                               obs.base_omega_world, obs.base_vel_world)
    x_des = _desired_trajectory(config, state, obs, des, rpy_comp,
                                body_height, v_preview, z_preview)

    a_ct, b_ct = srb.srb_continuous(r_mat, params.total_inertia,
                                    params.total_mass, r_feet)
    ad, bd = srb.srb_discretize(a_ct, b_ct, config.dt_mpc)
    p_cost, q_cost = condense.condense_cost_structured(
        a_ct, bd, ad, x0, x_des, config.state_weights, config.force_weight,
        h, config.dt_mpc)
    fz_hi = (contact_table * params.max_force).reshape(h * 4)
    if config.move_block:
        groups, n_g = condense.move_block_groups(h, *config.move_block)
        p_cost, q_cost, fz_hi = condense.reduce_move_blocking(
            p_cost, q_cost, fz_hi, groups, n_g, h)
    prob = cone_qp.ConeQP(p=p_cost, q=q_cost, mu=params.friction_coef,
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)
    rho = cone_qp.RHO_CONE
    if config.qp_rho is not None and x0_warm is None:
        # qp_rho applies to the warm per-tick path only; the cold boot
        # (which passes x0_warm) keeps the solver default (see MpcConfig).
        rho = config.qp_rho
    pin_new = (fz_hi < 1e-6).astype(jnp.float32)
    x0 = state.warm_primal if x0_warm is None else x0_warm
    y0 = state.warm_dual if y0_warm is None else y0_warm
    if config.qp_warm_shift and not config.move_block and x0_warm is None:
        # Flip-aware warm start on the deployed per-tick path (the cold
        # boot passes its own gravity-split x0_warm).
        x0, y0 = cone_qp.shift_warm_start(x0, y0, state.warm_pinned,
                                          pin_new)
    sol = cone_qp.solve(
        prob, iters=config.qp_iters if iters is None else iters,
        rho=rho, x0=x0, y0=y0,
        alpha=config.qp_alpha if alpha is None else alpha,
        accel_restart=(config.qp_accel_restart if accel_restart is None
                       else accel_restart))
    # First-step forces: the first step is always its own group.
    forces = sol.x[: 12].reshape(4, 3)  # world frame
    return state.replace(forces_world=forces, warm_primal=sol.x,
                         warm_dual=sol.y, warm_pinned=pin_new)


def _contact_table(config: MpcConfig, gait_config: GaitConfig,
                   gait_state: GaitState):
    """[H, 4] predicted contact table, row 0 pinned to the measured contact
    (Run :282-306). Returns (table, stance_now)."""
    table = predicted_contact_table(gait_config, gait_state, config.dt_mpc,
                                    config.horizon)
    early = (gait_state.leg_state == LegState.EARLY_CONTACT)
    table = jnp.maximum(table, early.astype(table.dtype)[None, :])
    stance_now = ((gait_state.leg_state == LegState.STANCE) | early)
    table = table.at[0].set(stance_now.astype(table.dtype))
    return table, stance_now


def mpc_cold_start(config: MpcConfig, params: RobotParams,
                   gait_config: GaitConfig, gait_state: GaitState,
                   state: MpcState, obs: RobotObservation,
                   des: DesiredStateCommand) -> MpcState:
    """One high-budget boot solve seeding the warm-start state.

    The per-tick production budget (qp_iters=24 Fast-ADMM iterations) is
    parity-verified only WARM-STARTED at the solve cadence
    (tests/test_golden_parity.py::test_production_cadence_parity); a cold
    24-iteration solve can sit 20% of m*g away from the active-set optimum
    on hard poses. This runs once per rollout, outside the scanned tick —
    the batched replacement for the reference's solve-every-tick boot
    phase (qr_mpc_stance_leg_controller.cpp:342, iterationCounter < 50).
    """
    state = setup_command(config, state, obs, des)
    body_height = des.position[2]
    rpy_comp = jnp.zeros(2, jnp.float32)
    table, _ = _contact_table(config, gait_config, gait_state)
    grav_table = table
    if config.move_block:
        # The warm state lives in move-blocked space: gravity-split over
        # the per-group contact table (min over covered steps, matching
        # reduce_move_blocking's bounds).
        import numpy as np

        groups, n_g = condense.move_block_groups(config.horizon,
                                                 *config.move_block)
        mask = jnp.asarray(
            np.eye(n_g, dtype=np.float32)[groups]).T[..., None]  # [G,H,1]
        grav_table = jnp.min(
            jnp.where(mask > 0.5, table[None, :, :], jnp.inf), axis=1)
    return mpc_solve(config, params, state, obs, des, table, rpy_comp,
                     body_height, iters=config.qp_cold_iters,
                     x0_warm=gravity_warm_start(params, grav_table),
                     y0_warm=jnp.zeros_like(state.warm_dual),
                     alpha=config.qp_cold_alpha, accel_restart=0)


def height_and_pitch_compensation(gait_state: GaitState,
                                  des: DesiredStateCommand,
                                  body_height):
    """Swing-phase body height / backward-walk pitch compensation
    (qr_mpc_stance_leg_controller.cpp:233-241). The reference applies the
    first swinging leg's phase; batched form uses the max swing-phase lobe.
    """
    swinging = (gait_state.desired_leg_state == LegState.SWING)
    lobe = jnp.sin(gait_state.normalized_phase * jnp.pi) * swinging
    peak = jnp.max(lobe, axis=-1)
    height = body_height + 0.02 * peak
    pitch_comp = jnp.where(des.velocity[0] < -0.01, -0.1 * peak, 0.0)
    return height, pitch_comp


def mpc_step(config: MpcConfig, params: RobotParams,
             gait_config: GaitConfig, gait_state: GaitState,
             state: MpcState, obs: RobotObservation,
             des: DesiredStateCommand,
             foot_targets_world: jnp.ndarray | None = None,
             v_preview: jnp.ndarray | None = None,
             z_preview: jnp.ndarray | None = None):
    """One control tick of the MPC stance controller.

    Returns (stance torques [12], forces_world [4,3], mpc_updated, new state).
    Solve cadence: every ticks_per_solve ticks (15 ms); the reference's
    first-50-ticks boot phase (UpdateMPC :342) is off by default in
    favor of mpc_cold_start (boot_solve_ticks re-enables it). When `foot_targets_world` ([4,3] desired footholds)
    is given, the desired CoM x/y follow the reference's spline toward the
    mean of current/planned footholds (Run :243-280).
    """
    state = setup_command(config, state, obs, des)

    body_height, pitch_comp = height_and_pitch_compensation(
        gait_state, des, des.position[2])
    rpy_comp = jnp.stack([jnp.zeros_like(pitch_comp), pitch_comp])

    # Desired world position integration (Run :224-227).
    r = obs.rot_body_to_world
    v_des_world = r @ jnp.stack([state.x_vel_des, state.y_vel_des,
                                 jnp.zeros_like(state.x_vel_des)])
    pos_des = state.pos_des_world + config.control_dt * v_des_world.at[2].set(0.0)
    z_blend = 0.99 * (body_height + (body_height - obs.base_position[2])) \
        + 0.01 * state.pos_des_world[2]
    pos_des = pos_des.at[2].set(z_blend)

    # Latch the base planar state when any leg starts swinging (the spline
    # start, footholdPlanner->firstSwingBaseState).
    any_first_swing = jnp.max(gait_state.first_swing) > 0.5
    base_planar = jnp.stack([obs.base_position[0], obs.base_position[1],
                             obs.base_vel_world[0], obs.base_vel_world[1]])
    first_swing_base = jnp.where(any_first_swing, base_planar,
                                 state.first_swing_base)

    if foot_targets_world is not None:
        # CoM destination = mean over legs of (planned foothold for swing
        # legs, current foot position for stance legs) (Run :243-253).
        foot_base = kinematics.foot_positions_in_base_frame(
            params, obs.joint_angles)
        foot_world = jnp.einsum("ij,lj->li", r, foot_base) \
            + obs.base_position
        in_contact = (gait_state.leg_state != LegState.SWING)[:, None]
        com_dest = jnp.mean(jnp.where(in_contact, foot_world,
                                      foot_targets_world), axis=0)
        # Interpolation parameter from the front legs' phase (Run :255-270).
        duty = gait_config.duty_factor[0]
        p0 = gait_state.phase_in_full_cycle[0]
        p1 = gait_state.phase_in_full_cycle[1]
        leg0_sw = gait_state.desired_leg_state[0] == LegState.SWING
        leg1_sw = gait_state.desired_leg_state[1] == LegState.SWING
        t_par = jnp.where(
            leg0_sw, p0 - duty,
            jnp.where(leg1_sw, p1 - duty,
                      jnp.where(p0 < p1, p0 + (1 - duty), p1 + (1 - duty))))
        t_par = jnp.clip(t_par * 2.0, 0.0, 1.0)
        xy = (1 - t_par) * first_swing_base[:2] + t_par * com_dest[:2]
        pos_des = pos_des.at[:2].set(xy)

    state = state.replace(pos_des_world=pos_des,
                          first_swing_base=first_swing_base)

    # Contact table from gait phases; row 0 pinned to measured contact
    # (Run :282-306).
    table, stance_now = _contact_table(config, gait_config, gait_state)

    def do_solve(s):
        return mpc_solve(config, params, s, obs, des, table, rpy_comp,
                         body_height, v_preview=v_preview,
                         z_preview=z_preview)

    if config.solve_mode == "always":
        should_solve = jnp.ones((), jnp.bool_)
        state = do_solve(state)
    elif config.solve_mode == "never":
        should_solve = jnp.zeros((), jnp.bool_)
    else:  # "cadence" — the reference's tick multiplexing
        should_solve = (
            (state.iteration % config.ticks_per_solve == 0)
            | (state.iteration < config.boot_solve_ticks))
        state = jax.lax.cond(should_solve, do_solve, lambda s: s, state)

    # tau = -J^T R^T f per stance leg (SolveDenseMPC :402-409 + GetAction).
    f_body = jnp.einsum("ji,lj->li", r, state.forces_world)  # R^T f
    tau = kinematics.map_contact_forces_to_torques(params, obs.joint_angles,
                                                   -f_body)
    tau = jnp.clip(tau, -params.torque_limit, params.torque_limit)
    # Zero torque on swing joints; the swing controller owns them.
    stance_mask = jnp.repeat(stance_now.astype(tau.dtype), 3)
    tau = tau * stance_mask

    state = state.replace(iteration=state.iteration + 1)
    return tau, state.forces_world, should_solve, state
