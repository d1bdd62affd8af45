"""Headline benchmark: convex-MPC solves/s/chip at horizon 10 (A1 trot).

One "solve" counts the FULL MPC update as the reference defines it
(quadruped/src/controllers/mpc/qr_mpc_stance_leg_controller.cpp UpdateMPC +
SolveDenseMPC + qr_mpc_interface.cpp SolveMPC): desired-trajectory build
(integrated command drift — built INSIDE the timed jit), SRB state-space
matrices at the current orientation, exact-ZOH discretization, horizon
condensation, friction-cone constraint build, and the QP solve — not just
the inner QP iterations (SURVEY.md §7.3 "benchmark honesty").

The timed configuration is EXACTLY the production steady state that the
golden-parity suite verifies against the reference's compiled qpOASES
kernel (tests/test_golden_parity.py::test_production_cadence_parity):
qp_iters=24 Fast-ADMM iterations (restart 20, alpha 1.0), WARM-STARTED
from the solution of the previous problem in a 15 ms cadence sequence, on
a TROT contact table (diagonal pairs swapping across the horizon — half
the force triples pinned, exercising the rho-boosted pinned-row path).
The one-off cold boot solve (MpcConfig.qp_cold_iters, mpc_cold_start) runs
outside the timed region, as it does in the closed loop.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "solves/s", "vs_baseline": N}
vs_baseline is against the 100k solves/s/chip north star (BASELINE.json).

The JSON line also carries its own error bars (median + [min, max] band
over QTPU_BENCH_RUNS >= 5 independent timing runs) and the compute-side
accounting the MFU question needs: FLOPs per solve (analytic dominant-term
model + XLA's compiled cost analysis, which under-counts scans — see
analytic_flops_per_solve) and the achieved TFLOP/s at the reported rate.

Env knobs: QTPU_BENCH_BATCH (default 32768 chunked / 1024 monolithic),
QTPU_BENCH_CHUNK (default 256; 0 = monolithic graph — chunking is
scheduling only, outputs agree to reassociation roundoff),
QTPU_BENCH_TABLE=stance for the legacy all-stance table,
QTPU_BENCH_MOVE_BLOCK="6,2" to bench the move-blocked condensed system
(solvers/condense.py move_block_groups; parity-gated in
tests/test_golden_parity.py), QTPU_BENCH_H=16 for the long-horizon
move-blocked configuration (auto-selects the H=16-tuned solver settings;
parity-gated by tests/test_golden_parity.py::test_long_horizon_*),
QTPU_BENCH_RUNS (default 5 timing runs for the variance band).

    python bench.py        # on the GPU; one JAX process per card
"""

from __future__ import annotations

import json
import os
import time

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from quadruped_jax.solvers import cone_qp  # noqa: E402

HORIZON = int(os.environ.get("QTPU_BENCH_H", "10"))
# Newton-Schulz precision ablation: trailing f32 polish steps out of the
# 11 NS iterations (the rest run bf16 — the production default is
# cone_qp.NS_F32_POLISH; 11 = all-f32 for the ablation line).
NS_F32_POLISH = int(os.environ.get("QTPU_BENCH_NS_POLISH",
                                   cone_qp.NS_F32_POLISH))
# Cross-cadence M^{-1} reuse (cone_qp.InverseCarry): rescale + pinned-row
# Woodbury + short NS polish replaces the cold 11-iteration inverse on
# the warm path — parity-gated (tests/test_minv_reuse.py + the chained
# cadence gates) but DEFAULT OFF: the 2.4x FLOP saving buys time only if
# the inverse is FLOP-bound (the Woodbury/rescale stages stream the same
# [B, n, n] tensors the saved NS iterations would have).
# QTPU_BENCH_MINV_REUSE=1 times the reuse path.
MINV_REUSE = os.environ.get("QTPU_BENCH_MINV_REUSE", "0") == "1"
# Batch chunking: run the batch as `batch/chunk` sequential lax.map
# chunks inside ONE jit. Scheduling only — the math per element is the
# same program, and chunked-vs-monolithic outputs agree to
# reassociation-level roundoff (<= 3e-4 N on forces, vs the ~3.8 N
# parity gates; tests/test_bench_chunking.py), so the golden-parity
# claims carry over. Chunking was tuned on an earlier accelerator, where
# large monolithic batches scheduled badly; whether it pays on the GPU
# is to be measured. 0 disables (the monolithic graph).
CHUNK = int(os.environ.get("QTPU_BENCH_CHUNK", "256"))
DT_MPC = 0.03
CADENCE_S = 0.015   # MPC re-solves every 15 ticks at 1 kHz
TARGET = 100_000.0


def chunked(fn, batch: int, chunk: int):
    """jit(fn) over arrays with a leading batch axis, run as batch/chunk
    sequential lax.map chunks when chunk divides batch (else one graph)."""
    if not (chunk > 0 and batch % chunk == 0 and batch > chunk):
        return jax.jit(fn)
    n_chunks = batch // chunk

    def fn_chunked(*args):
        rs = lambda a: a.reshape((n_chunks, chunk) + a.shape[1:])
        out = jax.lax.map(lambda ch: fn(*ch), jax.tree.map(rs, args))
        # Restore batch-major layout so consumers see the same [batch, ...]
        # shapes as the monolithic graph.
        return jax.tree.map(
            lambda a: a.reshape((batch,) + a.shape[2:]), out)

    return jax.jit(fn_chunked)


def make_states(batch: int, t: float, rng):
    """Batched robot states for the cadence step at time t: the same
    random scenario ensemble advanced by the commanded motion.

    Each array draws from its own stream, so the first k scenarios are the
    same whatever the batch size (a small reference run can re-solve a
    prefix of a large batch)."""
    rng_rpy, rng_feet, rng_x = (np.random.default_rng(s)
                                for s in rng.integers(0, 2 ** 31, size=3))
    rpy = (rng_rpy.normal(size=(batch, 3)) * 0.1).astype(np.float32)
    feet = (rng_feet.normal(size=(batch, 4, 3)) * 0.05
            + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
            + 0.02 * np.sin(5 * t)).astype(np.float32)
    # 13th SRB state = the gravity constant (srb.GRAVITY) — without it
    # the QP's optimum is near-zero forces and the problem is not the
    # production one (timing is data-independent, honesty is not).
    from quadruped_jax.dynamics import srb as _srb

    x0 = np.concatenate(
        [rng_x.normal(size=(batch, 12)) * 0.05,
         _srb.GRAVITY * np.ones((batch, 1))],
        1).astype(np.float32)
    x0[:, 3] += 0.4 * t        # commanded forward progress
    return rpy, feet, x0


def trot_table(batch: int, t: float, rng, horizon: int | None = None):
    """[B, H, 4] trot contact table: diagonal pairs, per-scenario phase
    offset, advancing with t — half the triples pinned (fz_hi = 0), the
    rho-boosted path the closed loop actually solves."""
    horizon = HORIZON if horizon is None else horizon
    offs = rng.uniform(size=(batch, 1))
    phase = (np.arange(horizon)[None, :] * DT_MPC / 0.6 + t / 0.6
             + offs) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    table = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a], axis=2)
    table[:, 0, :] = 1.0    # current tick pinned to measured full stance
    return table.astype(np.float32)


# MPC state weights of the bench problem (13-state SRB order).
WEIGHTS = (10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0)


def bench_config(horizon: int, move_block=()):
    """The production MpcConfig at this horizon."""
    from quadruped_jax.control.mpc import MpcConfig, long_horizon_config

    if horizon >= 12:
        # The tuned long-horizon production configuration (move blocking
        # + the 1e-4 force regularizer — see control/mpc.py
        # long_horizon_config for the measured rationale).
        return long_horizon_config(horizon=horizon,
                                   move_block=tuple(move_block))
    return MpcConfig(horizon=horizon, move_block=tuple(move_block))


def mpc_problem(cfg, params, rpy, feet, x0, contact):
    """The condensed MPC QP of one cadence step, batched: desired
    trajectory (the commanded twist integrated over the horizon from the
    current state, UpdateMPC :361-376), SRB matrices + exact ZOH,
    condensation, cone bounds from the contact table (+ move blocking)."""
    from quadruped_jax.core import se3
    from quadruped_jax.dynamics import srb
    from quadruped_jax.solvers import condense

    h = cfg.horizon
    r = se3.rpy_to_rotmat(rpy)
    k = jnp.arange(h, dtype=jnp.float32)[:, None]
    drift = jnp.zeros((13,), jnp.float32).at[3].set(0.4 * DT_MPC)
    x_des = x0[:, None, :] + k[None] * drift[None, None, :]
    x_des = x_des.at[..., 9].set(0.4)

    a, b = srb.srb_continuous(r, params.total_inertia,
                              params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, b, DT_MPC)
    p, q = condense.condense_cost_structured(
        a, bd, ad, x0, x_des, jnp.asarray(WEIGHTS, jnp.float32),
        cfg.force_weight, h, DT_MPC)
    fz_hi = (contact * params.max_force).reshape(contact.shape[0], h * 4)
    if cfg.move_block:
        groups, n_g = condense.move_block_groups(h, *cfg.move_block)
        p, q, fz_hi = condense.reduce_move_blocking(p, q, fz_hi, groups,
                                                    n_g, h)
    return cone_qp.ConeQP(p=p, q=q, mu=jnp.asarray(0.45, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


def build_bench(batch: int, table_kind: str = "trot", move_block=(),
                horizon: int | None = None, chunk: int | None = None,
                ns_f32_polish: int | None = None,
                minv_reuse: bool | None = None):
    """Build the timed production MPC update (jitted) + its warm args.

    The keyword defaults read the module-level env knobs, so bench.py's
    CLI behavior is unchanged; benchmarks/scaling_report.py passes them
    explicitly so the scaling artifact times EXACTLY this program.
    Returns (fn, args, cfg); fn(*args) -> (x, y) of the warm solve.
    """
    horizon = HORIZON if horizon is None else horizon
    chunk = CHUNK if chunk is None else chunk
    ns_f32_polish = NS_F32_POLISH if ns_f32_polish is None else ns_f32_polish
    minv_reuse = MINV_REUSE if minv_reuse is None else minv_reuse
    from quadruped_jax.control.mpc import gravity_warm_start
    from quadruped_jax.robots import a1_params

    cfg = bench_config(horizon, move_block)
    params = a1_params()

    def full(rpy, feet, x0, contact, x_warm, y_warm, pin_prev, inv_carry):
        """One full MPC update: problem build + warm-started production
        solve, incl. the flip-aware warm-start shift when the config
        turns it on (cone_qp.shift_warm_start, unblocked horizons) and —
        when minv_reuse — the cross-cadence M^{-1} reuse."""
        prob = mpc_problem(cfg, params, rpy, feet, x0, contact)
        if cfg.qp_warm_shift and not cfg.move_block:
            # Flip-aware warm-start shift — OFF by default (a measured
            # worst-case/typical trade-off, see MpcConfig.qp_warm_shift).
            pin_new = (prob.fz_hi < 1e-6).astype(jnp.float32)
            x_warm, y_warm = cone_qp.shift_warm_start(x_warm, y_warm,
                                                      pin_prev, pin_new)
        kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                  accel_restart=cfg.qp_accel_restart,
                  ns_f32_polish=ns_f32_polish, x0=x_warm, y0=y_warm)
        if minv_reuse:
            sol, carry = cone_qp.solve(prob, inv_carry=inv_carry,
                                       return_inv_carry=True, **kw)
            return sol.x, sol.y, carry
        # Default path: no carry in OR out — materializing the unused
        # [B, n, n] inverse as an output costs time.
        sol = cone_qp.solve(prob, **kw)
        return sol.x, sol.y

    fn = chunked(full, batch, chunk)

    def tables(t):
        if table_kind == "trot":
            return trot_table(batch, t, np.random.default_rng(1), horizon)
        return np.ones((batch, horizon, 4), np.float32)

    def cold(rpy, feet, x0, contact):
        prob = mpc_problem(cfg, params, rpy, feet, x0, contact)
        grav_table = contact
        if cfg.move_block:
            grav_table = (prob.fz_hi > 0).astype(jnp.float32) \
                .reshape(batch, -1, 4)
        sol, carry = cone_qp.solve(prob, iters=cfg.qp_cold_iters,
                                   alpha=cfg.qp_cold_alpha,
                                   return_inv_carry=True,
                                   x0=gravity_warm_start(params, grav_table))
        return sol.x, sol.y, (prob.fz_hi < 1e-6).astype(jnp.float32), carry

    # --- untimed boot: cold solve on the PREVIOUS cadence step, exactly
    # what mpc_cold_start does once per rollout.
    t_prev, t_now = 0.0, CADENCE_S
    rpy_p, feet_p, x0_p = make_states(batch, t_prev,
                                      np.random.default_rng(0))
    x_warm, y_warm, pin_prev, inv_carry = jax.jit(cold)(
        rpy_p, feet_p, x0_p, jnp.asarray(tables(t_prev)))

    # --- timed step: the NEXT cadence problem, warm-started.
    rpy, feet, x0 = make_states(batch, t_now, np.random.default_rng(0))
    args = (jnp.asarray(rpy), jnp.asarray(feet), jnp.asarray(x0),
            jnp.asarray(tables(t_now)), x_warm, y_warm, pin_prev, inv_carry)
    return fn, args, cfg


def analytic_flops_per_solve(cfg) -> float:
    """Dominant-term FLOP model of one full MPC update (f32-equivalent
    multiply+add = 2 FLOPs), for the MFU/roofline line in the output.

    XLA's compiled cost_analysis() counts each lax.scan BODY once, not
    times its trip count (measured: an 11-step matmul scan reports 1/11th
    of the unrolled flops), so it under-counts this solve ~5x — and the
    chunked default compounds that: lax.map lowers to a scan over chunks,
    so the whole per-chunk program is again counted ONCE instead of
    n_chunks times (at B=8192/chunk=256 that is another 32x, which is why
    flops_per_solve_xla can sit ~170x below the analytic count). Both
    numbers are reported, but achieved_tflops uses this analytic count.

    Terms: Newton-Schulz inverse (NS_ITERS x 2 matmuls of [n, n], the
    large majority), ADMM iterations (matvec + cone applies), M assembly,
    structured condensation, equilibration passes."""
    g = cfg.n_force_groups
    n = 12 * g
    t = 4 * g
    h = cfg.horizon
    if globals()["MINV_REUSE"]:
        # Seeded inverse: 1 residual/select step (3 matmuls incl. the
        # damped variant) + (seed_bf16-1) + polish steps (2 matmuls each)
        # + the Woodbury block (2 n^2 t + t^3) + rescale.
        ns_matmuls = 3 + 2 * (4 - 1) + 2 * 1
        ns = ns_matmuls * 2 * n ** 3 + 2 * n * n * t + t ** 3 + 2 * n * n
    else:
        ns = cone_qp.NS_ITERS * 2 * 2 * n ** 3
    admm = cfg.qp_iters * (2 * n * n + 2 * 2 * t * 5 * 3)
    m_assembly = 2 * n * n
    cond = 2 * 4 * h * h * 144 + 4 * 2 * 144 * 13
    equil = 3 * n * n
    return float(ns + admm + m_assembly + cond + equil)


def measure(batch: int, table_kind: str = "trot", move_block=(),
            reps: int = 20, runs: int = 5, horizon: int | None = None,
            chunk: int | None = None):
    """Returns (median rate, [min, max] band, flops (xla, analytic), cfg).

    flops_xla comes from XLA's compiled cost analysis of the timed jit —
    the full MPC update (trajectory + SRB + ZOH + condensation + cone
    build + solve) — but see analytic_flops_per_solve for why it
    under-counts scanned loops; achieved TFLOP/s = rate * analytic."""
    fn, args, cfg = build_bench(batch, table_kind, move_block,
                                horizon=horizon, chunk=chunk)
    compiled = fn.lower(*args).compile()
    try:
        flops_per_solve = float(compiled.cost_analysis()["flops"]) / batch
    except (KeyError, TypeError):
        flops_per_solve = float("nan")
    out = fn(*args)
    jax.block_until_ready(out)
    rates = []
    for _ in range(max(runs, 1)):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        rates.append(batch / dt)
    rates.sort()
    return rates[len(rates) // 2], [rates[0], rates[-1]], \
        (flops_per_solve, analytic_flops_per_solve(cfg)), cfg


def main():
    dev = jax.devices()[0]
    # Default batch: 32768 with chunking (the warm-start carry alone is
    # [B, 120, 120]); 1024 for the monolithic graph.
    batch = int(os.environ.get("QTPU_BENCH_BATCH",
                               "32768" if CHUNK > 0 else "1024"))
    table_kind = os.environ.get("QTPU_BENCH_TABLE", "trot")
    mb_env = os.environ.get("QTPU_BENCH_MOVE_BLOCK", "")
    if mb_env == "none":
        move_block = ()          # explicit full-resolution horizon
    elif mb_env:
        move_block = tuple(int(x) for x in mb_env.split(","))
    elif HORIZON >= 12:
        # Long-horizon default: the move-blocked configuration is the one
        # parity-gated at H=16 (long_horizon_config — head 4 + tail
        # pairs, 120 variables).
        from quadruped_jax.control.mpc import long_horizon_config as _lh

        move_block = _lh().move_block
    else:
        move_block = ()
    runs = int(os.environ.get("QTPU_BENCH_RUNS", "5"))
    rate, band, (flops_xla, flops_analytic), cfg = measure(
        batch, table_kind, move_block, runs=runs)
    mb_tag = (f", moveblock{cfg.move_block}" if cfg.move_block else "")
    if NS_F32_POLISH != cone_qp.NS_F32_POLISH:
        mb_tag += f", ns_f32_polish={NS_F32_POLISH}"
    if MINV_REUSE:
        mb_tag += ", minv_reuse"
    if CHUNK > 0 and batch % CHUNK == 0 and batch > CHUNK:
        mb_tag += f", chunk{CHUNK}"
    print(json.dumps({
        "metric": f"MPC solves/s/chip (H={HORIZON}, full build+solve, "
                  f"qp_iters={cfg.qp_iters} warm@cadence, {table_kind} "
                  f"table{mb_tag}, batch={batch})",
        "value": round(rate, 1),
        "unit": "solves/s",
        "vs_baseline": round(rate / TARGET, 4),
        "band_min": round(band[0], 1),
        "band_max": round(band[1], 1),
        "runs": runs,
        "flops_per_solve": round(flops_analytic, 1),
        "flops_per_solve_xla": round(flops_xla, 1),
        "achieved_tflops": round(rate * flops_analytic / 1e12, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
