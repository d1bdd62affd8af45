"""Chip smoke test: the main path on one GPU, checked against the CPU.

    python chip_smoke.py                # one GPU, phases (a)-(d)
    python chip_smoke.py --four-cards   # four GPUs: the sharded sweep only

Phases, each through the entry points a user calls, at production width:

  (a) mpc         the full MPC update (bench.build_bench: A1, H=10,
                  MpcConfig defaults, trot table, B=32768 in chunks of
                  256), plus its stages timed as separately jitted
                  programs at the same shapes: problem build + setup, the
                  Newton-Schulz inverse (at each candidate polish
                  precision, with its residual max|I - M X|) and the ADMM
                  loop.
  (b) sweep       sim.rollout_cadenced vmapped over 4096 A1 advanced-trot
                  scenarios, vx spread over [0, 0.6] m/s, 1 s at a 2 ms
                  tick with the 15 ms MPC cadence.
  (c) whole_body  benchmarks/bench_whole_body.build: 18-DoF Featherstone
                  + contact + MPC trot, 256 scenarios x 500 ticks.
  (d) entry       __graft_entry__.entry(), jitted.

The reference for every parity check is the same JAX program on this
process's CPU backend (f32, the package's float32 default matmul
precision): an oracle, not a fallback. Each phase prints one line with
its compile seconds, steady-state wall seconds and parity numbers; each
tolerance is stated beside its check below.

Exits non-zero, printing no result, when JAX's first device is not a GPU
or any phase or check fails. Otherwise the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import bench
from quadruped_jax.utils import compile_cache

DT = 0.002             # control tick (s)
SIM_SECONDS = 1.0      # phase (b) simulated time
G = 9.81

# (a) Forces of the first 256 problems, card against CPU: <= 1% of m*g.
# A third of the 3% m*g golden-parity budget: the warm 24-iteration
# truncation error is the same on both sides; only rounding order and the
# polish precision (cone_qp.POLISH_PRECISION) differ.
TOL_FORCE_MG = 0.01
# Newton-Schulz residual max|I - M X| (f64 on the host) of the polished
# inverse on the first 256 problems: <= 1e-4, the inverse accuracy the
# solve's 3% m*g budget was set with. Exact f32 (the CPU oracle, same M,
# cone_qp.NS_F32_POLISH steps) reaches ~1.6e-5 here; it is printed beside.
TOL_NS_RESID = 1e-4
# (b) 64 scenarios, card against CPU, after 1 s of closed loop: final base
# position within 1 cm and velocity within 0.02 m/s — the same program and
# the same gait clock on both sides, so only rounding differs, and 1 cm /
# 0.02 m/s is far below what a changed controller decision would move.
TOL_POS_M = 0.01
TOL_VEL_MS = 0.02
# (b) health over all scenarios (a healthy trot): alive,
# final height 0.27 +/- 0.02 m, and mean vx over the last 0.5 s near the
# command. The controller's velocity rise time under the command filters
# is ~0.5 s, so at 1 s the last-0.5 s mean lags the command by up to ~24%
# of it on the CPU reference itself (0.457 m/s at a 0.6 m/s command): the
# bound is 0.1 m/s plus 15% of the command.
HEIGHT = (0.25, 0.29)
TOL_VX_ABS, TOL_VX_REL = 0.1, 0.15
# (c) alive = base height above 0.15 m after 500 ticks.
ALIVE_Z = 0.15

# Newton-Schulz polish precisions measured in phase (a). On the GPU, HIGH
# is one TF32 pass, HIGHEST a true f32 dot, BF16_BF16_F32_X3 three bf16
# passes.
PRECISIONS = {
    "HIGH": jax.lax.Precision.HIGH,
    "BF16_X3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "HIGHEST": jax.lax.Precision.HIGHEST,
}


def _say(tag: str, **fields) -> None:
    """One result line: `tag k=v k=v ...` (floats unrounded)."""
    print(tag + " " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _timed(fn, args, reps: int = 3):
    """(output, compile s, median steady wall s) of a jitted fn."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        walls.append(time.perf_counter() - t0)
    return out, compile_s, float(np.median(walls))


def _cpu():
    return jax.devices("cpu")[0]


def max_abs_diff(a, b) -> float:
    """The parity comparator: max |a - b| over all entries, inf if either
    is non-finite (every check is `max_abs_diff(...) <= tolerance`)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
        return math.inf
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def ns_residual(m, m_inv) -> np.ndarray:
    """Per-problem max|I - M X| of [..., n, n] inverses, in f64."""
    m = np.asarray(m, np.float64)
    r = np.eye(m.shape[-1]) - m @ np.asarray(m_inv, np.float64)
    return np.max(np.abs(r), axis=(-2, -1))


def _mass_g() -> float:
    from quadruped_jax.robots import a1_params

    return float(a1_params().total_mass) * G


# --------------------------------------------------------------------------
# (a) the MPC update
# --------------------------------------------------------------------------

def phase_mpc(batch: int = 32768, chunk: int = 256, n_ref: int = 256,
              reps: int = 3) -> dict:
    from quadruped_jax.robots import a1_params
    from quadruped_jax.solvers import cone_qp

    n_ref = min(n_ref, batch)
    production = dict(horizon=10, chunk=chunk, minv_reuse=False,
                      ns_f32_polish=cone_qp.NS_F32_POLISH)
    t0 = time.perf_counter()
    fn, args, cfg = bench.build_bench(batch, "trot", **production)
    setup_s = time.perf_counter() - t0
    (x, _), compile_s, wall_s = _timed(fn, args, reps)

    # Oracle: the same program for the first n_ref problems on the CPU
    # (bench.make_states draws prefix-stable scenarios).
    with jax.default_device(_cpu()):
        fn_c, args_c, _ = bench.build_bench(n_ref, "trot", **production)
        x_ref = np.asarray(fn_c(*args_c)[0])
    mg = _mass_g()
    df = max_abs_diff(np.asarray(x)[:n_ref], x_ref)
    ok = bool(np.all(np.isfinite(np.asarray(x)))) and df <= TOL_FORCE_MG * mg
    res = dict(compile_s=compile_s, wall_s=wall_s, setup_s=setup_s,
               solves_per_s=batch / wall_s, max_df_N=df, max_df_mg=df / mg,
               tol_mg=TOL_FORCE_MG)

    # Stages at the same shapes, each its own jitted program.
    params = a1_params()
    rpy, feet, x0, contact, x_warm, y_warm = args[:6]

    def st_setup(rpy, feet, x0, contact):
        prob = bench.mpc_problem(cfg, params, rpy, feet, x0, contact)
        return prob.p, prob.q, prob.fz_hi, cone_qp.setup(prob).m

    def st_ns(m, precision):
        return cone_qp.newton_schulz_inverse(m, precision=precision)

    def st_admm(p, q, fz_hi, m_inv, x_warm, y_warm):
        prob = cone_qp.ConeQP(p=p, q=q, mu=jnp.asarray(0.45, jnp.float32),
                              fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)
        # setup's M is unused here, so XLA drops its assembly.
        return cone_qp.admm(prob, cone_qp.setup(prob), m_inv,
                            iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                            accel_restart=cfg.qp_accel_restart,
                            x0=x_warm, y0=y_warm).x

    (p, q, fz_hi, m), res["stage_setup_compile_s"], res["stage_setup_s"] = \
        _timed(bench.chunked(st_setup, batch, chunk),
               (rpy, feet, x0, contact), reps)
    admm_fn = bench.chunked(st_admm, batch, chunk)
    m_ref = np.asarray(m[:n_ref], np.float64)
    with jax.default_device(_cpu()):
        resid_f32 = ns_residual(m_ref, cone_qp.newton_schulz_inverse(
            jnp.asarray(m_ref, jnp.float32)))
    n = m.shape[-1]
    minv_bytes = batch * n * n * 4
    ns_flops = cone_qp.NS_ITERS * 2 * 2 * n ** 3 * batch
    admm_walls = {}
    for name, prec in PRECISIONS.items():
        m_inv, c_s, ns_s = _timed(
            bench.chunked(partial(st_ns, precision=prec), batch, chunk),
            (m,), reps)
        resid = ns_residual(m_ref, m_inv[:n_ref])
        x_p, c_a, admm_s = _timed(admm_fn, (p, q, fz_hi, m_inv, x_warm,
                                            y_warm), reps)
        df_p = max_abs_diff(np.asarray(x_p)[:n_ref], x_ref)
        admm_walls[name] = admm_s
        res[f"ns_{name}"] = dict(
            compile_s=c_s, wall_s=ns_s, tflops=ns_flops / ns_s / 1e12,
            resid_max=float(resid.max()),
            resid_median=float(np.median(resid)),
            admm_wall_s=admm_s, max_df_N=df_p, max_df_mg=df_p / mg)
        del m_inv
    chosen = [k for k, v in PRECISIONS.items()
              if v == cone_qp.POLISH_PRECISION][0]
    res["polish_precision"] = chosen
    res["stage_ns_s"] = res[f"ns_{chosen}"]["wall_s"]
    res["stage_admm_s"] = admm_walls[chosen]
    res["stage_admm_compile_s"] = c_a
    # M^-1 is read once per ADMM iteration: the loop's memory floor.
    res["minv_bytes"] = minv_bytes
    res["admm_minv_GBps"] = (cfg.qp_iters * minv_bytes
                             / admm_walls[chosen] / 1e9)
    res["ns_resid_max"] = res[f"ns_{chosen}"]["resid_max"]
    res["ns_resid_max_f32_cpu"] = float(resid_f32.max())
    res["tol_ns_resid"] = TOL_NS_RESID
    res["ok"] = ok and res["ns_resid_max"] <= TOL_NS_RESID
    return res


# --------------------------------------------------------------------------
# (b) the closed-loop scenario sweep
# --------------------------------------------------------------------------

def _sweep_rollout(n_periods: int):
    """vmappable vx -> (alive, final pos, final vel, vx per period,
    final MPC forces) of one cadenced A1 advanced-trot rollout."""
    from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
    from quadruped_jax.control.desired_state import TwistCommand
    from quadruped_jax.control.locomotion import LocomotionConfig
    from quadruped_jax.gait import ADVANCED_TROT
    from quadruped_jax.robots import a1_params
    from quadruped_jax.sim.rollout_cadenced import rollout_cadenced

    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT())
    params = a1_params()

    def one(vx):
        r = rollout_cadenced(config, params, TwistCommand.constant(vx=vx),
                             n_periods=n_periods, control_dt=DT)
        return (r.alive, r.sim.position, r.sim.vel_world,
                r.vel_trace[:, 0], r.forces)

    return one, config.mpc.ticks_per_solve


def sweep_periods(seconds: float = SIM_SECONDS) -> int:
    from quadruped_jax.control.mpc import MpcConfig

    return math.ceil(seconds / (MpcConfig().ticks_per_solve * DT))


def sweep_health(vx, alive, pos, vel_trace, ticks_per_solve: int) -> dict:
    """Health of a sweep (see HEIGHT / TOL_VX_* above)."""
    vx = np.asarray(vx)
    last = max(1, round(0.5 / (ticks_per_solve * DT)))
    mean_vx = np.asarray(vel_trace)[:, -last:].mean(axis=1)
    vx_err = np.abs(mean_vx - vx) - (TOL_VX_ABS + TOL_VX_REL * np.abs(vx))
    z = np.asarray(pos)[:, 2]
    return dict(alive_frac=float(np.mean(alive)), z_min=float(z.min()),
                z_max=float(z.max()), vx_excess_max=float(vx_err.max()),
                healthy=bool(np.all(np.asarray(alive) == 1.0)
                             and HEIGHT[0] <= z.min() and z.max() <= HEIGHT[1]
                             and vx_err.max() <= 0.0))


def phase_sweep(n: int = 4096, n_periods: int | None = None,
                n_ref: int = 64, reps: int = 2) -> dict:
    n_periods = sweep_periods() if n_periods is None else n_periods
    one, tps = _sweep_rollout(n_periods)
    vx = np.linspace(0.0, 0.6, n).astype(np.float32)
    fn = jax.jit(jax.vmap(one))
    (alive, pos, vel, vtrace, _), compile_s, wall_s = _timed(
        fn, (jnp.asarray(vx),), reps)

    idx = np.linspace(0, n - 1, min(n_ref, n)).astype(int)
    with jax.default_device(_cpu()):
        _, pos_c, vel_c, _, _ = jax.jit(jax.vmap(one))(vx[idx])
        pos_c, vel_c = np.asarray(pos_c), np.asarray(vel_c)
    dpos = max_abs_diff(np.asarray(pos)[idx], pos_c)
    dvel = max_abs_diff(np.asarray(vel)[idx], vel_c)
    health = sweep_health(vx, alive, pos, vtrace, tps)
    ticks = n * n_periods * tps
    return dict(compile_s=compile_s, wall_s=wall_s,
                ticks_per_s=ticks / wall_s, max_dpos_m=dpos,
                max_dvel_ms=dvel, tol_pos_m=TOL_POS_M, tol_vel_ms=TOL_VEL_MS,
                **health,
                ok=dpos <= TOL_POS_M and dvel <= TOL_VEL_MS
                and health["healthy"])


# --------------------------------------------------------------------------
# (c) whole-body fidelity, (d) driver entry
# --------------------------------------------------------------------------

def phase_whole_body(batch: int = 256, reps: int = 2) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    import bench_whole_body

    t0 = time.perf_counter()
    fn, args = bench_whole_body.build(batch)
    setup_s = time.perf_counter() - t0
    pos, compile_s, wall_s = _timed(fn, args, reps)
    pos = np.asarray(pos).reshape(batch, 3)
    alive = float(np.mean(pos[:, 2] > ALIVE_Z))
    return dict(compile_s=compile_s, wall_s=wall_s, setup_s=setup_s,
                ticks_per_s=batch * bench_whole_body.STEPS / wall_s,
                alive_frac=alive, z_min=float(pos[:, 2].min()),
                ok=bool(np.all(np.isfinite(pos))) and alive == 1.0)


def phase_entry(reps: int = 3) -> dict:
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out, compile_s, wall_s = _timed(jax.jit(fn), args, reps)
    finite = all(bool(np.all(np.isfinite(np.asarray(o))))
                 for o in jax.tree.leaves(out))
    return dict(compile_s=compile_s, wall_s=wall_s,
                shapes=[tuple(o.shape) for o in jax.tree.leaves(out)],
                ok=finite)


# --------------------------------------------------------------------------
# four cards: the (b) sweep sharded dp=4
# --------------------------------------------------------------------------

def phase_four_cards(n_per_card: int = 4096, n_periods: int | None = None,
                     n_devices: int = 4, reps: int = 2) -> dict:
    """(b) at n_devices x n_per_card scenarios on a (dp=n_devices, sp=1)
    mesh; the first card's shard is compared with the same scenarios run
    on one card, and the psum'd mean |f| with the host's mean."""
    from quadruped_jax.distributed import make_mesh, shard_batch
    from quadruped_jax.distributed.scaling import sharded_solve_stats

    n_periods = sweep_periods() if n_periods is None else n_periods
    one, tps = _sweep_rollout(n_periods)
    n = n_devices * n_per_card
    mesh = make_mesh(n_devices)
    vx = np.linspace(0.0, 0.6, n).astype(np.float32)
    roll = jax.jit(jax.vmap(one))
    (alive, pos, vel, vtrace, forces), compile_s, wall_s = _timed(
        roll, (shard_batch(mesh, jnp.asarray(vx)),), reps)
    placed = {s.device for s in pos.addressable_shards}
    shard_rows = {s.data.shape[0] for s in pos.addressable_shards}
    _, mean_f = sharded_solve_stats(mesh, lambda f: f)(forces)
    host_mean_f = float(np.mean(np.abs(np.asarray(forces))))

    with jax.default_device(jax.devices()[0]):
        _, pos_1, vel_1, _, f_1 = roll(jnp.asarray(vx[:n_per_card]))
    mg = _mass_g()
    dpos = max_abs_diff(np.asarray(pos)[:n_per_card], pos_1)
    dvel = max_abs_diff(np.asarray(vel)[:n_per_card], vel_1)
    df = max_abs_diff(np.asarray(forces)[:n_per_card], f_1)
    health = sweep_health(vx, alive, pos, vtrace, tps)
    dmean = abs(float(mean_f) - host_mean_f)
    return dict(compile_s=compile_s, wall_s=wall_s,
                ticks_per_s=n * n_periods * tps / wall_s,
                devices_holding_output=len(placed), shard_rows=sorted(
                    shard_rows), max_dpos_m=dpos, max_dvel_ms=dvel,
                max_df_mg=df / mg, psum_mean_f=float(mean_f),
                host_mean_f=host_mean_f, **health,
                ok=len(placed) == n_devices and shard_rows == {n_per_card}
                and dpos <= TOL_POS_M and dvel <= TOL_VEL_MS
                and df <= TOL_FORCE_MG * mg and dmean <= 1e-3 * host_mean_f
                and health["healthy"])


# --------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().replace("\n", " | ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the (b) sweep sharded over 4 GPUs")
    opts = ap.parse_args(argv)

    # The CPU backend is the oracle: keep it next to the GPU's.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's first device is "
              f"{dev.platform} ({dev.device_kind})", file=sys.stderr)
        return 2
    n_cards = 4 if opts.four_cards else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    cache = compile_cache.enable()
    print(f"card: {card_line()}", flush=True)
    _say("jax", version=jax.__version__, device_kind=dev.device_kind,
         devices=len(jax.devices()), compile_cache=cache)

    if opts.four_cards:
        phases = {"four_cards": phase_four_cards}
    else:
        phases = {"mpc": phase_mpc, "sweep": phase_sweep,
                  "whole_body": phase_whole_body, "entry": phase_entry}
    failed = []
    for name, phase in phases.items():
        t0 = time.perf_counter()
        try:
            res = phase()
        except Exception:   # report every phase, then fail the run
            traceback.print_exc()
            _say(f"phase={name}", ok=False, error="exception")
            failed.append(name)
            continue
        nested = {k: res.pop(k) for k in list(res) if isinstance(res[k], dict)}
        _say(f"phase={name}", total_s=time.perf_counter() - t0, **res)
        for k, v in nested.items():
            _say(f"  {name}.{k}", **v)
        if not res["ok"]:
            failed.append(name)
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
