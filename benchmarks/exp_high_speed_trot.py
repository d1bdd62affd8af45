"""High-speed trot envelope probe on the 18-DoF whole-body sim.

The reference clips trot velocity commands to vx in [-1, 2] m/s
(qr_mpc_stance_leg_controller.cpp:178-179); round 3 demonstrated the
closed loop at 0.8 m/s ad hoc but CI never commands >= 1 m/s. This sweep
runs the advanced-trot MPC stack closed-loop on the whole-body sim across
forward and backward commands and reports aliveness, height band, and
achieved velocity — the measurement behind the round-4 high-speed CI
tests (tests/test_high_speed_trot.py).

Run:  python benchmarks/exp_high_speed_trot.py [seconds]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc, swing
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step)
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import whole_body as wb

DT = 0.002


def run_trot(vx, seconds=5.0, swing_cfg=None, gait_cfg=None,
             mpc_kw=None):
    params = a1_params()
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120,
                          **(mpc_kw or {})),
        swing=swing_cfg or swing.SwingConfig(),
        gait=gait_cfg or ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=float(vx), body_height=0.27)
    steps = int(seconds / DT)

    model = fb.build_model(params)
    cm = wb.ContactModel()
    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm)
    ctrl0 = locomotion_init(config, params, obs0)

    def step(carry, i):
        sim, ctrl = carry
        obs = wb.observe(params, model, sim, cm)
        t = (i + 1).astype(jnp.float32) * DT
        command, forces, ctrl = locomotion_step(config, params, ctrl, obs,
                                                cmd, t)
        sim, _ = wb.whole_body_step(params, model, sim, command, cm, DT)
        return (sim, ctrl), (sim.fb.position[2], sim.fb.position[0],
                             obs.base_vel_world[0], obs.base_rpy[1])

    (_, _), (h, x, vxs, pitch) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, ctrl0), jnp.arange(steps)))()
    return (np.asarray(h), np.asarray(x), np.asarray(vxs),
            np.asarray(pitch))


def report(tag, h, x, vxs, pitch, vx_cmd, seconds):
    n = len(h)
    tail = slice(int(n * 0.6), n)
    alive = bool(np.isfinite(h).all() and (h[tail] > 0.12).all()
                 and (np.abs(pitch) < 0.6).all())
    print(f"  {tag}: alive={alive} h_tail=[{h[tail].min():.3f},"
          f"{h[tail].max():.3f}] vx_tail={vxs[tail].mean():+.3f}"
          f" (cmd {vx_cmd:+.2f}) x_final={x[-1]:+.2f}"
          f" |pitch|max={np.abs(pitch).max():.3f}")
    return alive


def main():
    from quadruped_jax.gait import TROT
    from quadruped_jax.gait.scheduler import _config

    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    if which in ("all", "advanced"):
        print(f"=== whole-body advanced trot (cycle 0.833 s), {seconds:.0f} s")
        # Stride analysis: with the reference's +/-0.2 m foothold clip and
        # the 0.833 s advanced-trot cycle, the kinematic ceiling is
        # ~0.2 * 2 / (0.5 s stance) = 0.8 m/s before workspace margin —
        # this sweep measures the actual saturation (~0.55 m/s).
        for vx in (0.5, 0.8, 1.0, 1.2, 1.5, -0.5):
            h, x, vxs, pitch = run_trot(vx, seconds)
            report(f"vx {vx:+.1f}", h, x, vxs, pitch, vx, seconds)
    if which in ("all", "fast"):
        print(f"=== whole-body fast trot (reference 'trot' gait, stance "
              f"0.3 s, cycle 0.5 s), {seconds:.0f} s")
        for vx in (0.8, 1.0, 1.2, 1.5, -0.5):
            h, x, vxs, pitch = run_trot(vx, seconds, gait_cfg=TROT())
            report(f"vx {vx:+.1f}", h, x, vxs, pitch, vx, seconds)
    if which in ("all", "faster"):
        print(f"=== whole-body faster trot (stance 0.24 s, duty 0.6, "
              f"cycle 0.4 s), {seconds:.0f} s")
        fast = _config(0.24, 0.6, [0.5, 0.0, 0.0, 0.5])
        for vx in (1.2, 1.5, 1.8):
            h, x, vxs, pitch = run_trot(vx, seconds, gait_cfg=fast)
            report(f"vx {vx:+.1f}", h, x, vxs, pitch, vx, seconds)
    if which in ("all", "clip"):
        # Round-5 envelope closure (VERDICT r4 item 4): the saturation law
        # speed ~ 2*clip/cycle says the reference's 0.2 m clip, not the
        # controller, caps tracking at ~70% of a 1.5 m/s command on the
        # 0.4 s FAST_TROT. Raise SwingConfig.foothold_clip past the
        # reference default and measure the demonstrated envelope, both
        # directions.
        from quadruped_jax.gait import FAST_TROT
        print(f"=== FAST_TROT (0.4 s cycle) x foothold_clip sweep, "
              f"{seconds:.0f} s")
        for clip in (0.2, 0.3, 0.4):
            scfg = swing.SwingConfig(
                foothold_clip=jnp.asarray(clip, jnp.float32))
            for vx in (1.2, 1.5, 1.8, 2.0, -0.8, -1.0):
                h, x, vxs, pitch = run_trot(vx, seconds,
                                            gait_cfg=FAST_TROT(),
                                            swing_cfg=scfg)
                report(f"clip {clip:.1f} vx {vx:+.1f}", h, x, vxs, pitch,
                       vx, seconds)
        print(f"=== standard TROT (0.5 s cycle) backward, clip sweep")
        from quadruped_jax.gait import TROT as _T
        for clip in (0.2, 0.3):
            scfg = swing.SwingConfig(
                foothold_clip=jnp.asarray(clip, jnp.float32))
            for vx in (-0.8, -1.0):
                h, x, vxs, pitch = run_trot(vx, seconds, gait_cfg=_T(),
                                            swing_cfg=scfg)
                report(f"clip {clip:.1f} vx {vx:+.1f}", h, x, vxs, pitch,
                       vx, seconds)
    if which in ("all", "duty"):
        # Round-5 finding (clip sweep below): the foothold clip NEVER
        # binds — the advanced-trot foothold law target_v *
        # swing_time_remaining collapses toward the hip at touchdown, so
        # the stance-phase leg sweep (workspace ~0.28 m) over the stance
        # time is the real ceiling: v_max ~ 0.28 / t_stance. Measured
        # 1.15 m/s at t_stance 0.24 (= 0.28/0.24). The lever is the duty
        # factor, not the clip: sweep stance time at fixed-ish cycle.
        from quadruped_jax.gait.scheduler import _config as _gc
        print(f"=== stance-time sweep (advanced foothold law), "
              f"{seconds:.0f} s")
        for stance, duty in ((0.24, 0.6), (0.20, 0.5), (0.16, 0.4),
                             (0.15, 0.5), (0.12, 0.4)):
            g = _gc(stance, duty, [0.5, 0.0, 0.0, 0.5])
            cyc = stance / duty
            for vx in (1.5, 1.8, 2.0):
                h, x, vxs, pitch = run_trot(vx, seconds, gait_cfg=g)
                report(f"st{stance:.2f}/cyc{cyc:.2f} vx {vx:+.1f}",
                       h, x, vxs, pitch, vx, seconds)
    if which in ("all", "raibert"):
        # Raibert symmetric foothold (foothold_forward_gain) x stance
        # sweep: land the foot ~v*stance/2 AHEAD of the hip so the stance
        # sweep straddles the hip instead of trailing it — the missing
        # term the duty sweep exposed.
        from quadruped_jax.gait.scheduler import _config as _gc
        print(f"=== Raibert forward-placement sweep, {seconds:.0f} s")
        for gain in (0.3, 0.5):
            for stance, duty in ((0.16, 0.4), (0.15, 0.5), (0.12, 0.4)):
                g = _gc(stance, duty, [0.5, 0.0, 0.0, 0.5])
                scfg = swing.SwingConfig(
                    foothold_clip=jnp.asarray(0.3, jnp.float32),
                    foothold_forward_gain=jnp.asarray(gain, jnp.float32))
                for vx in (1.5, 1.8, 2.0):
                    h, x, vxs, pitch = run_trot(vx, seconds, gait_cfg=g,
                                                swing_cfg=scfg)
                    report(f"g{gain:.1f} st{stance:.2f}/cyc"
                           f"{stance/duty:.2f} vx {vx:+.1f}",
                           h, x, vxs, pitch, vx, seconds)
        print("=== backward with Raibert term (standard + fast trot)")
        from quadruped_jax.gait import TROT as _T, FAST_TROT as _FT
        for gain in (0.3, 0.5):
            scfg = swing.SwingConfig(
                foothold_clip=jnp.asarray(0.3, jnp.float32),
                foothold_forward_gain=jnp.asarray(gain, jnp.float32))
            for gname, g in (("trot", _T()), ("fast", _FT())):
                for vx in (-0.8, -1.0):
                    h, x, vxs, pitch = run_trot(vx, seconds, gait_cfg=g,
                                                swing_cfg=scfg)
                    report(f"g{gain:.1f} {gname} vx {vx:+.1f}", h, x, vxs,
                           pitch, vx, seconds)
    if which in ("all", "raibert2"):
        # Best Raibert config (g0.3, 0.15/0.30 stance/cycle) x MPC
        # velocity-weight sweep, plus the backward envelope push.
        from quadruped_jax.gait.scheduler import _config as _gc
        from quadruped_jax.gait import FAST_TROT as _FT
        g = _gc(0.15, 0.5, [0.5, 0.0, 0.0, 0.5])
        scfg = swing.SwingConfig(
            foothold_clip=jnp.asarray(0.3, jnp.float32),
            foothold_forward_gain=jnp.asarray(0.3, jnp.float32))
        print(f"=== g0.3 st0.15/cyc0.30 x velocity weight, {seconds:.0f} s")
        for wv in (5.0, 10.0, 20.0):
            w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, wv, 5, 1,
                             0.0], jnp.float32)
            for vx in (1.8, 2.0):
                h, x, vxs, pitch = run_trot(
                    vx, seconds, gait_cfg=g, swing_cfg=scfg,
                    mpc_kw=dict(state_weights=w))
                report(f"wv{wv:.0f} vx {vx:+.1f}", h, x, vxs, pitch, vx,
                       seconds)
        print("=== backward push: gain/weight on FAST_TROT")
        for gain in (0.4, 0.5):
            for wv in (5.0, 10.0):
                w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, wv, 5,
                                 1, 0.0], jnp.float32)
                sc = swing.SwingConfig(
                    foothold_clip=jnp.asarray(0.3, jnp.float32),
                    foothold_forward_gain=jnp.asarray(gain, jnp.float32))
                h, x, vxs, pitch = run_trot(
                    -1.0, seconds, gait_cfg=_FT(), swing_cfg=sc,
                    mpc_kw=dict(state_weights=w))
                report(f"g{gain:.1f} wv{wv:.0f} vx -1.0", h, x, vxs,
                       pitch, -1.0, seconds)
    if which in ("all", "weights"):
        print(f"=== fast trot + MPC velocity-weight sweep (cmd 1.2/1.5), "
              f"{seconds:.0f} s")
        for wv in (5.0, 10.0, 20.0):
            w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, wv, 5, 1,
                             0.0], jnp.float32)
            for vx in (1.2, 1.5):
                h, x, vxs, pitch = run_trot(
                    vx, seconds, gait_cfg=TROT(),
                    mpc_kw=dict(state_weights=w))
                report(f"wvx {wv:.0f} vx {vx:+.1f}", h, x, vxs, pitch, vx,
                       seconds)


if __name__ == "__main__":
    main()
