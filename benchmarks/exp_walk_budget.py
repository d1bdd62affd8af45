"""Walk-stack force-balance QP budget: warm-start at the 1 kHz tick.

VERDICT r4 item 6: the walk mode ran its force-balance QP at
qp_iters=300 (a test convenience) with no warm-start treatment and no
recorded performance. This experiment measures, on the flat-ground
whole-body walk closed loop:

  * the solution quality of (warm_start, qp_iters) configurations
    against the cold-300 reference run — max/mean force deviation and
    realized-motion deviation over the run;
  * from that, the justified production default.

The companion throughput line lives in benchmarks/bench_walk.py.

Run: python benchmarks/exp_walk_budget.py [seconds]
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

from quadruped_jax.control import stance_force_balance as stance_fb
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.walk_locomotion import (WalkConfig, walk_init,
                                                   walk_step)
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.gait.scheduler import _config
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import whole_body as wb

DT = 0.002


def run_walk(qp_iters, warm_start, seconds=8.0):
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    config = WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=qp_iters, warm_start=warm_start))
    cmd = TwistCommand.constant(vx=0.05, body_height=0.27)

    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm)
    st0 = walk_init(config, params, obs0)
    steps = int(seconds / DT)

    def step(carry, i):
        sim, st = carry
        obs = wb.observe(params, model, sim, cm)
        command, forces, st = walk_step(
            config, params, st, obs, cmd,
            (i + 1).astype(jnp.float32) * DT)
        sim, _ = wb.whole_body_step(params, model, sim, command, cm, DT)
        return (sim, st), (sim.fb.position[0], sim.fb.position[2],
                           obs.base_rpy[1], forces)

    (_, _), (xs, hs, pitch, f) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    return (np.asarray(xs), np.asarray(hs), np.asarray(pitch),
            np.asarray(f))


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 8.0
    print("reference: cold qp_iters=300 (the stair-test convenience)")
    x_ref, h_ref, p_ref, f_ref = run_walk(300, False, seconds)
    print(f"  ref: x={x_ref[-1]:+.3f} h=[{h_ref.min():.3f},"
          f"{h_ref.max():.3f}] |pitch|max={np.abs(p_ref).max():.3f}")
    for iters, warm in ((100, False), (100, True), (40, True), (25, True),
                        (40, False)):
        xs, hs, pitch, f = run_walk(iters, warm, seconds)
        df = np.abs(f - f_ref)
        dx = np.abs(xs - x_ref).max()
        dh = np.abs(hs - h_ref).max()
        print(f"  iters={iters:3d} warm={int(warm)}: "
              f"|df|max={df.max():7.3f} N |df|mean={df.mean():6.4f} N "
              f"dx_max={dx:.4f} dh_max={dh:.4f} "
              f"alive={bool(np.isfinite(hs).all() and hs.min() > 0.2)}")


if __name__ == "__main__":
    main()
