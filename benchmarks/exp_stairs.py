"""Stair-climbing closed loop: walk stack + stair foothold coordination
on the 18-DoF whole-body sim.

Iteration harness behind tests/test_stair_climb.py (VERDICT r3 #8): climb
one ~8 cm step using planner/foot_stepper.stair_foothold_adjust as the
walk path's foothold hook, terrain.stairs as the ground truth.

Run:  python benchmarks/exp_stairs.py [seconds] [step_height]
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
from quadruped_jax.gait.scheduler import LegState, _config
from quadruped_jax.gait.walk import SubLegState
from quadruped_jax.planner import foot_stepper
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import terrain, whole_body as wb

DT = 0.002


def walk_gait(stance=3.7):
    cfg = _config(stance, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1)
    return cfg


def run(seconds=16.0, step_height=0.08, start_x=0.25, vx=0.03,
        delta=0.1):
    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    # terrain.stairs raises the ground at start_x + k*step_length for
    # k >= 1, so a SINGLE step up at `start_x` needs the origin shifted
    # one tread back (tread depth 5 m = effectively one step).
    terr = terrain.stairs(step_length=5.0, step_height=step_height,
                          start_x=start_x - 5.0)
    stair = foot_stepper.StairParams(
        start_x=jnp.asarray(start_x), width=jnp.asarray(5.0),
        height=jnp.asarray(step_height), count=jnp.asarray(1))

    def adjust(target, feet):
        x_adj, _ = foot_stepper.stair_foothold_adjust(
            feet[:, 0], stair, default_delta=delta)
        return target.at[:, 0].set(x_adj)

    config = WalkConfig(
        gait=walk_gait(),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=300))
    cmd = TwistCommand.constant(vx=float(vx), body_height=0.27)

    sim0 = wb.whole_body_init(params)
    obs0 = wb.observe(params, model, sim0, cm, terrain_height=terr)
    st0 = walk_init(config, params, obs0)
    steps = int(seconds / DT)

    def step(carry, i):
        sim, st = carry
        support = (st.gait.leg_sub_state != SubLegState.TRUE_SWING).astype(
            jnp.float32)
        obs = wb.observe(params, model, sim, cm, terrain_height=terr)
        command, forces, st = walk_step(
            config, params, st, obs, cmd,
            (i + 1).astype(jnp.float32) * DT,
            terrain_height=terr, foothold_adjust_fn=adjust)
        sim, _ = wb.whole_body_step(params, model, sim, command, cm, DT,
                                    terrain_height=terr)
        feet_x = st.foot_target_world[:, 0]
        from quadruped_jax.core import se3
        from quadruped_jax.robots import kinematics
        r = se3.quat_to_rotmat(obs.base_quat)
        fw = jnp.einsum("ij,lj->li", r, kinematics
                        .foot_positions_in_base_frame(
                            params, obs.joint_angles)) + obs.base_position
        return (sim, st), (sim.fb.position[0], sim.fb.position[2],
                           obs.base_rpy[1], feet_x, fw[:, 0], fw[:, 2])

    _, (xs, hs, pitch, ftx, fwx, fwz) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    return (np.asarray(xs), np.asarray(hs), np.asarray(pitch),
            np.asarray(ftx), np.asarray(fwx), np.asarray(fwz))


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 16.0
    h_step = float(sys.argv[2]) if len(sys.argv) > 2 else 0.08
    xs, hs, pitch, ftx, fwx, fwz = run(seconds, h_step)
    n = len(xs)
    for frac in (0.25, 0.5, 0.75, 1.0):
        i = int(n * frac) - 1
        print(f"t={frac * seconds:5.1f}s x={xs[i]:+.3f} z={hs[i]:.3f} "
              f"pitch={pitch[i]:+.3f} targets_x="
              + " ".join(f"{v:+.2f}" for v in ftx[i])
              + " feet_x=" + " ".join(f"{v:+.2f}" for v in fwx[i])
              + " feet_z=" + " ".join(f"{v:+.2f}" for v in fwz[i]))
    print("finite:", np.isfinite(hs).all(),
          " min z:", hs.min(), " max |pitch|:", np.abs(pitch).max())


if __name__ == "__main__":
    main()
