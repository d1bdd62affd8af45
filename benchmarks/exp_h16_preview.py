"""Does the 0.48 s H=16 horizon BEAT H=10 when it can see the future?

VERDICT r4 item 3: H=16 was a perf trophy whose only closed-loop test
asserts it MATCHES H=10. This experiment gives the longer horizon
something to look at: a scheduled speed profile (known in advance — a
route plan) fed through the new command-preview channel
(mpc._desired_trajectory v_preview). H=16 previews 0.48 s of the
schedule, H=10 only 0.30 s; at sharp transitions the extra 0.18 s is the
difference between anticipatory and reactive braking/acceleration.

Scenario (SRB closed loop, ADVANCED_TROT): cruise 0.5 m/s, then a
scheduled FULL STOP at t_s. Metrics around the transition: position
overshoot past the scheduled stop distance, velocity-tracking ITAE in
the transition window, pitch excursion.

Run: python benchmarks/exp_h16_preview.py
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

from quadruped_jax.control import swing
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.locomotion import (LocomotionConfig,
                                              locomotion_init,
                                              locomotion_step,
                                              stance_contact_mask)
from quadruped_jax.control.mpc import MpcConfig, long_horizon_config
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import srb_sim

DT = 0.002
V_CRUISE = 0.5
T_STOP = 4.0
T_END = 6.0


def profile(t):
    """Scheduled forward speed: cruise, then full stop at T_STOP."""
    return jnp.where(t < T_STOP, V_CRUISE, 0.0)


def run(mpc_cfg, use_preview):
    params = a1_params()
    config = LocomotionConfig(mpc=mpc_cfg, swing=swing.SwingConfig(),
                              gait=ADVANCED_TROT())
    h = mpc_cfg.horizon
    dtm = mpc_cfg.dt_mpc

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4, jnp.float32))
    ctrl0 = locomotion_init(config, params, obs0)
    steps = int(T_END / DT)

    def step(carry, i):
        sim, ctrl = carry
        t = (i + 1).astype(jnp.float32) * DT
        contact = stance_contact_mask(ctrl.gait)
        obs = srb_sim.observe(params, sim, contact)
        vx_t = profile(t)
        cmd = TwistCommand.constant(body_height=0.27)
        cmd = cmd.replace(linear=jnp.stack(
            [vx_t, jnp.zeros(()), jnp.zeros(())]))
        vp = (profile(t + jnp.arange(h, dtype=jnp.float32) * dtm)
              if use_preview else None)
        command, forces, ctrl = locomotion_step(config, params, ctrl, obs,
                                                cmd, t, v_preview=vp)
        stance = stance_contact_mask(ctrl.gait)
        swing_mask = 1.0 - jnp.repeat(stance, 3)
        sim = srb_sim.srb_sim_step(params, sim, forces, stance,
                                   command.q, command.dq, swing_mask, DT)
        from quadruped_jax.core import se3
        pitch = se3.quat_to_rpy(sim.quat)[1]
        return (sim, ctrl), (sim.position[0], sim.position[2],
                             sim.vel_world[0], pitch)

    (_, _), (xs, hs, vxs, pitch) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, ctrl0), jnp.arange(steps)))()
    return (np.asarray(xs), np.asarray(hs), np.asarray(vxs),
            np.asarray(pitch))


def metrics(xs, hs, vxs, pitch):
    n = len(xs)
    i_stop = int(T_STOP / DT)
    # Scheduled stop position: where the robot is at T_STOP (the schedule
    # says v=0 from there on) — overshoot is distance travelled after.
    overshoot = xs[-1] - xs[i_stop]
    win = slice(int((T_STOP - 0.6) / DT), n)
    t = np.arange(n) * DT
    v_ref = np.where(t < T_STOP, V_CRUISE, 0.0)
    itae = np.trapezoid(np.abs(vxs[win] - v_ref[win]), dx=DT)
    return {
        "overshoot_m": float(overshoot),
        "itae_vel": float(itae),
        "pitch_max_after": float(np.abs(pitch[i_stop:]).max()),
        "h_min_after": float(hs[i_stop:].min()),
        "v_end": float(np.abs(vxs[-int(0.5 / DT):]).max()),
    }


def main():
    cfgs = {
        "H=10": MpcConfig(horizon=10, qp_cold_iters=400),
        "H=16": long_horizon_config(qp_cold_iters=400),
    }
    for name, cfg in cfgs.items():
        for prev in (False, True):
            xs, hs, vxs, pitch = run(cfg, prev)
            m = metrics(xs, hs, vxs, pitch)
            tag = f"{name} preview={int(prev)}"
            print(f"{tag}: " + " ".join(f"{k}={v:.4f}"
                                        for k, v in m.items()))


if __name__ == "__main__":
    main()
