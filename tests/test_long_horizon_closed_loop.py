"""H=16 MPC in the closed loop — the 0.48 s-lookahead configuration
actually trots.

long_horizon_config (control/mpc.py) is solver-gated by the internal-
oracle cadence tests (tests/test_golden_parity.py::test_long_horizon_*);
this test validates the other half of the alpha=1e-4 regularizer
decision: control QUALITY. The H=16 move-blocked controller must run the
same closed-loop trot the H=10 production config runs, with comparable
height band and velocity tracking — demonstrating that the regularizer
shift (which moves individual converged forces by up to ~20% m*g among
near-cost-equivalent force schedules) does not degrade the realized
motion, which is what the force schedule exists for.
"""

import jax
import numpy as np

from quadruped_jax.control import swing
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.mpc import MpcConfig, long_horizon_config
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.robots import a1_params
from quadruped_jax.sim.rollout import rollout


def run(mpc_cfg, steps=2000):
    config = LocomotionConfig(mpc=mpc_cfg, swing=swing.SwingConfig(),
                              gait=ADVANCED_TROT())
    res = jax.jit(lambda: rollout(config, a1_params(),
                                  TwistCommand.constant(vx=0.3),
                                  steps=steps))()
    h = np.asarray(res.base_height_trace)
    v = np.asarray(res.vel_trace)[:, 0]
    return float(res.alive), h, v


def test_h16_trot_matches_h10():
    alive16, h16, v16 = run(long_horizon_config(qp_cold_iters=400))
    assert alive16 == 1.0
    alive10, h10, v10 = run(MpcConfig(horizon=10, qp_cold_iters=400))
    assert alive10 == 1.0

    tail = slice(1200, 2000)
    # Both configs hold the same trot: height bands overlap within 2 cm,
    # velocity tracking within 0.08 m/s of each other.
    assert np.isfinite(h16).all()
    assert abs(h16[tail].mean() - h10[tail].mean()) < 0.02, (
        h16[tail].mean(), h10[tail].mean())
    assert abs(v16[tail].mean() - v10[tail].mean()) < 0.08, (
        v16[tail].mean(), v10[tail].mean())
    assert h16[tail].min() > 0.2


def test_h16_preview_transition_beats_h10():
    """The capability payoff of the 0.48 s horizon (VERDICT r4 item 3):
    with a SCHEDULED full stop fed through the command-preview channel
    (mpc._desired_trajectory v_preview), H=16 previews 0.48 s of the
    schedule vs H=10's 0.30 s and brakes anticipatorily — measured
    (benchmarks/exp_h16_preview.py, SRB closed loop, cruise 0.5 m/s then
    stop): overshoot past the scheduled stop 0.030 m vs 0.072 m (2.4x),
    max pitch after the stop 0.184 vs 0.232 rad, min height 0.250 vs
    0.220 m. The gates leave margin on each."""
    import jax.numpy as jnp
    from quadruped_jax.control.desired_state import TwistCommand
    from quadruped_jax.control.locomotion import (locomotion_init,
                                                  locomotion_step,
                                                  stance_contact_mask)
    from quadruped_jax.sim import srb_sim

    DT, V, T_STOP, T_END = 0.002, 0.5, 4.0, 6.0
    params = a1_params()

    def profile(t):
        return jnp.where(t < T_STOP, V, 0.0)

    def run_preview(mpc_cfg):
        config = LocomotionConfig(mpc=mpc_cfg, swing=swing.SwingConfig(),
                                  gait=ADVANCED_TROT())
        h, dtm = mpc_cfg.horizon, mpc_cfg.dt_mpc
        sim0 = srb_sim.srb_sim_init(params)
        obs0 = srb_sim.observe(params, sim0, jnp.ones(4, jnp.float32))
        ctrl0 = locomotion_init(config, params, obs0)
        steps = int(T_END / DT)

        def step(carry, i):
            sim, ctrl = carry
            t = (i + 1).astype(jnp.float32) * DT
            contact = stance_contact_mask(ctrl.gait)
            obs = srb_sim.observe(params, sim, contact)
            cmd = TwistCommand.constant(body_height=0.27).replace(
                linear=jnp.stack([profile(t), jnp.zeros(()),
                                  jnp.zeros(())]))
            vp = profile(t + jnp.arange(h, dtype=jnp.float32) * dtm)
            command, forces, ctrl = locomotion_step(
                config, params, ctrl, obs, cmd, t, v_preview=vp)
            stance = stance_contact_mask(ctrl.gait)
            swing_mask = 1.0 - jnp.repeat(stance, 3)
            sim = srb_sim.srb_sim_step(params, sim, forces, stance,
                                       command.q, command.dq, swing_mask,
                                       DT)
            return (sim, ctrl), (sim.position[0], sim.position[2])

        (_, _), (xs, hs) = jax.jit(lambda: jax.lax.scan(
            step, (sim0, ctrl0), jnp.arange(steps)))()
        xs, hs = np.asarray(xs), np.asarray(hs)
        i_stop = int(T_STOP / DT)
        return xs[-1] - xs[i_stop], hs[i_stop:].min(), hs

    over10, hmin10, h10 = run_preview(MpcConfig(horizon=10,
                                                qp_cold_iters=400))
    over16, hmin16, h16 = run_preview(long_horizon_config(
        qp_cold_iters=400))
    assert np.isfinite(h10).all() and np.isfinite(h16).all()
    assert hmin10 > 0.15 and hmin16 > 0.15
    # The longer horizon stops with LESS overshoot — strictly better on
    # the behavior metric, not just matching (gate 0.75 vs measured 0.41).
    assert over16 < 0.75 * over10, (over16, over10)
    assert hmin16 > hmin10 - 0.01, (hmin16, hmin10)


def test_height_preview_crouch():
    """The height half of the preview channel (z_preview): a scheduled
    crouch (0.27 -> 0.22 m between 2.5 and 4.0 s, a duck-under-obstacle
    route plan) tracks closed-loop on the SRB sim to ~2 cm during the
    ramps and to ~mm at the crouch plateau."""
    import jax.numpy as jnp
    from quadruped_jax.control.desired_state import TwistCommand
    from quadruped_jax.control.locomotion import (locomotion_init,
                                                  locomotion_step,
                                                  stance_contact_mask)
    from quadruped_jax.sim import srb_sim

    DT = 0.002
    params = a1_params()
    cfg = MpcConfig(horizon=10, qp_cold_iters=400)
    config = LocomotionConfig(mpc=cfg, swing=swing.SwingConfig(),
                              gait=ADVANCED_TROT())

    def zsched(t):
        ramp = jnp.clip((t - 2.5) / 0.3, 0.0, 1.0) \
            * jnp.clip((4.0 - t) / 0.3, 0.0, 1.0)
        return 0.27 - 0.05 * jnp.clip(ramp, 0.0, 1.0)

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4, jnp.float32))
    ctrl0 = locomotion_init(config, params, obs0)
    steps = int(6.0 / DT)

    def step(carry, i):
        sim, ctrl = carry
        t = (i + 1).astype(jnp.float32) * DT
        contact = stance_contact_mask(ctrl.gait)
        obs = srb_sim.observe(params, sim, contact)
        cmd = TwistCommand.constant(vx=0.2, body_height=0.27).replace(
            body_height=zsched(t))
        zp = zsched(t + jnp.arange(10, dtype=jnp.float32) * cfg.dt_mpc)
        command, forces, ctrl = locomotion_step(config, params, ctrl, obs,
                                                cmd, t, z_preview=zp)
        stance = stance_contact_mask(ctrl.gait)
        swing_mask = 1.0 - jnp.repeat(stance, 3)
        sim = srb_sim.srb_sim_step(params, sim, forces, stance, command.q,
                                   command.dq, swing_mask, DT)
        return (sim, ctrl), sim.position[2]

    (_, _), hs = jax.jit(lambda: jax.lax.scan(
        step, (sim0, ctrl0), jnp.arange(steps)))()
    hs = np.asarray(hs)
    t = np.arange(steps) * DT
    zs = 0.27 - 0.05 * np.clip((t - 2.5) / 0.3, 0, 1) \
        * np.clip((4.0 - t) / 0.3, 0, 1)
    assert np.isfinite(hs).all()
    # Plateau of the crouch (3.2-3.6 s, past the ramp-settle transient):
    # MEAN height within 1 cm of the 0.22 target (the trot bobs ~1.5 cm
    # peak around the mean — that is gait, not tracking error), every
    # sample within 2.5 cm.
    plat = slice(int(3.2 / DT), int(3.6 / DT))
    assert abs(hs[plat].mean() - 0.22) < 0.01, hs[plat].mean()
    assert np.abs(hs[plat] - 0.22).max() < 0.025
    # Whole schedule after settle: within 3 cm (measured max 2.4 cm at
    # the ramp transients).
    late = slice(int(1.5 / DT), steps)
    assert np.abs(hs[late] - zs[late]).max() < 0.03
