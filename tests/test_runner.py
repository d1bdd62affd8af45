"""Exec-layer test: the composition root on the SRB sim (ground-truth
observation path). The estimator path + whole-body path are covered by
examples/example_whole_body_standup.py and the estimation tests."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.control.fsm import FsmState
from quadruped_jax.exec import RunnerConfig, runner_init, runner_step
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.gait.scheduler import stance_contact_mask
from quadruped_jax.robots import a1_params
from quadruped_jax.sim import srb_sim


def test_runner_standup_then_locomotion_ground_truth():
    params = a1_params()
    config = RunnerConfig(
        locomotion=LocomotionConfig(
            mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
            swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT()))
    cmd = TwistCommand.constant(vx=0.2, body_height=0.27)

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4))
    st0 = runner_init(config, params, obs0)
    # The SRB sim has no posture-derived support forces, so the stand-up
    # ramp cannot be simulated here (the whole-body sim covers it —
    # examples/example_whole_body_standup.py). Start in LOCOMOTION.
    st0 = st0.replace(fsm=st0.fsm.replace(
        state=jnp.asarray(FsmState.LOCOMOTION, jnp.int32)))

    def step(carry, i):
        sim, st = carry
        contact = stance_contact_mask(st.locomotion.gait)
        obs = srb_sim.observe(params, sim, contact)
        command, forces, st, _ = runner_step(config, params, st, cmd,
                                             observation=obs)
        in_loco = (st.fsm.state == FsmState.LOCOMOTION).astype(jnp.float32)
        stance = stance_contact_mask(st.locomotion.gait)
        sim = srb_sim.srb_sim_step(
            params, sim, forces,
            jnp.where(in_loco > 0.5, stance, jnp.ones(4)),
            command.q, command.dq,
            jnp.where(in_loco > 0.5, 1.0 - jnp.repeat(stance, 3),
                      jnp.zeros(12)),
            0.002)
        return (sim, st), (sim.position[2], st.fsm.state)

    (sim, st), (hs, fsms) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(1500)))()
    fsms = np.asarray(fsms)
    h = np.asarray(hs)
    assert np.all(np.isfinite(h))
    assert fsms[-1] == FsmState.LOCOMOTION
    # Trotting stably at the end.
    assert 0.2 < h[-1] < 0.35
    assert float(sim.position[0]) > 0.05  # moved forward
