"""RC/joy mode machine (control/rc_mode.py) vs the reference's
qrDesiredStateCommand::{JoyCallback, Update} semantics
(qr_desired_state_command.cpp:66-265) and the RunFSM mode mapping
(qr_control_fsm.cpp:72-94)."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.control.fsm import FsmState
from quadruped_jax.control.rc_mode import (JoyInput, RcMode, rc_init,
                                           rc_update)

H = 0.27


def press(state, **kw):
    joy = JoyInput.neutral(**kw)
    out = rc_update(state, joy, H)
    # release the button next tick (edge detection)
    st2, *_ = rc_update(out[0], JoyInput.neutral(
        vx=kw.get("vx", 0.0), vy=kw.get("vy", 0.0), wz=kw.get("wz", 0.0)),
        H)
    return (st2,) + out[1:]


def test_mode_cycle_and_commands():
    st = rc_init()                       # boots in JOY_STAND
    assert int(st.mode) == RcMode.JOY_STAND

    # X: start locomotion -> ADVANCED_TROT (JOY_STAND cycles there).
    st, cmd, fsm_req, pulse = press(st, btn_gait=1.0, vx=0.4)
    assert int(st.mode) == RcMode.JOY_ADVANCED_TROT
    assert int(fsm_req) == FsmState.LOCOMOTION
    # Sticks pass through in trot modes.
    np.testing.assert_allclose(float(cmd.linear[0]), 0.4)

    # X again while moving: cycle ADVANCED_TROT -> TROT, with a
    # gait-transition pulse (the GAIT_TRANSITION fsmMode).
    st, cmd, fsm_req, pulse = press(st, btn_gait=1.0, vx=0.4)
    assert int(st.mode) == RcMode.JOY_TROT
    assert float(pulse) == 1.0
    assert int(fsm_req) == FsmState.LOCOMOTION

    # X again: TROT -> ADVANCED_TROT (the two-gait cycle).
    st, cmd, fsm_req, pulse = press(st, btn_gait=1.0)
    assert int(st.mode) == RcMode.JOY_ADVANCED_TROT

    # B: stop -> JOY_STAND, sticks zeroed.
    st, cmd, fsm_req, pulse = press(st, btn_stop=1.0, vx=0.4)
    assert int(st.mode) == RcMode.JOY_STAND
    assert float(cmd.linear[0]) == 0.0
    assert int(fsm_req) == FsmState.LOCOMOTION  # MPC standing
    assert float(pulse) == 0.0


def test_body_up_down_exit():
    st = rc_init()
    # Rb while stopped: BODY_UP -> STAND_UP request.
    st, cmd, fsm_req, _ = press(st, btn_updown=1.0)
    assert int(st.mode) == RcMode.BODY_UP
    assert int(fsm_req) == FsmState.STAND_UP
    # Rb again: toggles BODY_DOWN -> SIT_DOWN request.
    st, cmd, fsm_req, _ = press(st, btn_updown=1.0)
    assert int(st.mode) == RcMode.BODY_DOWN
    assert int(fsm_req) == FsmState.SIT_DOWN
    # Y while down: EXIT -> PASSIVE request.
    st, cmd, fsm_req, _ = press(st, btn_exit=1.0)
    assert int(st.mode) == RcMode.EXIT
    assert int(fsm_req) == FsmState.PASSIVE
    # B cannot re-arm from body-down (reference guard bodyUp >= 0);
    # Rb toggles back up instead.
    st, cmd, fsm_req, _ = press(st, btn_stop=1.0)
    assert int(st.mode) == RcMode.EXIT
    st, cmd, fsm_req, _ = press(st, btn_updown=1.0)
    assert int(st.mode) == RcMode.BODY_UP
    assert int(fsm_req) == FsmState.STAND_UP
    # Now B re-arms to neutral -> JOY_STAND.
    st, cmd, fsm_req, _ = press(st, btn_stop=1.0)
    assert int(st.mode) == RcMode.JOY_STAND
    assert int(st.body_up) == 0


def test_exit_blocked_while_up():
    """Y does nothing when body is up (the reference's guard)."""
    st = rc_init()
    st, *_ = press(st, btn_updown=1.0)          # BODY_UP
    st, cmd, fsm_req, _ = press(st, btn_exit=1.0)
    assert int(st.mode) == RcMode.BODY_UP       # unchanged
    assert int(fsm_req) == FsmState.STAND_UP


def test_backward_walk_height_compensation():
    st = rc_init()
    st, cmd, *_ = press(st, btn_gait=1.0, vx=-0.3)
    np.testing.assert_allclose(float(cmd.body_height), H * 0.85, rtol=1e-6)


def test_joy_toggle_gates_sticks():
    st = rc_init()
    st, cmd, *_ = press(st, btn_gait=1.0, vx=0.4)
    np.testing.assert_allclose(float(cmd.linear[0]), 0.4, rtol=1e-6)
    # A: joy off -> sticks ignored.
    st, cmd, *_ = press(st, btn_joy=1.0, vx=0.4)
    assert float(cmd.linear[0]) == 0.0


def test_rc_drives_fsm_sit_down():
    """End-to-end: the RC request channel drives the runner's FSM —
    trot, then BODY_DOWN sits the robot down and EXIT leaves it passive
    (mode sequence -> FSM behavior, VERDICT r2 task 6)."""
    from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
    from quadruped_jax.control.locomotion import LocomotionConfig
    from quadruped_jax.exec import RunnerConfig, runner_init, runner_step
    from quadruped_jax.gait import ADVANCED_TROT
    from quadruped_jax.gait.scheduler import stance_contact_mask
    from quadruped_jax.robots import a1_params
    from quadruped_jax.sim import srb_sim

    params = a1_params()
    config = RunnerConfig(locomotion=LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT()))

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4))
    st0 = runner_init(config, params, obs0)
    st0 = st0.replace(fsm=st0.fsm.replace(
        state=jnp.asarray(FsmState.LOCOMOTION, jnp.int32)))
    rc = rc_init()
    # Start trotting via X.
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(btn_gait=1.0, vx=0.3), H)

    def make_step(joy):
        def step(carry, i):
            sim, st, rc = carry
            rc, cmd, fsm_req, _ = rc_update(rc, joy, H)
            contact = stance_contact_mask(st.locomotion.gait)
            obs = srb_sim.observe(params, sim, contact)
            command, forces, st, _ = runner_step(
                config, params, st, cmd, observation=obs,
                fsm_request=fsm_req)
            in_loco = (st.fsm.state == FsmState.LOCOMOTION)
            stance = stance_contact_mask(st.locomotion.gait)
            sim = srb_sim.srb_sim_step(
                params, sim, forces,
                jnp.where(in_loco, stance, jnp.ones(4)),
                command.q, command.dq,
                jnp.where(in_loco, 1.0 - jnp.repeat(stance, 3),
                          jnp.zeros(12)), 0.002)
            return (sim, st, rc), st.fsm.state
        return step

    run = jax.jit(lambda c, joy, n: jax.lax.scan(make_step(joy), c,
                                                 jnp.arange(n)),
                  static_argnums=2)
    carry = (sim0, st0, rc)
    carry, fsm1 = run(carry, JoyInput.neutral(vx=0.3), 500)
    assert int(carry[1].fsm.state) == FsmState.LOCOMOTION

    # B (stop), then Rb twice -> BODY_DOWN: robot sits.
    rc = carry[2]
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(btn_stop=1.0), H)
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(), H)
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(btn_updown=1.0), H)
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(), H)
    rc, _, req, _ = rc_update(rc, JoyInput.neutral(btn_updown=1.0), H)
    assert int(req) == FsmState.SIT_DOWN
    carry = (carry[0], carry[1], rc)
    carry, fsm2 = run(carry, JoyInput.neutral(), 1600)
    fsm2 = np.asarray(fsm2)
    assert (fsm2 == FsmState.SIT_DOWN).any()
    assert fsm2[-1] == FsmState.PASSIVE   # sit-down completes to passive


def test_rc_gait_pulse_triggers_transition():
    """The RC X-press while trotting emits a gait_switch pulse that the
    locomotion controller's transition engine consumes: trot -> decel ->
    stance-hold -> the second gait table (reference GAIT_TRANSITION
    fsmMode end to end through the runner)."""
    from quadruped_jax.control import mpc as mpc_mod, swing as swing_mod
    from quadruped_jax.control.gait_transition import TransitionPhase
    from quadruped_jax.control.locomotion import LocomotionConfig
    from quadruped_jax.exec import RunnerConfig, runner_init, runner_step
    from quadruped_jax.gait import ADVANCED_TROT, TROT
    from quadruped_jax.gait.scheduler import stance_contact_mask
    from quadruped_jax.robots import a1_params
    from quadruped_jax.sim import srb_sim

    params = a1_params()
    config = RunnerConfig(locomotion=LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(),
        gait_b=TROT()))

    sim0 = srb_sim.srb_sim_init(params)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4))
    st0 = runner_init(config, params, obs0)
    st0 = st0.replace(fsm=st0.fsm.replace(
        state=jnp.asarray(FsmState.LOCOMOTION, jnp.int32)))
    rc = rc_init()
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(btn_gait=1.0, vx=0.25), H)
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(vx=0.25), H)

    def make_step(joy):
        def step(carry, i):
            sim, st, rc = carry
            rc, cmd, fsm_req, _ = rc_update(rc, joy, H)
            contact = stance_contact_mask(st.locomotion.gait)
            obs = srb_sim.observe(params, sim, contact)
            command, forces, st, _ = runner_step(
                config, params, st, cmd, observation=obs,
                fsm_request=fsm_req)
            stance = stance_contact_mask(st.locomotion.gait)
            sim = srb_sim.srb_sim_step(
                params, sim, forces, stance, command.q, command.dq,
                1.0 - jnp.repeat(stance, 3), 0.002)
            return (sim, st, rc), st.locomotion.transition.phase
        return step

    run = jax.jit(lambda c, joy, n: jax.lax.scan(make_step(joy), c,
                                                 jnp.arange(n)),
                  static_argnums=2)
    carry = (sim0, st0, rc)
    # Establish the trot (ADVANCED_TROT active).
    carry, ph1 = run(carry, JoyInput.neutral(vx=0.25), 500)
    assert float(carry[1].locomotion.transition.active_idx) == 0.0
    assert int(np.asarray(ph1)[-1]) == TransitionPhase.NONE

    # X while moving: cycles the RC mode AND pulses gait_switch.
    rc = carry[2]
    rc, cmd, _, pulse = rc_update(rc, JoyInput.neutral(btn_gait=1.0,
                                                       vx=0.25), H)
    assert float(pulse) == 1.0
    # Feed the pulse tick through the runner once, then continue.
    sim, st, _ = carry
    contact = stance_contact_mask(st.locomotion.gait)
    obs = srb_sim.observe(params, sim, contact)
    _, forces, st, _ = runner_step(config, params, st, cmd,
                                   observation=obs)
    carry = (sim, st, rc)
    carry, ph2 = run(carry, JoyInput.neutral(vx=0.25), 1500)
    ph2 = np.asarray(ph2)
    # The transition engine ran its full sequence and swapped the gait.
    assert (ph2 == TransitionPhase.STAND).any()
    assert int(ph2[-1]) == TransitionPhase.NONE
    assert float(carry[1].locomotion.transition.active_idx) == 1.0
