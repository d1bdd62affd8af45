"""Flip-aware warm start (cone_qp.shift_warm_start) — a measured
worst-case/typical TRADE-OFF, off by default.

The 15 ms cadence is half the 30 ms MPC step: every other solve the trot
table advances one horizon row, and the in-place warm start then pins
the wrong diagonals — the 24-iteration budget carries an ~8-11% m*g
transient at hard flips (characterized in test_minv_reuse.py's 40-step
chain). Time-shifting the previous solution one step forward caps that
worst case (~10.8% -> ~5% across seeds) BUT raises the typical flip-step
error (~1% -> ~4%; worse mean; fails the 3% 10-step oracle gate) —
the plain start converges better at ordinary flips, and neither dual
treatment, trigger tightening, nor merit-based per-step selection
separates the regimes (all measured; see MpcConfig.qp_warm_shift).
These tests pin the worst-case cap, the no-false-trigger property, and
the opt-in closed-loop wiring.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import cone_qp

sys.path.insert(0, str(Path(__file__).parent))
from test_golden_parity import build_prob, cadence_case_at  # noqa: E402

CADENCE_S = 0.015
SCALE = float(a1_params().total_mass) * 9.81


def _chain(use_shift, seed=1, steps=40):
    x = y = pin_prev = None
    errs = []
    for k in range(steps):
        prob = build_prob(*cadence_case_at(k * CADENCE_S, seed))
        pin = (prob.fz_hi < 1e-6).astype(jnp.float32)
        if x is None:
            sol = cone_qp.solve(prob, iters=400)
        else:
            x0, y0 = x, y
            if use_shift:
                x0, y0 = cone_qp.shift_warm_start(x0, y0, pin_prev, pin)
            sol = cone_qp.solve(prob, iters=24, alpha=1.0,
                                accel_restart=20, x0=x0, y0=y0)
        x, y = sol.x, sol.y
        pin_prev = pin
        oracle = cone_qp.solve(prob, iters=2000)
        errs.append(float(np.abs(np.asarray(
            sol.x[:12] - oracle.x[:12])).max()) / SCALE)
    return errs


def test_shift_halves_flip_transients():
    """Over the 40-step cadence chain that exposes full-diagonal flips:
    the shifted warm start must cut the worst-case first-step error to
    < 6.5% m*g (plain sits ~10.8%) and not degrade the chain-max."""
    plain = _chain(False)
    shifted = _chain(True)
    assert max(plain) > 0.08, "chain must contain a hard flip step"
    assert max(shifted) < 0.065, f"{max(shifted) * 100:.2f}%"
    assert max(shifted) < max(plain)


def test_no_false_trigger():
    """Identical consecutive pin patterns must leave the warm start
    bit-identical (the select requires a strictly better shifted match)."""
    prob = build_prob(*cadence_case_at(0.0, 0))
    pin = (prob.fz_hi < 1e-6).astype(jnp.float32)
    x = jnp.arange(120.0)
    y = jnp.arange(200.0).reshape(40, 5)
    x0, y0 = cone_qp.shift_warm_start(x, y, pin, pin)
    np.testing.assert_array_equal(np.asarray(x0), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(y0), np.asarray(y))


def test_mpc_step_carries_pin_state():
    """The closed-loop driver threads warm_pinned through MpcState and
    still runs (smoke: one cadence of mpc_step with the shift enabled)."""
    from quadruped_jax.control import mpc as mpc_mod
    from quadruped_jax.control.desired_state import desired_state_init
    from quadruped_jax.gait import ADVANCED_TROT, gait_init, gait_update
    from quadruped_jax.sim import srb_sim

    params = a1_params()
    config = mpc_mod.MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=60,
                               qp_warm_shift=True)   # opt-in feature
    assert not mpc_mod.MpcConfig().qp_warm_shift     # default stays off
    gait_config = ADVANCED_TROT()
    gait = gait_init(gait_config)
    sim = srb_sim.srb_sim_init(params)
    obs = srb_sim.observe(params, sim, jnp.ones(4))
    des = desired_state_init().replace(
        velocity=jnp.asarray([0.3, 0.0, 0.0]))
    state = mpc_mod.mpc_init(config)
    state = mpc_mod.mpc_cold_start(config, params, gait_config, gait,
                                   state, obs, des)
    assert float(jnp.sum(state.warm_pinned)) >= 0.0

    @jax.jit
    def tick(gait, state, t):
        gait = gait_update(gait_config, gait, t, jnp.ones(4))
        tau, forces, solved, state = mpc_mod.mpc_step(
            config, params, gait_config, gait, state, obs, des)
        return gait, state, tau

    t = 0.0
    for _ in range(16):
        t += config.control_dt
        gait, state, tau = tick(gait, state, jnp.asarray(t, jnp.float32))
    assert np.isfinite(np.asarray(tau)).all()
    assert np.isfinite(np.asarray(state.warm_primal)).all()
