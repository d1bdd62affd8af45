"""Cross-cadence M^{-1} reuse (cone_qp.InverseCarry / seeded_inverse).

The ADMM matrix's only discontinuous change between 15 ms cadence solves
is the +/- 99*rho pinned-row jump when the trot table flips a pin — a
coordinate-vector rank-1 update per flipped triple. seeded_inverse
removes it by block Woodbury after rescaling through both
equilibrations, then short-polishes with Newton-Schulz; these tests pin
(a) solution parity of the seeded path against the cold 11-iteration
inverse across cadence steps WITH pin flips, (b) the out-of-region
fallback staying finite, (c) carry chaining over many steps (no error
accumulation — NS re-contracts to the CURRENT M's inverse every step).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import cone_qp

sys.path.insert(0, str(Path(__file__).parent))
from test_golden_parity import build_prob, cadence_case_at  # noqa: E402

CADENCE_S = 0.015
SCALE = float(a1_params().total_mass) * 9.81


def _warm_chain(n_steps, use_carry, seed=0):
    """Cold boot at step 0, then warm production solves; returns per-step
    first-step forces and the pin patterns seen."""
    x = y = carry = None
    forces = []
    pins = []
    for k in range(n_steps):
        prob = build_prob(*cadence_case_at(k * CADENCE_S, seed))
        pins.append(np.asarray(prob.fz_hi < 1e-6))
        if x is None:
            sol, carry = cone_qp.solve(prob, iters=400,
                                       return_inv_carry=True)
        elif use_carry:
            sol, carry = cone_qp.solve(prob, iters=24, alpha=1.0,
                                       accel_restart=20, x0=x, y0=y,
                                       inv_carry=carry,
                                       return_inv_carry=True)
        else:
            sol = cone_qp.solve(prob, iters=24, alpha=1.0,
                                accel_restart=20, x0=x, y0=y)
        x, y = sol.x, sol.y
        forces.append(np.asarray(sol.x[:12]))
    return np.stack(forces), pins


def test_seeded_matches_cold_across_flips():
    """10 chained cadence solves: the seeded-inverse path must track the
    cold-NS path within 0.5% m*g at every step, across trot pin flips
    (the sequence contains them — asserted)."""
    f_cold, pins = _warm_chain(10, use_carry=False)
    f_seed, _ = _warm_chain(10, use_carry=True)
    n_flips = sum(int((pins[k] != pins[k - 1]).sum())
                  for k in range(1, len(pins)))
    assert n_flips > 0, "sequence must exercise pin flips"
    err = np.abs(f_seed - f_cold).max()
    assert err < 0.005 * SCALE, f"{err / SCALE * 100:.3f}% m*g"


def test_fallback_stays_finite():
    """A garbage carry (inverse of an unrelated, badly scaled system)
    must trip the residual fallback and still produce finite, bounded
    forces — the documented graceful degradation, not a NaN."""
    prob = build_prob(*cadence_case_at(0.0, 0))
    n = prob.p.shape[-1]
    t = n // 3
    bad = cone_qp.InverseCarry(
        m_inv=jnp.eye(n) * 37.0,
        d_t=jnp.full((t,), 5.0),
        gamma=jnp.asarray(40.0),
        pinned=jnp.zeros((t,)))
    sol = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20,
                        inv_carry=bad)
    assert np.isfinite(np.asarray(sol.x)).all()
    assert np.abs(np.asarray(sol.x)).max() < 20.0 * SCALE


def test_long_chain_no_accumulation():
    """40 chained solves, seeded vs cold-NS, BOTH compared to a converged
    oracle at every step: the seeded path must never exceed the cold
    path's error by more than 1% m*g — i.e. reuse introduces no
    accumulating drift (the NS polish re-contracts to the CURRENT M each
    step; measured worst excess 0.35%).

    Dominance (not an absolute gate) because this 40-step sequence
    exposes a PRE-EXISTING characteristic of the production warm budget
    that the 10-step parity gates never sampled: at cadence steps where
    the trot table flips all 8 diagonal pins between solves, the warm
    x/y start is far from the new optimum and BOTH paths carry an
    ~8-11% m*g transient for that one solve (recovering within 1-2
    solves). The transient is a warm-START property, identical with the
    exact cold inverse — characterized here, not hidden."""
    x = y = carry = None
    xc = yc = None
    excess = []
    for k in range(40):
        prob = build_prob(*cadence_case_at(k * CADENCE_S, 1))
        if x is None:
            sol, carry = cone_qp.solve(prob, iters=400,
                                       return_inv_carry=True)
            solc = cone_qp.solve(prob, iters=400)
        else:
            sol, carry = cone_qp.solve(prob, iters=24, alpha=1.0,
                                       accel_restart=20, x0=x, y0=y,
                                       inv_carry=carry,
                                       return_inv_carry=True)
            solc = cone_qp.solve(prob, iters=24, alpha=1.0,
                                 accel_restart=20, x0=xc, y0=yc)
        x, y = sol.x, sol.y
        xc, yc = solc.x, solc.y
        oracle = cone_qp.solve(prob, iters=2000)
        es = np.abs(np.asarray(sol.x[:12] - oracle.x[:12])).max() / SCALE
        ec = np.abs(np.asarray(solc.x[:12] - oracle.x[:12])).max() / SCALE
        excess.append(es - ec)
    assert max(excess) < 0.01, f"worst excess {max(excess) * 100:.2f}% m*g"
