"""Move-blocking experiment: shrink the condensed MPC system by sharing
force variables across tail horizon steps, and measure first-step-force
accuracy against the full-resolution converged solution on the golden
ensemble.

Blocking map E [12H, 12H_r]: head steps keep individual forces; tail
steps are grouped (each group shares one force triple per leg). Reduced
problem: P_r = E^T P E, q_r = E^T q; cone bounds per shared triple take
the MIN fz_hi over its group (feasible for every covered step). Solution
maps back with U = E u_r.

Run:  python benchmarks/exp_move_blocking.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")
from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from quadruped_jax.solvers import cone_qp

H = 10


def blocking_groups(head: int, block: int):
    """Step -> group index for [head individual, then blocks of `block`]."""
    groups = []
    g = 0
    k = 0
    while k < H:
        if k < head:
            groups.append(g)
            g += 1
            k += 1
        else:
            for _ in range(min(block, H - k)):
                groups.append(g)
            g += 1
            k += min(block, H - k)
    return np.asarray(groups), g


def reduce_problem(prob, groups, n_groups):
    """Build the reduced ConeQP via the blocking map."""
    e = np.zeros((H, n_groups), np.float32)
    e[np.arange(H), groups] = 1.0
    # Expand to force coordinates: [12H, 12 n_groups] block structure.
    e_big = np.kron(e, np.eye(12, dtype=np.float32))
    e_big = jnp.asarray(e_big)
    p_r = e_big.T @ prob.p @ e_big
    q_r = prob.q @ e_big
    # fz bounds per (group, leg): min over covered steps.
    fz_hi = np.asarray(prob.fz_hi).reshape(H, 4)
    fz_hi_r = np.stack([fz_hi[groups == gi].min(axis=0)
                        for gi in range(n_groups)])
    fz_lo_r = np.zeros_like(fz_hi_r)
    red = cone_qp.ConeQP(p=p_r, q=q_r, mu=prob.mu,
                         fz_lo=jnp.asarray(fz_lo_r.reshape(-1)),
                         fz_hi=jnp.asarray(fz_hi_r.reshape(-1)))
    return red, e_big


def main():
    import test_golden_parity as G

    print(f"{'config':>16} {'n_r':>4} " + " ".join(
        f"s{s}{r[:2]}" for s, r in [(0, 'a1'), (1, 'a1'), (2, 'a1'),
                                    (3, 'a1'), (4, 'al'), (5, 'li')]))
    cases = []
    for seed, robot in [(0, "a1"), (1, "a1"), (2, "a1"), (3, "a1"),
                        (4, "aliengo"), (5, "lite3")]:
        case = G.make_case(seed, robot)
        prob = G.build_prob(*case)
        conv = cone_qp.solve(prob, iters=2000)
        cases.append((case[0], prob, np.asarray(conv.x)[:12]))

    for head, block in [(10, 1), (6, 2), (4, 2), (4, 3), (2, 4), (6, 4)]:
        groups, n_g = blocking_groups(head, block)
        errs = []
        for params, prob, ref_first in cases:
            red, e_big = reduce_problem(prob, groups, n_g)
            sol = cone_qp.solve(red, iters=2000)
            full = np.asarray(e_big @ sol.x)
            scale = float(params.total_mass) * 9.81
            errs.append(np.abs(full[:12] - ref_first).max() / scale * 100)
        label = f"head{head}+blk{block}"
        print(f"{label:>16} {12 * n_g:>4} "
              + " ".join(f"{e:5.2f}%" for e in errs))


if __name__ == "__main__":
    main()
