"""Cross-cadence M^{-1} reuse: Woodbury-corrected Newton-Schulz seeding.

Round-3 finding (STATUS r3): warm-seeding the NS inverse from the
previous cadence step DIVERGES because the 100x pinned-row rho boost
makes M jump discontinuously whenever the trot table flips a pin
(seed residual ~47 — NS squares it). But each pin flip changes M by
EXACTLY +/- 99*rho * e_j e_j^T (the fz row of the flipped triple,
j = 3t+2 — a coordinate-vector rank-1 update), so a Woodbury correction
of the previous inverse removes the jump in closed form; what remains is
the slow P/equilibration drift over 15 ms, which a few NS polish steps
should absorb.

This probe measures, on bench-style cadence problem pairs:
  1. seed residual ||I - M_new X_seed||_inf for: raw reuse, rescaled
     reuse, rescaled + Woodbury;
  2. NS iterations from the corrected seed to match the cold NS-11
     inverse quality (both measured by the final ADMM solution error
     against a converged oracle).

Run:  python benchmarks/exp_minv_reuse.py
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

import bench
from quadruped_jax.core import se3
from quadruped_jax.dynamics import srb
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import condense, cone_qp

B = 4
H = 10


def build_m(prob):
    """Replicate cone_qp.solve's M build; returns (m_mat, scales)."""
    n = prob.p.shape[-1]
    t = n // 3
    dtype = prob.p.dtype
    q_s, d, d_t, gamma, fz_lo, fz_hi = cone_qp._equilibrate_scales(prob)
    pattern = cone_qp.cone_pattern(prob.mu, dtype)
    pat_t = jnp.swapaxes(pattern, -1, -2)
    pinned = ((fz_hi - fz_lo) < 1e-6)[..., None]
    row_template = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0], dtype)
    rho_rows = cone_qp.RHO_CONE * (1.0 + 99.0 * pinned * row_template)
    ata = jnp.einsum("...ir,...tr,...rj->...tij", pat_t, rho_rows, pattern)
    eye_t = jnp.eye(t, dtype=dtype)
    scale = gamma[..., None, None] * d[..., :, None] * d[..., None, :]
    m = scale * prob.p + cone_qp.SIGMA * jnp.eye(n, dtype=dtype) \
        + jnp.einsum("...tij,tu->...tiuj", ata,
                     eye_t).reshape(prob.p.shape[:-2] + (n, n))
    pin_flat = (fz_hi - fz_lo < 1e-6)    # [..., T] in SCALED coords
    return m, d, gamma, pin_flat


def make_prob(t):
    rng = np.random.default_rng(0)
    rpy, feet, x0 = bench.make_states(B, t, rng)
    table = bench.trot_table(B, t, np.random.default_rng(1))
    params = a1_params()
    weights = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                          jnp.float32)
    r = se3.rpy_to_rotmat(jnp.asarray(rpy))
    k = jnp.arange(H, dtype=jnp.float32)[:, None]
    drift = jnp.zeros((13,), jnp.float32).at[3].set(0.4 * 0.03)
    x_des = jnp.asarray(x0)[:, None, :] + k[None] * drift[None, None, :]
    x_des = x_des.at[..., 9].set(0.4)
    a, b = srb.srb_continuous(r, params.total_inertia, params.total_mass,
                              jnp.asarray(feet))
    ad, bd = srb.srb_discretize(a, b, 0.03)
    p, q = condense.condense_cost_structured(
        a, bd, ad, jnp.asarray(x0), x_des, weights, 4e-6, H, 0.03)
    fz_hi = (jnp.asarray(table) * params.max_force).reshape(B, H * 4)
    return cone_qp.ConeQP(p=p, q=q, mu=jnp.asarray(0.45, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


def residual(m, x):
    n = m.shape[-1]
    r = jnp.eye(n) - jnp.einsum("...ij,...jk->...ik", m, x)
    return float(jnp.max(jnp.sum(jnp.abs(r), axis=-1)))


def ns_from(m, x0, iters):
    """f32 NS polish iterations from an explicit seed."""
    x = x0
    for _ in range(iters):
        inner = 2.0 * jnp.eye(m.shape[-1]) - jnp.einsum(
            "...ij,...jk->...ik", m, x)
        x = jnp.einsum("...ij,...jk->...ik", x, inner)
    return x


def main():
    prob0 = make_prob(0.0)
    prob1 = make_prob(bench.CADENCE_S)
    m0, d0, g0, pin0 = build_m(prob0)
    m1, d1, g1, pin1 = build_m(prob1)
    x0 = cone_qp.newton_schulz_inverse(m0, 11, 2)

    print("pin flips per scenario:",
          np.asarray(jnp.sum(pin0 != pin1, axis=-1)))
    print("raw reuse residual:      ", residual(m1, x0))

    # Rescale through both equilibrations: M ~ gamma d P d + ..., so
    # X_new ~ (d0/d1) X0 (d0/d1) * (g0/g1).
    s = (d0 / d1) * jnp.sqrt(g0 / g1)[..., None]
    x_rs = s[..., :, None] * x0 * s[..., None, :]
    print("rescaled reuse residual: ", residual(m1, x_rs))

    # Woodbury: pin flips are +/- 99*rho on coordinate j = 3t+2 of the
    # SCALED system. Remove them from the rescaled inverse one at a time
    # (Sherman-Morrison; coordinate vectors, so each update reads one
    # row/col of X).
    boost = 99.0 * cone_qp.RHO_CONE
    t_dim = pin0.shape[-1]
    x_w = x_rs
    flips = np.asarray(pin1 ^ pin0)
    sign = np.asarray(pin1, np.float32) - np.asarray(pin0, np.float32)
    for b_i in range(B):
        xb = x_w[b_i]
        for t_i in range(t_dim):
            if not flips[b_i, t_i]:
                continue
            j = 3 * t_i + 2
            c = boost * float(sign[b_i, t_i])
            col = xb[:, j]
            denom = 1.0 + c * col[j]
            xb = xb - (c / denom) * jnp.outer(col, xb[j, :])
        x_w = x_w.at[b_i].set(xb)
    print("rescaled+woodbury residual:", residual(m1, x_w))

    # NS polish from each seed; compare ADMM solve quality.
    oracle = cone_qp.solve(prob1, iters=2000)
    cold = cone_qp.solve(prob1, iters=24, alpha=1.0, accel_restart=20,
                         x0=cone_qp.solve(prob0, iters=400).x,
                         y0=cone_qp.solve(prob0, iters=400).y)
    scale = float(a1_params().total_mass) * 9.81
    err_cold = float(jnp.max(jnp.abs(cold.x[:, :12] - oracle.x[:, :12]))) \
        / scale
    print(f"production (cold NS-11) first-step err: {err_cold * 100:.2f}%")
    for k in (2, 3, 4, 6):
        xk = ns_from(m1, x_w, k)
        print(f"  NS-{k} from corrected seed: residual {residual(m1, xk):.2e}")


if __name__ == "__main__":
    main()
