"""Horizon condensation for the convex MPC dense QP, batched.

Capability parity with the reference's `ConvertToDiscreteQP` + `ResizeQPMats`
+ `SolveMPC` (quadruped/src/controllers/mpc/qr_mpc_interface.cpp:178-293,
:359-442): fold the MPC horizon into one dense QP over the stacked
contact-force trajectory,

    X = Aqp x0 + Bqp U
    min_U  (X - Xd)^T L (X - Xd) + alpha ||U||^2
    s.t.   per-(step, leg) friction-pyramid rows on U

yielding  P = 2 (Bqp^T L Bqp + alpha I),  qvec = 2 Bqp^T L (Aqp x0 - Xd).

Batching notes: Aqp/Bqp powers are built with a `lax.scan` of 13x13 matmuls
(static horizon), the big Bqp^T L Bqp product is a single [12H x 13H] @
[13H x 12H] batched matmul, and the constraint matrix
is block-diagonal with a *static* 5x3 pattern per (step, leg) — so it is
never materialized as a dense [20H x 12H] operator in the hot path; the QP
solver can exploit the block structure (see solvers/qp.py and the Pallas
kernel).

The friction-cone rows per (step, leg) follow the reference (5 rows):
    -mu fz <= fx <= mu fz
    -mu fz <= fy <= mu fz
     fz_min(=0) <= fz <= contact * fmax
Swing steps get fmax = 0, pinning the whole force to zero — the same trick
the reference uses (gait-gated fz upper bound).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_jax.dynamics.srb import NX, NU

BIG = 1e8
CONE_ROWS = 5  # per leg per step


class CondensedQP(NamedTuple):
    p: jnp.ndarray       # [..., 12H, 12H]
    q: jnp.ndarray       # [..., 12H]
    a: jnp.ndarray       # [..., 5*4*H, 12H] friction constraint matrix
    l: jnp.ndarray       # [..., 5*4*H]
    u: jnp.ndarray       # [..., 5*4*H]


def horizon_powers(ad: jnp.ndarray, horizon: int) -> jnp.ndarray:
    """[..., 13, 13] -> [..., H, 13, 13] with entry k = Ad^(k+1).

    Statically unrolled (H is small and static): each power is one batched
    13x13 matmul; the unroll avoids lax.scan's per-step loop overhead.
    """
    powers = [ad]
    for _ in range(horizon - 1):
        powers.append(ad @ powers[-1])
    return jnp.stack(powers, axis=-3)


def condense_dynamics(ad: jnp.ndarray, bd: jnp.ndarray, horizon: int):
    """Build (Aqp [.., H*13, 13], Bqp [.., H*13, H*12]) from one-step (Ad, Bd).

    Bqp[k, j] = Ad^(k-j) Bd for j <= k (block lower-triangular Toeplitz).
    The Toeplitz fill is a static unroll of slices + concats — a dynamic
    gather here was a measured ~x3 slowdown of the whole condensation on
    the accelerator this was first tuned on.
    """
    batch = ad.shape[:-2]
    powers = horizon_powers(ad, horizon)  # [..., H, 13, 13] = Ad^(k+1)
    aqp = powers.reshape(batch + (horizon * NX, NX))

    # blocks[d] = Ad^d Bd, d = 0..H-1 (pow0[k] = Ad^k).
    eye = jnp.broadcast_to(jnp.eye(NX, dtype=ad.dtype), batch + (1, NX, NX))
    pow0 = jnp.concatenate([eye, powers[..., : horizon - 1, :, :]], axis=-3)
    blocks = jnp.einsum("...dij,...jk->...dik", pow0, bd)  # [..., H, 13, 12]

    zero_block = jnp.zeros_like(blocks[..., 0, :, :])
    rows = []
    for k in range(horizon):
        row = [blocks[..., k - j, :, :] if j <= k else zero_block
               for j in range(horizon)]
        rows.append(jnp.concatenate(row, axis=-1))   # [..., 13, 12H]
    bqp = jnp.concatenate(rows, axis=-2)             # [..., 13H, 12H]
    return aqp, bqp


def cone_constraint_pattern(dtype=jnp.float32) -> jnp.ndarray:
    """Static [5, 3] friction-pyramid row pattern for one (step, leg)."""
    mu_placeholder = 1.0  # scaled by mu at build time
    return jnp.asarray([
        [1.0, 0.0, mu_placeholder],    # fx + mu fz in [0, BIG]
        [-1.0, 0.0, mu_placeholder],   # -fx + mu fz in [0, BIG]
        [0.0, 1.0, mu_placeholder],    # fy + mu fz in [0, BIG]
        [0.0, -1.0, mu_placeholder],   # -fy + mu fz in [0, BIG]
        [0.0, 0.0, 1.0],               # fz in [fz_min, contact*fmax]
    ], dtype=dtype)


def build_cone_constraints(
    mu: jnp.ndarray,           # [...]
    fmax: jnp.ndarray,         # [...] per-leg max vertical force (m*g ref)
    contact_table: jnp.ndarray,  # [..., H, 4] 1.0 = stance, 0.0 = swing
    horizon: int,
    fz_min: float = 0.0,
):
    """Dense [.., 20H, 12H] block-diagonal cone matrix + bounds l, u."""
    batch = contact_table.shape[:-2]
    dtype = contact_table.dtype
    pat = cone_constraint_pattern(dtype)
    pat = pat.at[:4, 2].set(0.0)  # mu column filled below

    mu_b = jnp.broadcast_to(mu, batch)[..., None, None, None, None]
    base = jnp.broadcast_to(pat, batch + (horizon, 4, CONE_ROWS, 3))
    mu_col = jnp.asarray([1.0, 1.0, 1.0, 1.0, 0.0], dtype)[:, None] \
        * jnp.asarray([0.0, 0.0, 1.0], dtype)[None, :]
    blocks = base + mu_b * mu_col  # [..., H, 4, 5, 3]

    # Block-diagonal constraint matrix over the H*4 force triples, built
    # with an einsum against the identity (batch-safe, no scatter).
    n_forces = horizon * 4
    blocks_flat = blocks.reshape(batch + (n_forces, CONE_ROWS, 3))
    eye = jnp.eye(n_forces, dtype=dtype)
    a = jnp.einsum("...frc,fg->...frgc", blocks_flat, eye)
    a = a.reshape(batch + (n_forces * CONE_ROWS, n_forces * 3))

    contact = contact_table.reshape(batch + (n_forces,))
    lower_one = jnp.stack([
        jnp.zeros_like(contact), jnp.zeros_like(contact),
        jnp.zeros_like(contact), jnp.zeros_like(contact),
        jnp.full_like(contact, fz_min) * contact,
    ], axis=-1)
    fmax_b = jnp.broadcast_to(fmax, batch)[..., None]
    upper_one = jnp.stack([
        jnp.full_like(contact, BIG), jnp.full_like(contact, BIG),
        jnp.full_like(contact, BIG), jnp.full_like(contact, BIG),
        contact * fmax_b,
    ], axis=-1)
    l = lower_one.reshape(batch + (n_forces * CONE_ROWS,))
    u = upper_one.reshape(batch + (n_forces * CONE_ROWS,))
    return a, l, u


def condense_cost_structured(
    a_ct: jnp.ndarray,           # [..., 13, 13] CONTINUOUS-time A
    bd: jnp.ndarray,             # [..., 13, 12] discrete Bd
    ad: jnp.ndarray,             # [..., 13, 13] discrete Ad
    x0: jnp.ndarray,             # [..., 13]
    x_des: jnp.ndarray,          # [..., H, 13]
    state_weights: jnp.ndarray,  # [13]
    force_weight,
    horizon: int,
    dt: float,
):
    """Closed-form condensation exploiting the SRB nilpotency.

    With M = Ad - I = A dt + A^2 dt^2/2 and A nilpotent (A^3 = 0, A^2 B = 0;
    see dynamics/srb.py), the Toeplitz blocks are LINEAR in the step offset:

        G_d = Ad^d Bd = Bd + d * (dt * A) Bd                (M^2 Bd = 0)
        Ad^k = I + k M + C(k,2) (A dt)^2                     (M^3 = 0)

    so  P_{ij} = sum_k G_{k-i}^T L G_{k-j}  collapses to four 12x12
    matrices combined with STATIC [H, H] polynomial coefficient tables —
    no sequential powers, no [13H x 12H] Bqp, no large gathers. Far fewer
    FLOPs than the generic build and exact to f32 roundoff (the same
    closed form the exact-ZOH test validates).
    """
    batch = x0.shape[:-1]
    dtype = bd.dtype
    lw = state_weights  # [13]

    c_mat = dt * jnp.einsum("...ij,...jk->...ik", a_ct, bd)  # [.., 13, 12]

    # The four 12x12 building blocks.
    lb = lw[..., :, None] * bd
    lc = lw[..., :, None] * c_mat
    bt_lb = jnp.einsum("...ji,...jk->...ik", bd, lb)
    bt_lc = jnp.einsum("...ji,...jk->...ik", bd, lc)
    ct_lb = jnp.swapaxes(bt_lc, -1, -2)
    ct_lc = jnp.einsum("...ji,...jk->...ik", c_mat, lc)

    # Static coefficient tables over (i, j): sums over k from max(i,j) to
    # H-1 of 1, (k-i), (k-j), (k-i)(k-j).
    idx = np.arange(horizon)
    i_g, j_g = np.meshgrid(idx, idx, indexing="ij")
    lo = np.maximum(i_g, j_g)
    c0 = np.zeros((horizon, horizon), np.float32)
    c1 = np.zeros_like(c0)
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    for i in range(horizon):
        for j in range(horizon):
            ks = np.arange(lo[i, j], horizon)
            c0[i, j] = len(ks)
            c1[i, j] = np.sum(ks - i)
            c2[i, j] = np.sum(ks - j)
            c3[i, j] = np.sum((ks - i) * (ks - j))
    coefs = jnp.asarray(np.stack([c0, c1, c2, c3]), dtype)  # [4, H, H]

    xs = jnp.stack([bt_lb, ct_lb, bt_lc, ct_lc], axis=-3)   # [..., 4, 12, 12]
    p_blocks = jnp.einsum("mhk,...mij->...hikj", coefs, xs)
    p = 2.0 * p_blocks.reshape(batch + (horizon * NU, horizon * NU))
    p = p + (2.0 * force_weight) * jnp.eye(horizon * NU, dtype=dtype)

    # Residual r_k = Ad^{k+1} x0 - xd_k via the closed-form powers.
    m_mat = ad - jnp.eye(NX, dtype=dtype)
    a2dt2 = jnp.einsum("...ij,...jk->...ik", a_ct, a_ct) * (dt * dt)
    mx = jnp.einsum("...ij,...j->...i", m_mat, x0)
    a2x = jnp.einsum("...ij,...j->...i", a2dt2, x0)
    k = jnp.arange(1, horizon + 1, dtype=dtype)
    comb = (k * (k - 1) * 0.5)
    xk = (x0[..., None, :] + k[:, None] * mx[..., None, :]
          + comb[:, None] * a2x[..., None, :])          # [..., H, 13]
    resid = lw * (xk - x_des)                            # L r_k folded in

    # q_j = 2 [ B^T sum_{k>=j} (L r_k) + c^T sum_{k>=j} (k-j)(L r_k) ].
    rc0 = jnp.cumsum(resid[..., ::-1, :], axis=-2)[..., ::-1, :]
    kr = jnp.arange(horizon, dtype=dtype)[:, None] * resid
    rc1k = jnp.cumsum(kr[..., ::-1, :], axis=-2)[..., ::-1, :]
    jj = jnp.arange(horizon, dtype=dtype)[:, None]
    s1 = rc1k - jj * rc0                                  # sum (k-j) L r_k
    qb = jnp.einsum("...ji,...hj->...hi", bd, rc0)        # [..., H, 12]
    qc = jnp.einsum("...ji,...hj->...hi", c_mat, s1)
    qvec = 2.0 * (qb + qc).reshape(batch + (horizon * NU,))
    return p, qvec


def condense_cost(
    ad: jnp.ndarray,             # [..., 13, 13]
    bd: jnp.ndarray,             # [..., 13, 12]
    x0: jnp.ndarray,             # [..., 13]
    x_des: jnp.ndarray,          # [..., H, 13]
    state_weights: jnp.ndarray,  # [13]
    force_weight,                # scalar alpha
    horizon: int,
):
    """Cost-only condensation: (P [..,12H,12H], q [..,12H]) without the
    dense cone matrix — the structure-exploiting solver (solvers/cone_qp.py)
    applies the cones analytically."""
    batch = x0.shape[:-1]
    aqp, bqp = condense_dynamics(ad, bd, horizon)
    lw = jnp.tile(state_weights, horizon)  # [13H]
    bqp_t = jnp.swapaxes(bqp, -1, -2)
    lbqp = lw[..., :, None] * bqp
    p = 2.0 * (bqp_t @ lbqp
               + force_weight * jnp.eye(horizon * NU, dtype=bqp.dtype))
    xd = x_des.reshape(batch + (horizon * NX,))
    resid = jnp.einsum("...ij,...j->...i", aqp, x0) - xd
    qvec = 2.0 * jnp.einsum("...ji,...j->...i", lbqp, resid)
    return p, qvec


def condense_qp(
    ad: jnp.ndarray,             # [..., 13, 13]
    bd: jnp.ndarray,             # [..., 13, 12]
    x0: jnp.ndarray,             # [..., 13]
    x_des: jnp.ndarray,          # [..., H, 13] desired state trajectory
    state_weights: jnp.ndarray,  # [13] L diagonal (gravity row weight 0)
    force_weight,                # scalar alpha
    mu: jnp.ndarray,
    fmax: jnp.ndarray,
    contact_table: jnp.ndarray,  # [..., H, 4]
    horizon: int,
) -> CondensedQP:
    """Full condensed QP build (reference SolveMPC :359-442 equivalent)."""
    batch = x0.shape[:-1]
    aqp, bqp = condense_dynamics(ad, bd, horizon)
    lw = jnp.tile(state_weights, horizon)  # [13H]
    bqp_t = jnp.swapaxes(bqp, -1, -2)
    lbqp = lw[..., :, None] * bqp
    p = 2.0 * (bqp_t @ lbqp
               + force_weight * jnp.eye(horizon * NU, dtype=bqp.dtype))
    xd = x_des.reshape(batch + (horizon * NX,))
    resid = jnp.einsum("...ij,...j->...i", aqp, x0) - xd
    qvec = 2.0 * jnp.einsum("...ji,...j->...i", lbqp, resid)
    a, l, u = build_cone_constraints(mu, fmax, contact_table, horizon)
    return CondensedQP(p=p, q=qvec, a=a, l=l, u=u)


# ---------------------------------------------------------------------------
# Move blocking: share force variables across tail horizon steps.
# ---------------------------------------------------------------------------

def move_block_groups(horizon: int, head: int, block: int):
    """Static step -> group map: `head` individual steps, then groups of
    `block`. Returns (groups [H] np array, n_groups).

    The reference solves the full 12H system (qr_mpc_interface.cpp
    ResizeQPMats); blocking the tail is a batched-side approximation lever:
    at H=10, head=6/block=2 shrinks the condensed system 120 -> 96
    (Newton-Schulz inverse ~2x cheaper, ADMM matvecs ~1.6x) while moving
    converged first-step forces by < 0.7% of m*g on the golden ensemble
    (benchmarks/exp_move_blocking.py)."""
    groups = []
    g = 0
    k = 0
    while k < horizon:
        n = 1 if k < head else min(block, horizon - k)
        groups.extend([g] * n)
        g += 1
        k += n
    return np.asarray(groups), g


def reduce_move_blocking(p: jnp.ndarray, q: jnp.ndarray,
                         fz_hi: jnp.ndarray, groups: np.ndarray,
                         n_groups: int, horizon: int):
    """(P, q, fz_hi) of the full condensed QP -> the blocked QP.

    U = E u with E the per-step one-hot expansion; P_r = E^T P E and
    q_r = E^T q computed as tiny [H, G] contractions over the step axes
    (never materializing the [12H, 12G] map). Shared triples take the
    MIN fz_hi over their group — feasible for every covered step (a
    block straddling a contact flip pins its force, the same gait-gated
    trick the per-step table uses)."""
    batch = p.shape[:-2]
    e = jnp.asarray(np.eye(n_groups, dtype=np.float32)[groups])  # [H, G]
    p4 = p.reshape(batch + (horizon, 12, horizon, 12))
    p_r = jnp.einsum("hg,...hiwj,wk->...gikj", e, p4, e) \
        .reshape(batch + (12 * n_groups, 12 * n_groups))
    q_r = jnp.einsum("hg,...hi->...gi", e,
                     q.reshape(batch + (horizon, 12))) \
        .reshape(batch + (12 * n_groups,))
    fz = fz_hi.reshape(batch + (horizon, 4))
    mask = e.T[..., None]                                  # [G, H, 1]
    fz_r = jnp.min(jnp.where(mask > 0.5, fz[..., None, :, :], jnp.inf),
                   axis=-2).reshape(batch + (4 * n_groups,))
    return p_r, q_r, fz_r


def expand_move_blocking(u_r: jnp.ndarray, groups: np.ndarray,
                         horizon: int):
    """Reduced solution [.., 12G] -> full [.., 12H] (U = E u)."""
    batch = u_r.shape[:-1]
    u3 = u_r.reshape(batch + (-1, 12))
    return u3[..., jnp.asarray(groups), :].reshape(batch + (12 * horizon,))
