"""Structure-exploiting batched solver for friction-cone QPs (the MPC QP).

The condensed MPC QP (solvers/condense.py) has a dense cost P [12H x 12H]
but a *block-diagonal* constraint matrix: 5 friction-pyramid rows per force
triple (leg x horizon step). The generic solver (solvers/qp.py)
materializes the [20H x 12H] cone matrix and streams it twice per ADMM
iteration — at batch 4096, H=10 that is ~400 MB of memory traffic per
iteration, on top of a batched Cholesky inverse.

This solver never materializes the cone matrix:

  * A x, A^T y are [B, T, 3] <-> [B, T, 5] einsums against one static
    [5, 3] pattern (mu folded in per scenario) — kilobytes, not megabytes;
  * A^T diag(rho) A is a per-triple [3, 3] block added to P's diagonal
    blocks;
  * M^{-1} is computed by Newton-Schulz iteration — pure batched matmuls
    (tensor-core GEMMs), instead of a batched triangular-solve path;
  * scaling is a per-triple scalar (cone geometry is scale-invariant per
    triple), so equilibration never distorts the pyramid.

Same ADMM scheme (over-relaxed, per-row rho) and semantics as
solvers/qp.py; this is the hot path behind `mpc_solve` and bench.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

SIGMA = 1e-6
ALPHA = 1.6
# Tuned on equilibrated MPC problems: rho trades ADMM accuracy against the
# conditioning of M = P + sigma I + A^T rho A (smaller rho -> tighter
# 40-iteration solutions on contact-switching trot instances but larger
# kappa, needing more Newton-Schulz steps). rho=0.05 halves the worst-case
# force error vs 0.1 while kappa ~ 90 keeps NS_ITERS=11 converged
# (see tests/test_warm_start_cadence.py; 10 NS iterations already match 11
# to 4 digits on typical instances but fail golden parity on the hardest
# trot case — 11 is load-bearing, do not trim).
RHO_CONE = 0.05
NS_ITERS = 11
# Trailing f32 Newton-Schulz steps after the bf16 ones. One step leaves the
# inverse at ~2e-4 relative error (max|I - M X| ~1.7e-3 on the bench
# ensemble) that depends on the bf16 phase's rounding order, and the ADMM
# loop's fixed point moves with it: a 1e-6 relative perturbation of the
# states moves the warm 24-iteration forces by 0.6% of m*g, and the GPU
# and CPU solves of the same problems differed by 2.8% (chip_smoke.py).
# A second step squares the error again (~1e-5 relative; the same
# perturbation moves forces by 0.01% of m*g) at one matmul pair of 11.
NS_F32_POLISH = 2
# Matmul precision of the f32 Newton-Schulz polish steps. An explicit
# precision overrides the process-wide float32 default
# (quadruped_jax/__init__.py). On a GPU, Precision.HIGH is one TF32 pass
# (10-bit mantissa): the polished inverse stalls at max|I - M X| ~2.3e-3
# and forces move 8% of m*g off the f32 result. BF16_BF16_F32_X3 (three
# bf16 tensor-core passes) reaches ~6e-5, inside the ~1e-4 the solve's
# accuracy budget was set with, but through the cold boot solve and the
# warm solve together its forces sit 0.87% of m*g off the f32 result,
# next to chip_smoke.py's 1% bound. HIGHEST, a true f32 dot, reaches the
# f32 floor (~1.8e-5, forces within 0.03% of m*g) for ~5 ms more per
# 32768-problem update on the H100 (numbers in PERF.md). On the CPU all
# three compute in f32.
POLISH_PRECISION = jax.lax.Precision.HIGHEST


class ConeQP(NamedTuple):
    """min 1/2 x^T P x + q^T x  s.t. per-triple cones on x.reshape(T, 3).

    Cone rows per triple t (pattern below): 4 pyramid rows >= 0 and
    fz in [fz_lo[t], fz_hi[t]].
    """

    p: jnp.ndarray       # [..., n, n], n = 3T
    q: jnp.ndarray       # [..., n]
    mu: jnp.ndarray      # [...] friction coefficient
    fz_lo: jnp.ndarray   # [..., T]
    fz_hi: jnp.ndarray   # [..., T]


def cone_pattern(mu: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """[..., 5, 3] rows: [fx+mu fz, -fx+mu fz, fy+mu fz, -fy+mu fz, fz]."""
    zero = jnp.zeros_like(mu)
    one = jnp.ones_like(mu)
    rows = [
        jnp.stack([one, zero, mu], axis=-1),
        jnp.stack([-one, zero, mu], axis=-1),
        jnp.stack([zero, one, mu], axis=-1),
        jnp.stack([zero, -one, mu], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ]
    return jnp.stack(rows, axis=-2).astype(dtype)


def newton_schulz_inverse(m: jnp.ndarray, iters: int = NS_ITERS,
                          f32_polish: int = NS_F32_POLISH,
                          precision=None) -> jnp.ndarray:
    """Batched SPD inverse by Newton-Schulz: X <- X (2I - M X).

    Every step is two batched [n x n] matmuls.
    For SPD M the start X0 = I / ||M||_inf is valid (eigenvalues of
    I - M X0 lie in (0, 1)) and converges in roughly log2(kappa) + 4
    steps — ~11 for the equilibrated MPC matrices (kappa ~ 40).

    Mixed precision: Newton's iteration is self-correcting, so all but the
    last `f32_polish` steps run with bf16 operands (f32 accumulation); the
    error floor of bf16 (~1e-2 relative) is squared away by the f32 polish
    steps (1e-2 -> 1e-4 -> the floor of `precision`, POLISH_PRECISION by
    default).
    """
    precision = POLISH_PRECISION if precision is None else precision
    n = m.shape[-1]
    norminf = jnp.max(jnp.sum(jnp.abs(m), axis=-1), axis=-1)
    eye2 = 2.0 * jnp.eye(n, dtype=m.dtype)
    m_bf = m.astype(jnp.bfloat16)

    def body_bf16(x_bf, _):
        # Carry X in bf16 so the scan streams half the bytes; products
        # accumulate in f32.
        inner = eye2 - jnp.einsum("...ij,...jk->...ik", m_bf, x_bf,
                                  preferred_element_type=jnp.float32)
        x = jnp.einsum("...ij,...jk->...ik", x_bf,
                       inner.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return x.astype(jnp.bfloat16), None

    def body_f32(x, _):
        inner = eye2 - jnp.matmul(m, x, precision=precision)
        x = jnp.matmul(x, inner, precision=precision)
        return x, None

    n_bf = max(iters - f32_polish, 0)
    x0 = (jnp.eye(n, dtype=jnp.bfloat16) / norminf[..., None, None]
          .astype(jnp.bfloat16)) + jnp.zeros_like(m_bf)
    if n_bf > 0:
        x_bf, _ = jax.lax.scan(body_bf16, x0, None, length=n_bf)
        x = x_bf.astype(m.dtype)
    else:
        x = x0.astype(m.dtype)
    x, _ = jax.lax.scan(body_f32, x, None, length=iters - n_bf)
    return x


class InverseCarry(NamedTuple):
    """Cross-solve carry for M^{-1} reuse at the MPC cadence.

    The ADMM matrix M = gamma d P d + sigma I + blockdiag(A^T rho A)
    changes between 15 ms cadence solves in two ways: a SMALL drift of the
    equilibrated cost (the robot moves ~mm) and a DISCONTINUOUS jump of
    +/- 99*rho on the fz diagonal of every force triple whose pin status
    flips with the trot table (the round-3 warm-seed divergence: seed
    residual ~47). The jump is exactly a coordinate-vector rank-1 update
    per flipped triple, so `seeded_inverse` removes it in closed form
    (block Woodbury over the 3t+2 coordinates) after rescaling through
    both equilibrations, leaving a seed residual ~0.6 that a short
    Newton-Schulz polish drains — ~2.4x fewer FLOPs than the cold
    11-iteration inverse (benchmarks/exp_minv_reuse.py).

    STATUS: default off. The mechanism is correct (parity gates:
    tests/test_minv_reuse.py + the carried production-cadence chains),
    but whether it saves time is open: if the inverse is bound by memory
    traffic rather than FLOPs, the rescale/Woodbury stages stream the same
    [B, n, n] tensors the saved iterations would have. Hypothesis to
    re-check on the card; QTPU_BENCH_MINV_REUSE=1 times this path.
    """

    m_inv: jnp.ndarray   # [..., n, n] inverse of the SCALED M
    d_t: jnp.ndarray     # [..., T] per-triple equilibration scale
    gamma: jnp.ndarray   # [...] cost normalization
    pinned: jnp.ndarray  # [..., T] pin pattern (fz_hi ~ fz_lo), float
    # rho the carried inverse was built with (scalar or [...] batch
    # array): the Woodbury removal in seeded_inverse must size the pin
    # jumps it REMOVES with this value (the jump it ADDs uses the current
    # solve's rho) — mixing carries across rho values is then correct for
    # the pin term instead of silently mis-sized (the base-rho drift on
    # unpinned rows is a smooth O(drho) perturbation the NS polish
    # absorbs). Stored as a batch-shaped array by solve() so the carry
    # pytree stays uniformly batched (chunking/lax.map-safe).
    rho: jnp.ndarray | float = RHO_CONE


def _capacitance_inverse(s_cap: jnp.ndarray,
                         c: jnp.ndarray) -> jnp.ndarray:
    """Exact batched inverse of (I + diag(c) S) on the small [T, T]
    scale via T sequential Sherman-Morrison updates — row k of diag(c) S
    is the rank-1 term c_k e_k S[k, :]. All arithmetic is [T, T]-sized
    elementwise/matvec work (no batched LU, which was measured far slower
    than this scan inside the solve graph on an earlier accelerator — to
    re-check on the card). Exact, so no iteration-count/conditioning
    concerns (a Newton inverse was tried and needs >14 iterations on hard
    capacitances); a singular
    intermediate would surface as non-finite and trips seeded_inverse's
    cold-seed fallback."""
    t = s_cap.shape[-1]

    def body(ainv, k):
        col = jnp.take(ainv, k, axis=-1)                    # A^{-1} e_k
        srow = jnp.take(s_cap, k, axis=-2)                  # S[k, :]
        vrow = jnp.einsum("...j,...jm->...m", srow, ainv)   # S[k,:] A^{-1}
        ck = jnp.take(c, k, axis=-1)
        denom = 1.0 + ck * jnp.take(vrow, k, axis=-1)
        ainv = ainv - (ck / denom)[..., None, None] \
            * col[..., :, None] * vrow[..., None, :]
        return ainv, None

    eye = jnp.broadcast_to(jnp.eye(t, dtype=s_cap.dtype), s_cap.shape)
    ainv, _ = jax.lax.scan(body, eye + 0.0 * s_cap, jnp.arange(t))
    return ainv


def seeded_inverse(m: jnp.ndarray, carry: InverseCarry,
                   d_t_new: jnp.ndarray, gamma_new: jnp.ndarray,
                   pinned_new: jnp.ndarray, rho: float,
                   bf16_iters: int = 4, f32_polish: int = NS_F32_POLISH,
                   fallback_thresh: float = 0.9) -> jnp.ndarray:
    """M^{-1} from the previous cadence step's inverse (see InverseCarry).

    Steps: (1) rescale X through both equilibrations (M ~ D M_prev D on
    the dominant cost term); (2) block Woodbury removing the pinned-row
    rho jumps; (3) one residual-measuring NS step that also selects the
    cold seed I/||M||_inf for batch elements whose corrected seed is
    out of the NS convergence region (pose jumps bigger than a cadence
    step — rare; they get a one-step-degraded inverse, restored at the
    next solve); (4) a short bf16 NS + f32 polish. Accuracy is pinned by
    the chained production-cadence parity gates, not trusted blindly."""
    n = m.shape[-1]
    t = n // 3
    dtype = m.dtype

    # (1) rescale: D^{-1} = (d_prev / d_new) sqrt(gamma_prev / gamma_new).
    s_t = (carry.d_t / d_t_new) \
        * jnp.sqrt(carry.gamma / gamma_new)[..., None]
    s = jnp.repeat(s_t, 3, axis=-1)
    x = s[..., :, None] * carry.m_inv * s[..., None, :]

    # (2) block Woodbury on the flipped fz coordinates (j = 3t+2):
    # (M + U C U^T)^{-1} = X - X U (I + C U^T X U)^{-1} C U^T X.
    # The [T, T] capacitance inverse runs as an exact Sherman-Morrison
    # scan (_capacitance_inverse — avoiding a batched LU).
    rho_old = jnp.asarray(carry.rho, dtype)[..., None]          # [..., 1]
    c = 99.0 * (rho * pinned_new - rho_old * carry.pinned)     # [..., T]
    xu = x[..., :, 2::3]                                    # [..., n, T]
    utx = x[..., 2::3, :]                                   # [..., T, n]
    s_cap = utx[..., :, 2::3]                               # [..., T, T]
    a_inv = _capacitance_inverse(s_cap, c)
    z = jnp.einsum("...ij,...j,...jk->...ik", a_inv, c, utx)
    x = x - jnp.einsum("...nt,...tm->...nm", xu, z)

    # (3) UNCONDITIONAL-convergence damping from a probe-based residual
    # estimate. M X is a product of SPD matrices (the new M times the
    # old inverse, congruence-rescaled and symmetrically
    # Woodbury-updated), so its spectrum is positive; damping the seed
    # by c = 1/(1 + r) puts every eigenvalue of c M X in (0, 1] and
    # Newton-Schulz converges for ANY finite seed residual — there is no
    # divergence cliff and no cold-seed fallback loop (a hard-threshold
    # fallback was tried and gets STUCK: the weak cold+short-polish
    # inverse re-trips the threshold every step once entered — measured
    # on a 40-step chain). The residual is ESTIMATED with k probe
    # matvecs (cost ~n^2 k vs the n^3 of a full ||I - MX|| pass);
    # probes lower-bound the true
    # norm, so the damping margin (x2 on the estimate, headroom in the
    # threshold) covers direction-sampling error — and the steady-state
    # cadence seed sits at ~0.6 where no damping is applied at all.
    # Good seeds skip damping (quadratic contraction untouched);
    # non-finite estimates (true garbage carry) reset to the cold seed.
    probes = jnp.asarray(
        np.sign(np.random.default_rng(7).normal(size=(n, 4))), dtype)
    mx_p = jnp.einsum("...ij,...jk->...ik", x, probes)
    mx_p = jnp.einsum("...ij,...jk->...ik", m, mx_p)
    resid_p = mx_p - probes
    r_est = jnp.max(jnp.sqrt(jnp.sum(resid_p * resid_p, axis=-2))
                    / float(np.sqrt(n)), axis=-1)
    finite = jnp.isfinite(r_est)
    # Damped branch: c = 1 / (||M||_inf ||X||_inf) bounds every
    # eigenvalue of c M X in (0, 1] (positive spectrum x norm bound), so
    # rho(I - c M X) < 1 STRICTLY — guaranteed contraction for any
    # finite seed, however bad (a probe-proportional damping was tried
    # first and under-damps when the residual concentrates in few
    # directions: probes estimate the average, the bound needs the max).
    norminf_m = jnp.max(jnp.sum(jnp.abs(m), axis=-1), axis=-1)
    norminf_x = jnp.max(jnp.sum(jnp.abs(x), axis=-1), axis=-1)
    # The x2 factor IS the claimed sampling-error margin: probes
    # lower-bound the spectral residual, so damping triggers already at
    # an ESTIMATE of thresh/2 (advisor r4 — the margin used to live only
    # in the comment).
    damp = jnp.where(2.0 * r_est < fallback_thresh, 1.0,
                     1.0 / (norminf_m * norminf_x))
    x_cold = jnp.eye(n, dtype=dtype) / norminf_m[..., None, None] \
        + jnp.zeros_like(m)
    x = jnp.where(finite[..., None, None],
                  damp[..., None, None] * x, x_cold)

    # (4) short polish: bf16 contraction + f32 finish (same bodies as
    # newton_schulz_inverse).
    eye2 = 2.0 * jnp.eye(n, dtype=dtype)
    m_bf = m.astype(jnp.bfloat16)

    def body_bf16(x_bf, _):
        inner = eye2 - jnp.einsum("...ij,...jk->...ik", m_bf, x_bf,
                                  preferred_element_type=jnp.float32)
        xn = jnp.einsum("...ij,...jk->...ik", x_bf,
                        inner.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        return xn.astype(jnp.bfloat16), None

    def body_f32(xc, _):
        inner = eye2 - jnp.matmul(m, xc, precision=POLISH_PRECISION)
        return jnp.matmul(xc, inner, precision=POLISH_PRECISION), None

    if bf16_iters > 0:
        x_bf, _ = jax.lax.scan(body_bf16, x.astype(jnp.bfloat16), None,
                               length=bf16_iters)
        x = x_bf.astype(dtype)
    x, _ = jax.lax.scan(body_f32, x, None, length=f32_polish)
    # Post-polish safety clamp: the probe estimate LOWER-bounds the true
    # spectral residual by up to sqrt(n) when the residual concentrates
    # in few directions, so a rare bad seed can still slip past the
    # margin above and diverge in the polish. Non-finite output falls
    # back to the cold seed — crude but finite and SPD-consistent; the
    # next cadence solve re-polishes it (tests/test_minv_reuse.py::
    # test_fallback_stays_finite pins the graceful degradation).
    ok = jnp.all(jnp.isfinite(x), axis=(-2, -1))
    x = jnp.where(ok[..., None, None], x, x_cold)
    return x


def shift_warm_start(x: jnp.ndarray, y: jnp.ndarray,
                     pin_prev: jnp.ndarray, pin_new: jnp.ndarray,
                     n_legs: int = 4):
    """Flip-aware warm start: time-shift (x, y) one horizon step when the
    contact table advanced between cadence solves.

    The 15 ms cadence is half the 30 ms MPC step, so every other solve
    the trot table shifts by one row — the previous solution is then a
    much better warm start SHIFTED one step forward (tail duplicated)
    than in place: the in-place start pins the wrong diagonals and the
    24-iteration budget carries an ~8-11% m*g transient (measured on
    40-step cadence chains; the shift halves the worst case to ~5%).
    Branch-free per batch element: both candidates are formed and the
    shifted one is selected when the new pin pattern matches the shifted
    previous pattern strictly better (and at least one full leg flipped).
    Only meaningful for UNBLOCKED horizons (uniform steps — a move-
    blocked tail has non-uniform group widths).

    x: [..., 12H] primal, y: [..., 4H, 5] duals, pin_*: [..., 4H].
    Returns (x0, y0) to feed `solve`.
    """
    t = pin_prev.shape[-1]
    h = t // n_legs
    batch = x.shape[:-1]

    x_steps = x.reshape(batch + (h, 3 * n_legs))
    x_shift = jnp.concatenate([x_steps[..., 1:, :], x_steps[..., -1:, :]],
                              axis=-2).reshape(x.shape)
    y_steps = y.reshape(batch + (h, n_legs, y.shape[-1]))
    y_shift = jnp.concatenate([y_steps[..., 1:, :, :],
                               y_steps[..., -1:, :, :]],
                              axis=-3).reshape(y.shape)
    pin_steps = pin_prev.reshape(batch + (h, n_legs))
    pin_sh = jnp.concatenate([pin_steps[..., 1:, :], pin_steps[..., -1:, :]],
                             axis=-2).reshape(pin_prev.shape)
    n_flip = jnp.sum(pin_new != pin_prev, axis=-1)
    n_flip_sh = jnp.sum(pin_new != pin_sh, axis=-1)
    use = (n_flip >= n_legs) & (n_flip_sh < n_flip)
    x0 = jnp.where(use[..., None], x_shift, x)
    y0 = jnp.where(use[..., None, None], y_shift, y)
    return x0, y0


def _project(z: jnp.ndarray, fz_lo: jnp.ndarray, fz_hi: jnp.ndarray,
             big: float = 1e8) -> jnp.ndarray:
    """Clip the [., T, 5] constraint values to their bounds: pyramid rows to
    [0, inf), fz row to [fz_lo, fz_hi]."""
    lo = jnp.concatenate([jnp.zeros_like(z[..., :4]), fz_lo[..., None]],
                         axis=-1)
    hi = jnp.concatenate([jnp.full_like(z[..., :4], big), fz_hi[..., None]],
                         axis=-1)
    return jnp.clip(z, lo, hi)


class ConeSolution(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray       # [..., T, 5] duals
    prim_res: jnp.ndarray


def _equilibrate_scales(prob: ConeQP):
    """Per-triple scaling + cost normalization — scales only.

    Never materializes the scaled P: the scaled column maxima needed for
    gamma come from one weighted max pass (max_i |d_i P_ij d_j| =
    d_j max_i(d_i |P_ij|)), so callers can fold gamma*d*d straight into
    their one M-matrix pass.
    """
    n = prob.p.shape[-1]
    t = n // 3
    batch = prob.p.shape[:-2]
    abs_p = jnp.abs(prob.p)
    col_norm = jnp.max(abs_p, axis=-2)                         # [..., n]
    trip_norm = jnp.max(col_norm.reshape(batch + (t, 3)), axis=-1)
    d_t = jnp.where(trip_norm > 1e-12, 1.0 / jnp.sqrt(trip_norm), 1.0)
    d = jnp.repeat(d_t, 3, axis=-1)                            # [..., n]
    wcol = jnp.max(d[..., :, None] * abs_p, axis=-2) * d
    q_d = prob.q * d
    gamma = 1.0 / jnp.clip(
        jnp.maximum(jnp.mean(wcol, axis=-1),
                    jnp.max(jnp.abs(q_d), axis=-1)), 1e-12, 1e12)
    q_s = q_d * gamma[..., None]
    fz_lo = prob.fz_lo / d_t
    fz_hi = prob.fz_hi / d_t
    return q_s, d, d_t, gamma, fz_lo, fz_hi


class ConeSetup(NamedTuple):
    """The equilibrated problem: what the inverse and the ADMM loop read."""

    m: jnp.ndarray         # [..., n, n] gamma d P d + sigma I + A^T rho A
    q_s: jnp.ndarray       # [..., n] scaled linear cost
    d: jnp.ndarray         # [..., n] variable scaling
    d_t: jnp.ndarray       # [..., T] per-triple scale
    gamma: jnp.ndarray     # [...] cost normalization
    fz_lo: jnp.ndarray     # [..., T] scaled bounds
    fz_hi: jnp.ndarray
    pattern: jnp.ndarray   # [..., 5, 3] cone rows
    rho_rows: jnp.ndarray  # [..., T, 5] per-row ADMM penalty
    pinned: jnp.ndarray    # [..., T] 1.0 where fz_hi ~ fz_lo


def setup(prob: ConeQP, rho: float = RHO_CONE,
          sigma: float = SIGMA) -> ConeSetup:
    """Equilibrate the problem and build the ADMM matrix M (one pass)."""
    n = prob.p.shape[-1]
    t = n // 3
    batch = prob.p.shape[:-2]
    dtype = prob.p.dtype

    # --- per-triple scalar equilibration + cost normalization ---
    # Scales only; the scaled P is never materialized — the scaling folds
    # into the single m_mat pass below (materializing it costs extra
    # [B, n, n] passes over memory).
    q_s, d, d_t, gamma, fz_lo, fz_hi = _equilibrate_scales(prob)

    pattern = cone_pattern(prob.mu, dtype)                     # [..., 5, 3]
    pat_t = jnp.swapaxes(pattern, -1, -2)

    # Per-row rho: swing-pinned triples (fz_hi ~ fz_lo) are near-equalities;
    # OSQP-style 100x rho on their fz row makes the pin converge in a few
    # iterations instead of dominating the error (trot contact tables pin
    # half the forces).
    pinned = ((fz_hi - fz_lo) < 1e-6)[..., None]               # [..., T, 1]
    row_template = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0], dtype)
    rho_rows = rho * (1.0 + 99.0 * pinned * row_template)       # [..., T, 5]

    # A^T diag(rho) A per triple: [..., T, 3, 3]
    ata = jnp.einsum("...ir,...tr,...rj->...tij",
                     pat_t, rho_rows, pattern)

    # One fused pass builds M = gamma d P d + sigma I + blockdiag(A^T rho A)
    # (the block-diagonal term scattered via an identity einsum, batch-safe).
    eye_t = jnp.eye(t, dtype=dtype)
    scale = gamma[..., None, None] * d[..., :, None] * d[..., None, :]
    m_mat = scale * prob.p + sigma * jnp.eye(n, dtype=dtype) \
        + jnp.einsum("...tij,tu->...tiuj", ata,
                     eye_t).reshape(batch + (n, n))
    return ConeSetup(m=m_mat, q_s=q_s, d=d, d_t=d_t, gamma=gamma,
                     fz_lo=fz_lo, fz_hi=fz_hi, pattern=pattern,
                     rho_rows=rho_rows, pinned=pinned[..., 0].astype(dtype))


def admm(prob: ConeQP, st: ConeSetup, m_inv: jnp.ndarray, *,
         iters: int = 40, sigma: float = SIGMA, alpha: float = ALPHA,
         x0: jnp.ndarray | None = None, y0: jnp.ndarray | None = None,
         bf16_iters: int = 0, accel_restart: int = 0) -> ConeSolution:
    """The fixed-budget ADMM loop on a set-up problem, given M^{-1}.

    Arguments as in `solve`, which is `setup` + an inverse + this.
    """
    n = prob.p.shape[-1]
    t = n // 3
    batch = prob.p.shape[:-2]
    dtype = prob.p.dtype
    q_s, d, gamma = st.q_s, st.d, st.gamma
    fz_lo, fz_hi = st.fz_lo, st.fz_hi
    pattern, rho_rows = st.pattern, st.rho_rows
    pat_t = jnp.swapaxes(pattern, -1, -2)

    def apply_a(x):
        return jnp.einsum("...ri,...ti->...tr", pattern,
                          x.reshape(batch + (t, 3)))

    def apply_at(w):
        return jnp.einsum("...ir,...tr->...ti", pat_t,
                          w).reshape(batch + (n,))

    x = jnp.zeros_like(q_s) if x0 is None else x0 / d
    z = _project(apply_a(x), fz_lo, fz_hi)
    # (zeros derived from fz_lo so sharding/device-variance matches the
    # scan body under shard_map)
    y = (jnp.zeros(batch + (t, 5), dtype) + 0.0 * fz_lo[..., None]) \
        if y0 is None else y0 * gamma[..., None, None]

    m_inv_bf = m_inv.astype(jnp.bfloat16) if bf16_iters > 0 else None

    def make_body(minv, in_bf16):
        def body(carry, _):
            x, z, y = carry
            rhs = sigma * x - q_s + apply_at(rho_rows * z - y)
            if in_bf16:
                # Split-precision matvec: m_inv streams as bf16 (half the
                # bytes of f32) but
                # rhs is fed as TWO bf16 columns hi/lo with
                # rhs ~= hi + lo, so the recovered product
                # m_inv @ hi + m_inv @ lo carries ~16 mantissa bits of the
                # rhs. Both columns go through ONE batched matmul, so
                # m_inv is still read once. The only error left is the
                # bf16 quantization of m_inv itself (~4e-3 relative on the
                # operator), which shifts the ADMM fixed point by far less
                # than the 40-iteration truncation error (measured: vs the
                # f32 loop, first-step forces move < 0.2 N on the bench
                # ensemble, while naive bf16-rhs moved them by tens of N).
                rhs_hi = rhs.astype(jnp.bfloat16)
                rhs_lo = (rhs - rhs_hi.astype(jnp.float32)) \
                    .astype(jnp.bfloat16)
                pair = jnp.stack([rhs_hi, rhs_lo], axis=-1)
                xt2 = jnp.einsum("...ij,...jk->...ik", minv, pair,
                                 preferred_element_type=jnp.float32)
                x_t = xt2[..., 0] + xt2[..., 1]
            else:
                x_t = jnp.einsum("...ij,...j->...i", minv, rhs,
                                 precision=jax.lax.Precision.HIGHEST)
            z_t = apply_a(x_t)
            x_new = alpha * x_t + (1 - alpha) * x
            z_relaxed = alpha * z_t + (1 - alpha) * z
            z_new = _project(z_relaxed + y / rho_rows, fz_lo, fz_hi)
            y_new = y + rho_rows * (z_relaxed - z_new)
            return (x_new, z_new, y_new), None
        return body

    if accel_restart > 0:
        if bf16_iters > 0:
            raise ValueError("accel_restart requires the f32 loop")

        def body_accel(carry, k):
            # Fast-ADMM: the x/z/y updates read the extrapolated
            # (z_hat, y_hat) instead of (z, y); restart every
            # accel_restart iters resets the momentum schedule.
            x, z, y, z_hat, y_hat, tk = carry
            rhs = sigma * x - q_s + apply_at(rho_rows * z_hat - y_hat)
            x_t = jnp.einsum("...ij,...j->...i", m_inv, rhs,
                             precision=jax.lax.Precision.HIGHEST)
            z_t = apply_a(x_t)
            x_new = alpha * x_t + (1 - alpha) * x
            z_relaxed = alpha * z_t + (1 - alpha) * z_hat
            z_new = _project(z_relaxed + y_hat / rho_rows, fz_lo, fz_hi)
            y_new = y_hat + rho_rows * (z_relaxed - z_new)
            restart = (k % accel_restart) == (accel_restart - 1)
            tk_next = jnp.where(restart, 1.0,
                                0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk * tk)))
            beta = jnp.where(restart, 0.0, (tk - 1.0) / tk_next)
            z_hat_new = z_new + beta * (z_new - z)
            y_hat_new = y_new + beta * (y_new - y)
            return (x_new, z_new, y_new, z_hat_new, y_hat_new, tk_next), None

        tk0 = jnp.asarray(1.0, dtype)
        (x, z, y, *_), _ = jax.lax.scan(body_accel, (x, z, y, z, y, tk0),
                                        jnp.arange(iters))
    else:
        n_bf = min(max(bf16_iters, 0), iters)
        if n_bf > 0:
            (x, z, y), _ = jax.lax.scan(make_body(m_inv_bf, True), (x, z, y),
                                        None, length=n_bf)
        if iters - n_bf > 0:
            (x, z, y), _ = jax.lax.scan(make_body(m_inv, False), (x, z, y),
                                        None, length=iters - n_bf)

    # Unscale.
    x_out = x * d
    y_out = y / gamma[..., None, None]
    ax = jnp.einsum("...ri,...ti->...tr", pattern,
                    x_out.reshape(batch + (t, 3)))
    ax_proj = _project(ax, prob.fz_lo, prob.fz_hi)
    prim = jnp.max(jnp.abs(ax - ax_proj), axis=(-2, -1))
    return ConeSolution(x=x_out, y=y_out, prim_res=prim)


def solve(prob: ConeQP, *, iters: int = 40, rho: float = RHO_CONE,
          sigma: float = SIGMA, alpha: float = ALPHA,
          x0: jnp.ndarray | None = None,
          y0: jnp.ndarray | None = None,
          ns_iters: int = NS_ITERS,
          ns_f32_polish: int = NS_F32_POLISH,
          bf16_iters: int = 0,
          accel_restart: int = 0,
          inv_carry: InverseCarry | None = None,
          seed_bf16_iters: int = 4,
          return_inv_carry: bool = False):
    """Fixed-budget ADMM on the cone QP; batch over leading axes.

    inv_carry / return_inv_carry: cross-cadence M^{-1} reuse (see
    InverseCarry). With a carry from the previous cadence step's solve on
    the SAME scenario, the 11-iteration cold Newton-Schulz inverse is
    replaced by rescale + pinned-row Woodbury + a `seed_bf16_iters`-step
    polish (~2.4x fewer matmul FLOPs on the solve's dominant term). When
    return_inv_carry is True the function returns (ConeSolution, carry)
    instead of the bare solution.

    accel_restart > 0 switches to Fast-ADMM (Goldstein et al.): Nesterov
    momentum on (z, y), restarted every `accel_restart` iterations on a
    fixed period — branch-free, no adaptive residual test in the loop.
    Callers should pass alpha=1.0 with it (momentum and over-relaxation
    together diverge on contact-switching trot instances — measured in
    benchmarks/exp_admm_iters.py; restart=20/alpha=1 at 24 iterations
    beats the relaxed baseline at 40 on both the bench and the
    trot-switch ensembles). The momentum sequence starts at rest, so
    warm starting (x0, y0) composes unchanged. Incompatible with
    bf16_iters (the f32 loop is required).

    ns_f32_polish: trailing f32 Newton-Schulz steps (at POLISH_PRECISION);
    see NS_F32_POLISH for why the default is 2.

    bf16_iters: run the FIRST bf16_iters iterations with the x-update
    matvec in bf16 (f32 accumulation). If the loop is bound by re-reading
    M^{-1} every iteration, a bf16 copy halves that traffic.
    CAUTION — measured on the bench ensemble: the bf16 quantization of
    M^{-1} itself perturbs the ADMM operator by ~4e-3, and the slow
    contraction amplifies that ~100x into tens of N on the solution; a
    hi/lo-split rhs does NOT fix it (the operator, not the rhs, is the
    error source). Keep 0 unless a downstream consumer tolerates ~30%
    force error; retained for ablation and future error-feedback work.
    """
    st = setup(prob, rho, sigma)
    if inv_carry is None:
        m_inv = newton_schulz_inverse(st.m, ns_iters, ns_f32_polish)
    else:
        m_inv = seeded_inverse(st.m, inv_carry, st.d_t, st.gamma, st.pinned,
                               rho, bf16_iters=seed_bf16_iters,
                               f32_polish=ns_f32_polish)
    sol = admm(prob, st, m_inv, iters=iters, sigma=sigma, alpha=alpha,
               x0=x0, y0=y0, bf16_iters=bf16_iters,
               accel_restart=accel_restart)
    if return_inv_carry:
        batch = prob.p.shape[:-2]
        return sol, InverseCarry(m_inv=m_inv, d_t=st.d_t, gamma=st.gamma,
                                 pinned=st.pinned,
                                 rho=jnp.full(batch, rho, prob.p.dtype))
    return sol
