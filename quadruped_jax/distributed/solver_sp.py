"""Solver-parallel (sp-axis) cone-QP solve: the [12H] force axis sharded.

`cone_qp.solve` re-reads M^{-1} ([B, n, n]) from device memory every ADMM
iteration. This variant partitions the VARIABLE axis (n = 12H forces =
4H per-leg triples) across the mesh's `sp` axis under shard_map:

  * each sp member streams only its n/sp COLUMN block of M^{-1} per
    iteration — per-device memory traffic for the loop divides by sp;
  * the x-update matvec becomes a partial product + one `psum` of the
    [B_local, n] iterate over `sp` per iteration (the "QP block
    reduction" of BASELINE.json, over NVLink between GPUs);
  * constraint work (cone projection, duals, rho rows) stays local to
    each member's 4H/sp force triples — no communication;
  * the batch axis stays sharded over `dp` (zero-communication scenario
    parallelism, the throughput axis).

STATUS (measured, round 4): this axis is correctness-proven but has not
won in ANY regime tried — on the virtual CPU mesh, sp=4 is ~3x slower
than sp=1 at the H=10 fleet config, and sp=2/4 are 2-2.6x
slower on the H=16 move-blocked system (n=132) at batches 8 and 64
(benchmarks round-4 sweep). The per-iteration [B, n] psum dominates the
matvec savings at these problem sizes. The hypothetical winning regime —
per-GPU memory genuinely unable to hold the batch's M^{-1}, with the psum
riding real NVLink rather than emulated host collectives — is not
measured across GPUs yet; until measured there, treat
sp=1 (the make_mesh default) as the correct choice everywhere and this
module as the tested mechanism, not a recommendation.

Equilibration and the Newton-Schulz inverse are computed replicated
across sp (they run once per solve; the loop re-reads M^{-1} `iters`
times, so the loop is where sharding pays).

Semantics match `cone_qp.solve` (same splitting, scaling, pinned-row rho
boost, Fast-ADMM momentum) — parity is tested shard-vs-unsharded in
tests/test_solver_sp.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from quadruped_jax.solvers import cone_qp
from quadruped_jax.solvers.cone_qp import (ConeQP, ConeSolution, SIGMA,
                                           ALPHA, RHO_CONE, NS_ITERS,
                                           NS_F32_POLISH)


def solve_cone_sp(mesh, prob: ConeQP, *, iters: int = 24,
                  rho: float = RHO_CONE, sigma: float = SIGMA,
                  alpha: float = 1.0, accel_restart: int = 20,
                  x0: jnp.ndarray | None = None,
                  y0: jnp.ndarray | None = None,
                  ns_iters: int = NS_ITERS,
                  ns_f32_polish: int = NS_F32_POLISH) -> ConeSolution:
    """Sharded solve over a ("dp", "sp") mesh.

    prob leaves carry one leading batch axis [B]; B must divide the dp
    axis size, and the triple count T = n/3 must divide the sp axis size.
    mu must be a scalar (shared across the batch). Warm starts x0 [B, n]
    and y0 [B, T, 5] shard like the problem.

    The jitted sharded kernel is cached per (mesh, config, problem
    shape) — repeated calls (the 1 kHz fleet loop this module serves)
    hit the cache instead of retracing.
    """
    b, n, _ = prob.p.shape
    assert prob.mu.ndim == 0, "solve_cone_sp needs a scalar mu"
    if x0 is None:
        x0 = jnp.zeros((b, n), prob.p.dtype)
    if y0 is None:
        y0 = jnp.zeros((b, n // 3, 5), prob.p.dtype)
    fn = _build_solver(mesh, b, n, prob.p.dtype.name, iters, rho, sigma,
                       alpha, accel_restart, ns_iters, ns_f32_polish)
    x, y, prim = fn(prob.p, prob.q, prob.mu, prob.fz_lo, prob.fz_hi,
                    x0, y0)
    return ConeSolution(x=x, y=y, prim_res=prim)


@lru_cache(maxsize=64)
def _build_solver(mesh, b: int, n: int, dtype_name: str, iters: int,
                  rho: float, sigma: float, alpha: float,
                  accel_restart: int, ns_iters: int, ns_f32_polish: int):
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    t = n // 3
    assert b % dp == 0, (b, dp)
    assert t % sp == 0, (t, sp)
    t_loc = t // sp
    n_loc = 3 * t_loc

    batch_spec = P("dp")       # replicated over sp, sharded over dp
    scalar_spec = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(batch_spec, batch_spec, scalar_spec, batch_spec,
                       batch_spec, batch_spec, batch_spec),
             out_specs=(batch_spec, batch_spec, batch_spec),
             check_vma=False)
    def shard_solve(p, q, mu, fz_lo, fz_hi, x_init, y_init):
        bl = p.shape[0]
        dtype = p.dtype
        prob_l = ConeQP(p=p, q=q, mu=mu, fz_lo=fz_lo, fz_hi=fz_hi)
        q_s, d, d_t, gamma, fz_lo_s, fz_hi_s = \
            cone_qp._equilibrate_scales(prob_l)

        pattern = cone_qp.cone_pattern(mu, dtype)           # [5, 3]
        pat_t = jnp.swapaxes(pattern, -1, -2)
        pinned = ((fz_hi_s - fz_lo_s) < 1e-6)[..., None]
        row_template = jnp.asarray([0, 0, 0, 0, 1.0], dtype)
        rho_rows = rho * (1.0 + 99.0 * pinned * row_template)  # [bl, t, 5]

        # M and its inverse: replicated across sp (one-off cost).
        ata = jnp.einsum("ir,...tr,rj->...tij", pat_t, rho_rows, pattern)
        eye_t = jnp.eye(t, dtype=dtype)
        scale = gamma[..., None, None] * d[..., :, None] * d[..., None, :]
        m_mat = scale * p + sigma * jnp.eye(n, dtype=dtype) \
            + jnp.einsum("...tij,tu->...tiuj", ata,
                         eye_t).reshape(bl, n, n)
        m_inv = cone_qp.newton_schulz_inverse(m_mat, ns_iters, ns_f32_polish)

        # Column block + local triple slices for this sp member.
        k = jax.lax.axis_index("sp")
        col0 = k * n_loc
        trip0 = k * t_loc
        m_inv_cols = jax.lax.dynamic_slice(
            m_inv, (0, 0, col0), (bl, n, n_loc))        # [bl, n, n_loc]

        def trip_slice(a):                               # [bl, t, ...] local
            return jax.lax.dynamic_slice_in_dim(a, trip0, t_loc, axis=1)

        def var_slice(a):                                # [bl, n] local
            return jax.lax.dynamic_slice_in_dim(a, col0, n_loc, axis=1)

        rho_loc = trip_slice(rho_rows)
        fz_lo_loc, fz_hi_loc = trip_slice(fz_lo_s), trip_slice(fz_hi_s)
        q_loc = var_slice(q_s)

        def apply_a_loc(x_loc):
            return jnp.einsum("ri,bti->btr", pattern,
                              x_loc.reshape(bl, t_loc, 3))

        def apply_at_loc(w_loc):
            return jnp.einsum("ir,btr->bti", pat_t,
                              w_loc).reshape(bl, n_loc)

        # Scaled warm starts; z from the local projection of A x.
        x_full = x_init / d
        y_loc = trip_slice(y_init * gamma[..., None, None])
        z_loc = cone_qp._project(apply_a_loc(var_slice(x_full)),
                                 fz_lo_loc, fz_hi_loc)

        def x_update(x_full, zz_loc, yy_loc):
            """Sharded x-step: local rhs slice -> partial matvec -> psum."""
            rhs_loc = sigma * var_slice(x_full) - q_loc \
                + apply_at_loc(rho_loc * zz_loc - yy_loc)
            part = jnp.einsum("bnc,bc->bn", m_inv_cols, rhs_loc,
                              precision=jax.lax.Precision.HIGHEST)
            return jax.lax.psum(part, "sp")              # [bl, n]

        if accel_restart > 0:
            def body(carry, kk):
                x, z, y, z_hat, y_hat, tk = carry
                x_t = x_update(x, z_hat, y_hat)
                z_t = apply_a_loc(var_slice(x_t))
                x_new = alpha * x_t + (1 - alpha) * x
                z_rel = alpha * z_t + (1 - alpha) * z_hat
                z_new = cone_qp._project(z_rel + y_hat / rho_loc,
                                         fz_lo_loc, fz_hi_loc)
                y_new = y_hat + rho_loc * (z_rel - z_new)
                restart = (kk % accel_restart) == (accel_restart - 1)
                tk_next = jnp.where(
                    restart, 1.0,
                    0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk * tk)))
                beta = jnp.where(restart, 0.0, (tk - 1.0) / tk_next)
                z_hat_new = z_new + beta * (z_new - z)
                y_hat_new = y_new + beta * (y_new - y)
                return (x_new, z_new, y_new, z_hat_new, y_hat_new,
                        tk_next), None

            tk0 = jnp.asarray(1.0, dtype)
            (x_full, z_loc, y_loc, *_), _ = jax.lax.scan(
                body, (x_full, z_loc, y_loc, z_loc, y_loc, tk0),
                jnp.arange(iters))
        else:
            def body(carry, _):
                x, z, y = carry
                x_t = x_update(x, z, y)
                z_t = apply_a_loc(var_slice(x_t))
                x_new = alpha * x_t + (1 - alpha) * x
                z_rel = alpha * z_t + (1 - alpha) * z
                z_new = cone_qp._project(z_rel + y / rho_loc,
                                         fz_lo_loc, fz_hi_loc)
                y_new = y + rho_loc * (z_rel - z_new)
                return (x_new, z_new, y_new), None

            (x_full, z_loc, y_loc), _ = jax.lax.scan(
                body, (x_full, z_loc, y_loc), None, length=iters)

        x_out = x_full * d
        y_full = jax.lax.all_gather(y_loc, "sp", axis=1, tiled=True)
        y_out = y_full / gamma[..., None, None]
        ax_loc = apply_a_loc(var_slice(x_out))
        ax_proj = cone_qp._project(ax_loc, trip_slice(prob_l.fz_lo),
                                   trip_slice(prob_l.fz_hi))
        prim_loc = jnp.max(jnp.abs(ax_loc - ax_proj), axis=(-2, -1))
        prim = jax.lax.pmax(prim_loc, "sp")
        return x_out, y_out, prim

    return jax.jit(shard_solve)
