"""Walk-mode base pose planner, batched.

Capability parity with `qrPosePlanner`
(quadruped/src/planner/qr_pose_planner.cpp, header
include/quadruped/planner/qr_pose_planner.h:44-458): during the walk gait's
move-base window, plan a 6-D base pose target over the upcoming support
polygon (contact feet in CCW order) and serve interpolated intermediate
pose/twist setpoints to the stance controller
(`GetIntermediateBasePose` :327, :345).

Two planners are provided:

  * `plan_target_pose` — the support-centroid heuristic (the fixed point
    the full optimization converges to on flat ground); cheap, used when
    fidelity off flat ground is not needed.
  * `plan_target_pose_sqp` — the reference's full optimization
    (Update :71-249): minimize sum of squared virtual leg stretches
    + omega * CoM-to-support-centroid distance over the 6-D pose
    (translation + so3 increment), subject to the CoM staying inside the
    eps-shrunk support polygon (CCW vertices, concave quad closure) and
    per-leg hip-to-foot lengths in [l_min, l_max]. Solved as the same
    SQP — quadratic model of the Lagrangian with the analytic gradients/
    Hessians of ComputeGradientF/ComputeHessianF/ComputeGradientG/
    ComputeHessianG/ComputeG (:270-444) — but with the batched ADMM QP
    (solvers/qp.py) in place of QuadProg++ and masked static shapes in
    place of conservativeResize, so a whole scenario batch plans in one
    jitted call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quadruped_jax.core import se3, splines
from quadruped_jax.core import struct
from quadruped_jax.robots.params import RobotParams
from quadruped_jax.solvers import qp as qp_mod

# Leg order around the body used by the reference's polygon construction
# (ToCounterClockOrder perm {0,2,3,1}: FR, RR, RL, FL).
CCW_ORDER = jnp.asarray([0, 2, 3, 1])
OMEGA = 0.5       # CoM-centroid objective weight (qr_pose_planner.h:266)
EPS_SHRINK = 0.1  # support-polygon shrink factor (:271)
L_MIN = 0.22      # virtual leg length bounds (:155, :160)
L_MAX = 0.35
BIG = 1e7


@struct.dataclass
class PosePlannerState:
    pose_start: jnp.ndarray    # [6] (xyz, rpy) at plan start, world
    pose_target: jnp.ndarray   # [6]
    planned: jnp.ndarray       # [] 1.0 once a plan is latched


def pose_planner_init() -> PosePlannerState:
    return PosePlannerState(
        pose_start=jnp.zeros(6, jnp.float32),
        pose_target=jnp.zeros(6, jnp.float32),
        planned=jnp.zeros((), jnp.float32))


def plan_target_pose(params: RobotParams,
                     base_position: jnp.ndarray,     # [3] world
                     base_rpy: jnp.ndarray,          # [3]
                     foot_positions_world: jnp.ndarray,  # [4, 3]
                     support_mask: jnp.ndarray,      # [4] legs staying in stance
                     ground_rpy: jnp.ndarray,        # [3] control-frame rpy
                     body_height) -> jnp.ndarray:
    """[6] target pose: CoM over the weighted support centroid, ground
    aligned (ResetBasePose / Update semantics)."""
    n = jnp.maximum(jnp.sum(support_mask), 1.0)
    centroid = jnp.sum(foot_positions_world * support_mask[:, None],
                       axis=0) / n
    target_xy = centroid[:2] + params.com_offset[:2]
    target_z = centroid[2] + body_height
    target_rpy = jnp.stack([ground_rpy[0], ground_rpy[1], base_rpy[2]])
    return jnp.concatenate([jnp.stack([target_xy[0], target_xy[1], target_z]),
                            target_rpy])


def _so3_quat(phi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so3 -> unit quaternion (robotics::math::so3ToQuat)."""
    angle = jnp.linalg.norm(phi)
    safe = jnp.maximum(angle, 1e-9)
    axis = phi / safe
    half = 0.5 * angle
    return jnp.concatenate([jnp.cos(half)[None], axis * jnp.sin(half)])


def _polygon_rows(verts_xy: jnp.ndarray, valid: jnp.ndarray,
                  eps: float):
    """Edge half-plane rows of the shrunk support polygon.

    verts_xy [4, 2] CCW-ordered candidate vertices, valid [4] mask.
    Returns (a_sp [4, 2], b_sp [4], row_valid [4]) with
    a_sp . x >= b_sp the polygon interior (reference ComputeG :396-428);
    rows of invalid vertices are masked. Each valid vertex connects to
    the NEXT valid vertex in the cyclic order — the masked-static
    equivalent of erasing dropped vertices from the list."""
    n = jnp.maximum(jnp.sum(valid), 1.0)
    center = jnp.sum(verts_xy * valid[:, None], axis=0) / n
    shrunk = center + (1.0 - eps) * (verts_xy - center)

    # next valid index after i (cyclic): smallest k in 1..4 with
    # valid[(i+k) % 4].
    idx = jnp.arange(4)
    offs = jnp.arange(1, 5)
    cand = (idx[:, None] + offs[None, :]) % 4          # [4, 4]
    ok = valid[cand] > 0.5                             # [4, 4]
    first = jnp.argmax(ok, axis=1)                     # [4]
    nxt = cand[idx, first]

    a = shrunk
    b = shrunk[nxt]
    rows = jnp.stack([b[:, 1] - a[:, 1], a[:, 0] - b[:, 0]], axis=-1)
    bs = a[:, 0] * b[:, 1] - b[:, 0] * a[:, 1]
    return rows, bs, valid


def _drop_concave_vertex(verts_xy: jnp.ndarray,
                         valid: jnp.ndarray) -> jnp.ndarray:
    """Reference Update :139-168: with four contacts, if the quad is not
    convex (one vertex inside the triangle of the others), drop the
    offending vertex. Branch-free: computes both cross-product checks for
    sourceId 1, 2 and masks the first failing vertex."""
    four = jnp.sum(valid) > 3.5

    def checks(source_id):
        dest = (source_id + 2) % 4
        pos, neg = source_id - 1, (source_id + 1) % 4
        s, d = verts_xy[source_id], verts_xy[dest]
        cp = verts_xy[pos]
        cn = verts_xy[neg]
        cross_p = ((d[0] - s[0]) * (cp[1] - s[1])
                   - (d[1] - s[1]) * (cp[0] - s[0]))
        cross_n = ((d[0] - s[0]) * (cn[1] - s[1])
                   - (d[1] - s[1]) * (cn[0] - s[0]))
        return cross_p, cross_n, pos, neg

    cp1, cn1, p1, n1 = checks(1)
    cp2, cn2, p2, n2 = checks(2)
    # First failing check wins, as in the sequential loop.
    invalid = jnp.where(
        cp1 > 0, p1,
        jnp.where(cn1 < 0, n1,
                  jnp.where(cp2 > 0, p2,
                            jnp.where(cn2 < 0, n2, -1))))
    drop = four & (invalid >= 0)
    return jnp.where(drop & (jnp.arange(4) == invalid), 0.0, valid)


def plan_target_pose_sqp(params: RobotParams,
                         base_position: jnp.ndarray,      # [3] world
                         base_rpy: jnp.ndarray,           # [3]
                         foot_positions_world: jnp.ndarray,  # [4, 3]
                         support_mask: jnp.ndarray,       # [4]
                         ground_rpy: jnp.ndarray,         # [3]
                         body_height,
                         *, omega: float = OMEGA, eps: float = EPS_SHRINK,
                         l_min: float = L_MIN, l_max: float = L_MAX,
                         omega_rot: float = 1.0,
                         sqp_iters: int = 10,
                         qp_iters: int = 60) -> jnp.ndarray:
    """[6] optimized target pose (reference qrPosePlanner::Update).

    Decision variables per SQP step: p = [d_rIB (3), d_phi (3)] with the
    orientation updated multiplicatively quat <- exp(d_phi) * quat.
    Constraint rows (masked to the valid contact set): support-polygon
    half-planes on the CoM, and l_min <= |g_i| <= l_max on the virtual
    hip-to-foot legs g_i = rIB + R(q) rBH_i - rIF_i.

    omega_rot anchors the orientation to the ground frame (roll/pitch
    from ground_rpy, yaw held). The reference objective leaves
    orientation UNREGULARIZED — its stretch term re-linearizes to zero
    every iterate, so asymmetric support patterns inject rotation through
    the Hessian cross terms and the planned roll wanders to tenths of a
    radian (its trailing pitch-average :246-248 patches only pitch).
    With the anchor, flat ground plans level poses, slopes plan
    ground-aligned ones, and the leg-length constraints can still tilt
    the base through their multipliers when feasibility demands it.
    """
    quat0 = se3.rpy_to_quat(base_rpy)
    # CCW reorder (ToCounterClockOrder).
    r_if = foot_positions_world[CCW_ORDER]            # [4, 3]
    valid0 = support_mask[CCW_ORDER]
    r_bh = params.hip_offset[CCW_ORDER]               # [4, 3]
    r_bf_world = r_if - base_position                 # for stretch objective

    valid = _drop_concave_vertex(r_if[:, :2], valid0)
    n_c = jnp.maximum(jnp.sum(valid), 1.0)

    # Support-centroid target rSP (Update :131-137): projected contact
    # mean blended 2:1 with the all-feet centroid; height = mean contact
    # foot height + body height (the reference's absolute bodyHight,
    # generalized to non-zero terrain).
    contact_mean = jnp.sum(r_if * valid[:, None], axis=0) / n_c
    all_mean = jnp.mean(r_if, axis=0)
    r_sp = contact_mean * (2.0 / 3.0) + all_mean / 3.0
    r_sp = r_sp.at[2].set(contact_mean[2] + body_height)

    a_sp, b_sp, poly_valid = _polygon_rows(r_if[:, :2], valid, eps)
    a_sp3 = jnp.concatenate([a_sp, jnp.zeros((4, 1))], axis=-1)  # [4,3]

    # Foot positions in the CURRENT base frame (fixed over the SQP; the
    # reference recomputes rBF from rIF each iterate — identical since
    # rIB + R rBF == rIF is re-established after every update).
    def body(carry, _):
        r_ib, quat, lam = carry
        r = se3.quat_to_rotmat(quat)
        # rBF such that rIB + R rBF tracks the measured feet: the stretch
        # residual r1_i = rIB + R rBF_i - rIF_i where rBF is the foot in
        # the CURRENT estimated base frame (Update :201).
        r_bf = jnp.einsum("ji,lj->li", r, r_if - r_ib)
        r_world = jnp.einsum("ij,lj->li", r, r_bf)    # == r_if - r_ib
        r1 = (r_ib + r_world - r_if) * valid[:, None]

        # g_i = rIB + R rBH_i - rIF_i  (virtual leg, hip to foot).
        r_ibh = jnp.einsum("ij,lj->li", r, r_bh)
        g = r_ib + r_ibh - r_if                       # [4, 3]
        g_norm = jnp.maximum(jnp.linalg.norm(g, axis=-1), 1e-6)
        g_hat = g / g_norm[:, None]

        # --- objective quadratic model (ComputeGradientF/HessianF) ---
        grad_t = jnp.sum(r1, axis=0)
        grad_w = jnp.sum(jnp.cross(r_world, r_ib - r_if) * valid[:, None],
                         axis=0)
        com_err = r_ib - r_sp                         # rICOMoffset = 0
        grad_t = grad_t + omega * com_err
        # Orientation anchor: world-frame so3 error toward the ground
        # frame (roll/pitch of ground_rpy, current yaw preserved).
        rpy_now = se3.quat_to_rpy(quat)
        r_anchor = se3.rpy_to_rotmat(
            jnp.stack([ground_rpy[0], ground_rpy[1], rpy_now[2]]))
        phi_err = se3.so3_log(r @ r_anchor.T)
        grad_w = grad_w + omega_rot * phi_err
        grad_f = 2.0 * jnp.concatenate([grad_t, grad_w])

        skews = jax.vmap(se3.skew)(r_world)           # [4, 3, 3]
        h_tt = jnp.eye(3) * (n_c + omega)
        h_tw = -jnp.sum(skews * valid[:, None, None], axis=0)
        d_mats = jax.vmap(
            lambda ri, sk: 0.5 * ((se3.skew(r_ib - ri) @ sk)
                                  + sk @ se3.skew(r_ib - ri)))(r_if, skews)
        h_ww = jnp.sum(d_mats * valid[:, None, None], axis=0) \
            + omega_rot * jnp.eye(3)
        hess_f = 2.0 * jnp.block([[h_tt, h_tw], [-h_tw, h_ww]])

        # --- constraint values + Jacobians (ComputeG/GradientG) ---
        g_poly = (a_sp3 @ r_ib - b_sp)                # [4]
        g_lo = g_norm - l_min
        g_hi = l_max - g_norm
        g_val = jnp.concatenate([g_poly, g_lo, g_hi])

        j_poly = jnp.concatenate([a_sp3, jnp.zeros((4, 3))], axis=-1)
        j_len_t = g_hat
        j_len_w = -jnp.einsum("li,lij->lj", g_hat,
                              jax.vmap(se3.skew)(r_ibh))
        j_len = jnp.concatenate([j_len_t, j_len_w], axis=-1)
        jac = jnp.concatenate([j_poly, j_len, -j_len], axis=0)  # [12, 6]

        # --- Lagrangian Hessian (ComputeHessianG, length rows only; the
        # polygon rows are linear in p since rICOMoffset = 0) ---
        def len_hess(gi, gn, ribh_i, rif_i):
            ghat = gi / gn
            p_tt = (jnp.eye(3) - jnp.outer(ghat, ghat)) / gn
            sk_h = se3.skew(ribh_i)
            p_tw = -p_tt @ sk_h
            dgdphi = -ghat @ sk_h
            dh = 0.5 * (se3.skew(r_ib - rif_i) @ sk_h
                        + sk_h @ se3.skew(r_ib - rif_i))
            p_ww = (0.5 * dh - jnp.outer(dgdphi, dgdphi)) / gn
            return jnp.block([[p_tt, p_tw], [-p_tw.T, p_ww]])

        h_len = jax.vmap(len_hess)(g, g_norm, r_ibh, r_if)     # [4, 6, 6]
        lam_lo = lam[4:8]
        lam_hi = lam[8:12]
        hess_g = jnp.einsum("l,lij->ij", (lam_lo - lam_hi) * valid, h_len)

        # --- masked QP:  min 1/2 p^T H p + gradF^T p
        #                 s.t. jac p >= -g_val (valid rows) ---
        row_valid = jnp.concatenate([poly_valid, valid, valid])
        h_mat = hess_f - hess_g
        # PD safeguard (QuadProg++ requires PD; SQP Hessians need not be):
        # shift by the most negative eigenvalue.
        eig_min = jnp.min(jnp.linalg.eigvalsh(h_mat))
        h_mat = h_mat + jnp.maximum(0.0, 1e-3 - eig_min) * jnp.eye(6)
        lo = jnp.where(row_valid > 0.5, -g_val, -BIG)
        sol = qp_mod.admm_solve(h_mat, grad_f, jac, lo,
                                jnp.full((12,), BIG), iters=qp_iters)
        p = sol.x
        lam_new = jnp.maximum(-sol.y, 0.0) * row_valid

        r_ib_new = r_ib + p[:3]
        quat_new = se3.quat_mul(_so3_quat(p[3:]), quat)
        quat_new = quat_new / jnp.linalg.norm(quat_new)
        return (r_ib_new, quat_new, lam_new), None

    lam0 = jnp.full((12,), 0.1)
    (r_ib, quat, _), _ = jax.lax.scan(
        body, (base_position, quat0, lam0), None, length=sqp_iters)

    rpy = se3.quat_to_rpy(quat)
    # Pitch blended with the ground pitch (Update :246-248).
    rpy = rpy.at[1].set(0.5 * (rpy[1] + ground_rpy[1]))
    return jnp.concatenate([r_ib, rpy])


def pose_planner_update(state: PosePlannerState, params: RobotParams,
                        *,
                        base_position: jnp.ndarray,
                        base_rpy: jnp.ndarray,
                        foot_positions_world: jnp.ndarray,
                        support_mask: jnp.ndarray,
                        ground_rpy: jnp.ndarray,
                        body_height,
                        replan: jnp.ndarray,
                        use_sqp: bool = True) -> PosePlannerState:
    """Latch a new plan when `replan` fires (walk gait's stop-semaphore /
    move-base start, qr_locomotion_controller.cpp:90-105).

    use_sqp=True runs the reference's support-polygon optimization
    (plan_target_pose_sqp) — required fidelity on slopes/irregular
    support; False keeps the flat-ground centroid heuristic.

    The SQP is gated behind lax.cond on the replan trigger: in the
    unbatched (hardware / single-scenario) path it only runs at replan
    instants (a few times per 10 s walk cycle) instead of every 500 Hz
    tick. Under vmap the cond lowers to a select and both branches run —
    the batched cost is unchanged, the latch semantics identical."""
    do = (replan > 0.5) | (state.planned < 0.5)
    if use_sqp:

        def run_sqp(_):
            return plan_target_pose_sqp(params, base_position, base_rpy,
                                        foot_positions_world, support_mask,
                                        ground_rpy, body_height)

        target = jax.lax.cond(do, run_sqp,
                              lambda _: state.pose_target, None)
    else:
        target = plan_target_pose(params, base_position, base_rpy,
                                  foot_positions_world, support_mask,
                                  ground_rpy, body_height)
    current = jnp.concatenate([base_position, base_rpy])
    return PosePlannerState(
        pose_start=jnp.where(do, current, state.pose_start),
        pose_target=jnp.where(do, target, state.pose_target),
        planned=jnp.ones((), jnp.float32))


def intermediate_base_pose(state: PosePlannerState, phase: jnp.ndarray):
    """(pose [6], twist [6]) at `phase` in [0, 1] along the planned segment
    (GetIntermediateBasePose :327-345) — cubic with zero end velocities."""
    zeros = jnp.zeros_like(state.pose_start)
    pose, vel = splines.cubic_hermite(state.pose_start, zeros,
                                      state.pose_target, zeros,
                                      phase[..., None])
    return pose, vel
