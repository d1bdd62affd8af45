"""Terrain-constrained foothold adjustment (gaps / stairs), batched.

Capability parity with `qrFootStepper`
(quadruped/src/planner/qr_foot_stepper.cpp:30-525) and the terrain-aware
`qrFootholdPlanner::UpdateOnce` path (qr_foothold_planner.cpp:67-109): given
nominal next footholds and a terrain description, shift the step length so no
foot lands inside a gap (plum-pile terrain) and snap foot heights to stair
treads.

Batch-first redesign: the reference solves a sequence of 1-variable QPs with
QuadProg++ until a feasible offset is found (`GetOptimalFootholdsOffset`,
attempts loop :339+). Here feasibility is evaluated for a *static grid of
candidate offsets* in parallel and the minimum-magnitude feasible offset is
selected with an argmin — same optimum (the QP is 1-D with interval
constraints, so the solution lies on a constraint boundary or at zero),
fully vectorized, no iteration.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quadruped_jax.core import struct

# Candidate x-offsets the stepper may add to the nominal step (m).
CANDIDATE_OFFSETS = jnp.linspace(-0.15, 0.15, 61)


def gap_infeasible(x: jnp.ndarray, gap_centers: jnp.ndarray,
                   gap_width) -> jnp.ndarray:
    """[...] 1.0 where world-x lands inside any gap strip."""
    d = jnp.abs(x[..., None] - gap_centers)
    return jnp.any(d < gap_width / 2 + 0.02, axis=-1)  # 2 cm margin


def optimal_foothold_offset(nominal_x: jnp.ndarray,   # [4] world x of footholds
                            gap_centers: jnp.ndarray,  # [G]
                            gap_width) -> jnp.ndarray:
    """[] common x-offset moving all footholds out of gaps
    (GetOptimalFootholdsOffset): smallest |offset| such that every foothold
    is clear."""
    cand = CANDIDATE_OFFSETS
    shifted = nominal_x[None, :] + cand[:, None]           # [C, 4]
    bad = gap_infeasible(shifted, gap_centers, gap_width)  # [C, 4]
    feasible = ~jnp.any(bad, axis=-1)                      # [C]
    cost = jnp.where(feasible, jnp.abs(cand), jnp.inf)
    best = jnp.argmin(cost)
    # If nothing is feasible, keep the nominal step (offset 0).
    return jnp.where(jnp.isfinite(cost[best]), cand[best], 0.0)


def snap_to_stairs(foothold_world: jnp.ndarray,  # [..., 4, 3]
                   step_length, step_height, start_x) -> jnp.ndarray:
    """Snap foothold heights to the stair tread under each (x, y), and nudge
    x away from tread edges (CheckSolution / stair model)."""
    x = foothold_world[..., 0]
    rel = jnp.maximum(x - start_x, 0.0)
    tread = jnp.floor(rel / step_length)
    z = tread * step_height
    # Keep feet >= 3 cm away from the rising edge of the next tread.
    frac = rel - tread * step_length
    near_edge = (frac > step_length - 0.03) & (x > start_x)
    x_adj = jnp.where(near_edge, x - (frac - (step_length - 0.03)), x)
    return jnp.stack([x_adj, foothold_world[..., 1], z], axis=-1)


def adjust_footholds_for_gaps(foothold_world: jnp.ndarray,  # [4, 3]
                              gap_centers: jnp.ndarray,
                              gap_width) -> jnp.ndarray:
    """Apply the common offset to all footholds (UpdateOnce -> stepper)."""
    off = optimal_foothold_offset(foothold_world[:, 0], gap_centers,
                                  gap_width)
    return foothold_world.at[:, 0].add(off)


def plan_step_sequence(current_x: jnp.ndarray,     # [4] world x of feet
                       gap_centers: jnp.ndarray,   # [G]
                       gap_width,
                       default_delta: float = 0.1,
                       n_steps: int = 3):
    """Plan the next `n_steps` step offsets across a gap field.

    The reference's `GetOptimalFootholdsOffset` + `StepGenerator`
    (qr_foot_stepper.cpp:118-180, :483-525) builds a QUEUE of gait-cycle
    offsets up front, with a half-step "cross gait" fallback when no
    common offset clears a gap (flag -1 path: the front/back pair advances
    by delta/2 so the gap sits between diagonal pairs). Batched version: a
    `lax.scan` over the lookahead horizon; each step picks the
    minimum-|offset| feasible candidate in parallel, and when nothing is
    feasible it takes the half-step split instead of iterating.

    Returns (offsets [n_steps, 4], planned_x [n_steps, 4]).
    """
    def step(x, _):
        nominal = x + default_delta
        cand = CANDIDATE_OFFSETS
        shifted = nominal[None, :] + cand[:, None]
        bad = gap_infeasible(shifted, gap_centers, gap_width)
        feasible = ~jnp.any(bad, axis=-1)
        # Keep the step forward-moving (reference rejects stepDeltaX < 0.001
        # and >= MAXIMUM_STEP).
        valid = feasible & (default_delta + cand > 0.001)
        cost = jnp.where(valid, jnp.abs(cand), jnp.inf)
        best = jnp.argmin(cost)
        full_ok = jnp.isfinite(cost[best])
        full_offset = jnp.where(full_ok, cand[best], 0.0) + default_delta

        # Cross-gait fallback: legs FR(0)/RL(3) take a half step so the gap
        # falls between the diagonal pairs.
        half = jnp.asarray([0.5, 1.0, 1.0, 0.5]) * default_delta
        offsets = jnp.where(full_ok, jnp.full((4,), full_offset), half)
        x_new = x + offsets
        return x_new, (offsets, x_new)

    _, (offsets, xs) = jax.lax.scan(step, current_x, None, length=n_steps)
    return offsets, xs


@struct.dataclass
class StairParams:
    """Uniform staircase (reference qrStair: start, width, height, count)."""

    start_x: jnp.ndarray   # [] world x of the first riser
    width: jnp.ndarray     # [] tread depth (m)
    height: jnp.ndarray    # [] riser height (m), > 0 going up
    count: jnp.ndarray     # [] int number of steps


def _tread_index(x: jnp.ndarray, stair: StairParams) -> jnp.ndarray:
    """Which tread (0 = ground before the stairs) each x sits on."""
    k = jnp.floor((x - stair.start_x) / jnp.maximum(stair.width, 1e-6)) + 1.0
    return jnp.clip(k, 0.0, stair.count.astype(x.dtype))


def stair_foothold_adjust(current_x: jnp.ndarray,   # [4] world x of feet
                          stair: StairParams,
                          default_delta: float = 0.1):
    """Stair-climbing foothold coordination (GetFootholdsInWorldFrame
    :208-275 "up" branch, vectorized over legs).

    Each leg's nominal next foothold (current + delta) is adjusted against
    the riser of the NEXT tread: approaching feet hold short of the edge,
    and a foot may climb (x pushed past the riser, z raised one step) only
    when its front/back pair is not behind it and the body would not
    straddle more than one step (front legs at most one tread ahead of the
    rearmost back foot; back legs never ahead of the front pair).

    Returns (next_x [4], dz [4]).
    """
    dtype = current_x.dtype
    k = _tread_index(current_x, stair)          # [4] current tread per foot
    nominal = current_x + default_delta
    # x-position of the riser between tread k and k+1.
    riser = stair.start_x + k * stair.width
    on_top = k >= stair.count.astype(dtype)     # past the staircase

    rel = nominal - riser
    pair = jnp.asarray([1, 0, 3, 2])            # same-end partner leg
    k_pair = k[pair]
    max_back = jnp.maximum(k[2], k[3])
    min_front = jnp.minimum(k[0], k[1])
    is_front = jnp.asarray([1.0, 1.0, 0.0, 0.0], dtype)
    may_climb = (k <= k_pair) & jnp.where(
        is_front > 0.5, k <= max_back + 1.0, k < min_front)

    # Window cases (reference :229-243): hold-short bands, then the climb
    # window where coordination decides climb vs wait.
    x_adj = nominal
    x_adj = jnp.where((rel > -0.10) & (rel < -0.05), riser - 0.08, x_adj)
    x_adj = jnp.where((rel >= -0.05) & (rel < 0.02), riser - 0.05, x_adj)
    in_climb = (rel >= 0.02) & (rel < 0.07) & ~on_top
    x_adj = jnp.where(in_climb & may_climb, riser + 0.05, x_adj)
    x_adj = jnp.where(in_climb & ~may_climb, riser - 0.04, x_adj)
    dz = jnp.where(in_climb & may_climb, stair.height, 0.0).astype(dtype)
    return x_adj, dz


def gap_foothold_adjust(nominal_x: jnp.ndarray,     # [..., 4] world x
                        gap_centers: jnp.ndarray,    # [G]
                        gap_width,
                        margin: float = 0.03,
                        current_x: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-leg gap clearance for the walk/trot foothold hook.

    The queue-based planner (plan_step_sequence) is the reference's
    offline shape (qr_foot_stepper.cpp:483-525 StepGenerator); in the
    CLOSED loop each step's nominal foothold is known only at swing time,
    so the hook form snaps any foothold landing inside a gap strip to an
    edge (+/- (width/2 + margin)): the NEAR edge while the body
    approaches (hold short), the FAR edge once the advancing nominal
    passes the gap center (cross in one stride).

    Pair coordination (pass `current_x`, the feet's current world x):
    once a leg's same-end partner has already crossed a gap, the leg
    crosses on its NEXT swing instead of holding — without this, the
    still-holding leg of a pair runs out of stance workspace while the
    body advances over the staggered walk cycle and the robot tips
    (measured; the stair path's pair-coordinated climb windows solve the
    same geometry, stair_foothold_adjust). Disjoint strips only
    (terrain.gaps geometry).
    """
    d = nominal_x[..., None] - gap_centers                 # [..., 4, G]
    half = gap_width / 2 + margin
    inside = jnp.abs(d) < half
    far = gap_centers + half
    cross = d >= 0.0
    if current_x is not None:
        pair = jnp.asarray([1, 0, 3, 2])
        partner_x = current_x[..., pair]                   # [..., 4]
        cross = cross | (partner_x[..., None] > far)
    snapped = jnp.where(cross, far, gap_centers - half)
    any_in = jnp.any(inside, axis=-1)
    idx = jnp.argmax(inside, axis=-1)
    x_snap = jnp.take_along_axis(snapped, idx[..., None], axis=-1)[..., 0]
    return jnp.where(any_in, x_snap, nominal_x)
