"""13-state single-rigid-body (SRB) model for convex MPC, batched.

Capability parity with the reference's continuous-time state-space build and
discretization (quadruped/src/controllers/mpc/qr_mpc_interface.cpp:296
`ComputeContinuousTimeStateSpaceMatrices`, :257 `ConvertToDiscreteQP`), with a
batch-first change: the reference discretizes by exponentiating a 25x25
[[A,B],[0,0]] block matrix (Eigen unsupported `MatrixFunctions::exp`). The
continuous A here is nilpotent of degree 3 (and A^2 B = 0), so zero-order-hold
has an *exact closed form*:

    Ad = I + A dt + A^2 dt^2/2
    Bd = B dt + A B dt^2/2

No series truncation, no expm — bitwise-stable in f32 and fully batched.

State layout (matches the reference MPC):
    x = [roll, pitch, yaw, px, py, pz, wx, wy, wz, vx, vy, vz, g]
with w, v in the *world* frame and the 13th state pinned to gravity
(g = -9.8, the reference's SolveMPC constant at qr_mpc_interface.cpp:362)
so dynamics stay homogeneous. Controls u = 4 x 3 world-frame ground-reaction
forces.

Orientation coupling: the reference passes the FULL body->world rotation as
`yawRotMat` (SolveMPCKernel :352 sets yawRotMat = rotMat), so I_world =
R I R^T and d(rpy)/dt = R^T w use the full R, not just the yaw rotation —
`srb_continuous` therefore takes a rotation matrix.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from quadruped_jax.core import se3

NX = 13
NU = 12
GRAVITY = -9.8  # reference MPC constant (9.81 is used for fMax only)


def world_inertia(inertia_body: jnp.ndarray, rot: jnp.ndarray) -> jnp.ndarray:
    """World-frame inertia I_w = R I_body R^T, [..., 3, 3]."""
    return se3.matmul3(se3.matmul3(rot, inertia_body),
                       jnp.swapaxes(rot, -1, -2))


def srb_continuous(
    rot: jnp.ndarray,            # [..., 3, 3] body->world rotation, or [...] yaw
    inertia_body: jnp.ndarray,   # [..., 3, 3]
    mass: jnp.ndarray,           # [...]
    r_feet: jnp.ndarray,         # [..., 4, 3] foot positions relative to CoM, world frame
):
    """Continuous-time (A, B): [..., 13, 13], [..., 13, 12].

    `rot` may be a full rotation matrix (reference semantics) or a scalar
    yaw angle (classic MIT yaw-only model) — scalars are promoted to
    Rz(yaw).
    """
    if rot.ndim < 2 or rot.shape[-1] != 3:
        rot = se3.rot_z(rot)
    batch = jnp.broadcast_shapes(
        rot.shape[:-2], inertia_body.shape[:-2], mass.shape,
        r_feet.shape[:-2])
    dtype = r_feet.dtype

    # Assemble A/B from block concatenations — batched `.at[].set()`
    # scatters on tiny minors were a measured ~10x slowdown of the whole
    # SRB build on an earlier accelerator; concat lowers to one fused
    # write.
    rz_t = jnp.broadcast_to(jnp.swapaxes(rot, -1, -2), batch + (3, 3))
    z33 = jnp.zeros(batch + (3, 3), dtype)
    z31 = jnp.zeros(batch + (3, 1), dtype)
    # Rows 0-2: d(rpy)/dt = R^T w_world (reference yawRotMat = full rotMat).
    rows_rpy = jnp.concatenate([z33, z33, rz_t, z33, z31], axis=-1)
    # Rows 3-12 are state-independent: dp/dt = v, dvz/dt += g (13th state).
    static = np.zeros((NX - 3, NX), np.float32)
    static[0:3, 9:12] = np.eye(3)
    static[8, 12] = 1.0  # row 11 overall: dvz/dt = g
    rows_static = jnp.broadcast_to(jnp.asarray(static, dtype),
                                   batch + (NX - 3, NX))
    a = jnp.concatenate([rows_rpy, rows_static], axis=-2)

    i_world = world_inertia(inertia_body, rot)
    i_world_inv = se3.inv3x3(i_world)
    skews = se3.skew(r_feet)  # [..., 4, 3, 3]
    torque_maps = se3.matmul3(i_world_inv[..., None, :, :], skews)
    # [..., 4, 3, 3] -> [..., 3, 12] (legs side by side along columns).
    tq = jnp.swapaxes(torque_maps, -3, -2).reshape(batch + (3, NU))
    eye_tiled = jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (1, 4)),
                            dtype)
    rows_v = jnp.broadcast_to(eye_tiled, batch + (3, NU)) \
        / mass[..., None, None]
    z6 = jnp.zeros(batch + (6, NU), dtype)
    z1 = jnp.zeros(batch + (1, NU), dtype)
    b = jnp.concatenate([z6, tq, rows_v, z1], axis=-2)
    return a, b


def srb_discretize(a: jnp.ndarray, b: jnp.ndarray, dt) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact ZOH for the nilpotent SRB A (see module docstring)."""
    eye = jnp.eye(NX, dtype=a.dtype)
    a2 = a @ a
    ad = eye + a * dt + a2 * (dt * dt * 0.5)
    bd = b * dt + (a @ b) * (dt * dt * 0.5)
    return ad, bd


def srb_dynamics(x: jnp.ndarray, forces: jnp.ndarray, inertia_body: jnp.ndarray,
                 mass: jnp.ndarray, r_feet: jnp.ndarray) -> jnp.ndarray:
    """Continuous xdot = A(x) x + B(x) u for simulation/verification.

    forces: [..., 4, 3] world-frame ground reaction forces.
    """
    a, b = srb_continuous(se3.rpy_to_rotmat(x[..., 0:3]), inertia_body, mass,
                          r_feet)
    u = forces.reshape(forces.shape[:-2] + (NU,))
    return (jnp.einsum("...ij,...j->...i", a, x)
            + jnp.einsum("...ij,...j->...i", b, u))


def srb_initial_state(rpy, pos, omega_world, vel_world) -> jnp.ndarray:
    """Pack the 13-state vector (appends the gravity state)."""
    parts = [rpy, pos, omega_world, vel_world]
    batch = jnp.broadcast_shapes(*[p.shape[:-1] for p in parts])
    g = jnp.full(batch + (1,), GRAVITY, dtype=rpy.dtype)
    return jnp.concatenate(
        [jnp.broadcast_to(p, batch + (3,)) for p in parts] + [g], axis=-1)
