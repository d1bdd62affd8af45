"""6-D spatial (Plücker) algebra, batched.

Capability parity with the reference's spatial utilities
(quadruped/include/quadruped/dynamics/spatial.hpp:43-542): motion/force cross
products, spatial transforms, joint transforms, and spatial inertia
construction — as pure batched JAX ops feeding the fixed-topology
Featherstone sweeps in dynamics/floating_base.py.

Conventions (Featherstein spatial_v2, matching the reference):
  * Motion vectors are [angular(3); linear(3)].
  * A spatial transform X(E, r) maps motion vectors from frame A to frame B,
    where E is the rotation (B_R_A) and r is the origin of B expressed in A:
        X = [[E, 0], [-E skew(r), E]]
  * Force vectors transform by the inverse transpose.
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core.se3 import matmul3, skew, rot_x, rot_y, rot_z


def spatial_transform(e: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3], [..., 3] -> [..., 6, 6] motion transform (createSXform)."""
    batch = jnp.broadcast_shapes(e.shape[:-2], r.shape[:-1])
    e = jnp.broadcast_to(e, batch + (3, 3))
    zero = jnp.zeros(batch + (3, 3), e.dtype)
    top = jnp.concatenate([e, zero], axis=-1)
    bottom = jnp.concatenate([-matmul3(e, skew(r)), e], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def transform_inverse(x: jnp.ndarray) -> jnp.ndarray:
    """Invert a motion transform without re-deriving (E, r)."""
    e = x[..., 0:3, 0:3]
    mesr = x[..., 3:6, 0:3]  # -E skew(r)
    et = jnp.swapaxes(e, -1, -2)
    top = jnp.concatenate([et, jnp.zeros_like(e)], axis=-1)
    bottom = jnp.concatenate([-matmul3(matmul3(et, mesr), et), et],
                             axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def rotation_part(x: jnp.ndarray) -> jnp.ndarray:
    return x[..., 0:3, 0:3]


def translation_part(x: jnp.ndarray) -> jnp.ndarray:
    """Recover r from X = [[E,0],[-E skew(r), E]]."""
    e = x[..., 0:3, 0:3]
    m = -matmul3(jnp.swapaxes(e, -1, -2), x[..., 3:6, 0:3])  # skew(r)
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def motion_cross_matrix(v: jnp.ndarray) -> jnp.ndarray:
    """crm(v): [..., 6] -> [..., 6, 6] (motionCrossMatrix :43)."""
    w = skew(v[..., 0:3])
    vl = skew(v[..., 3:6])
    zero = jnp.zeros_like(w)
    top = jnp.concatenate([w, zero], axis=-1)
    bottom = jnp.concatenate([vl, w], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def force_cross_matrix(v: jnp.ndarray) -> jnp.ndarray:
    """crf(v) = -crm(v)^T (forceCrossMatrix :61)."""
    return -jnp.swapaxes(motion_cross_matrix(v), -1, -2)


def motion_cross(v: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """crm(v) @ m without materializing the 6x6."""
    w, vl = v[..., 0:3], v[..., 3:6]
    mw, ml = m[..., 0:3], m[..., 3:6]
    return jnp.concatenate(
        [jnp.cross(w, mw), jnp.cross(vl, mw) + jnp.cross(w, ml)], axis=-1)


def force_cross(v: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """crf(v) @ f."""
    w, vl = v[..., 0:3], v[..., 3:6]
    fw, fl = f[..., 0:3], f[..., 3:6]
    return jnp.concatenate(
        [jnp.cross(w, fw) + jnp.cross(vl, fl), jnp.cross(w, fl)], axis=-1)


def joint_transform_revolute(axis: int, theta: jnp.ndarray) -> jnp.ndarray:
    """Rotation-only spatial transform for a revolute joint about x/y/z
    (jointXform :230). NOTE Featherstein convention: the joint rotation
    enters as E = R(theta)^T (rotation of the child frame)."""
    rot = (rot_x, rot_y, rot_z)[axis](theta)
    e = jnp.swapaxes(rot, -1, -2)
    zero = jnp.zeros_like(e)
    top = jnp.concatenate([e, zero], axis=-1)
    bottom = jnp.concatenate([zero, e], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def joint_motion_subspace(axis: int, dtype=jnp.float32) -> jnp.ndarray:
    """[6] motion subspace S for a revolute joint about x/y/z."""
    s = jnp.zeros((6,), dtype)
    return s.at[axis].set(1.0)


def spatial_inertia(mass, com: jnp.ndarray, i_com: jnp.ndarray) -> jnp.ndarray:
    """Spatial inertia from mass, CoM offset, rotational inertia about the
    CoM (SpatialInertia :383):  [[I_com + m c^ c^T, m c^], [m c^T, m 1]]."""
    c = skew(com)
    ct = jnp.swapaxes(c, -1, -2)
    mass = jnp.asarray(mass, com.dtype)
    m3 = mass[..., None, None] * jnp.eye(3, dtype=com.dtype)
    top = jnp.concatenate([i_com + mass[..., None, None] * (c @ ct),
                           mass[..., None, None] * c], axis=-1)
    bottom = jnp.concatenate([mass[..., None, None] * ct, m3], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def flip_inertia_along_y(mass, com: jnp.ndarray,
                         i_com: jnp.ndarray):
    """Mirror a link's inertial properties across the XZ plane
    (SpatialInertia::flipAlongAxis for CoordinateAxis::Y), used to derive
    right-leg links from the FL-leg catalog values."""
    com_f = com * jnp.asarray([1.0, -1.0, 1.0], com.dtype)
    flip = jnp.asarray([[1.0, -1.0, 1.0],
                        [-1.0, 1.0, -1.0],
                        [1.0, -1.0, 1.0]], i_com.dtype)
    return mass, com_f, i_com * flip
