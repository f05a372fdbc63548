"""Batched vector utility kernels (reference: `src/structures/vector3d.rs`).

Vector3D's scalar methods become shape-polymorphic ops over `[..., 3]`
arrays: `length`/`to_unit` (vector3d.rs:214-218, :218-240), `dot`
(nalgebra), `cross`, `angle` (vector3d.rs:276: `acos(dot/(|a||b|))`,
radians in [0, pi]), `shift` along an orientation (vector3d.rs:305-309),
and `rotate` by a rotation matrix (vector3d.rs:359-361, column-vector
convention `R @ x`).  PBC-aware math (wrap/min_image/vector_to/distance)
lives in `ops.pbc`.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["length", "to_unit", "dot", "cross", "angle", "shift", "rotate",
           "rotation_about_axis"]


def length(v):
    """Euclidean norm over the last axis (`Vector3D::len`)."""
    v = jnp.asarray(v)
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def to_unit(v):
    """Unit vector (`Vector3D::to_unit`); the null vector yields NaN,
    matching the reference."""
    v = jnp.asarray(v)
    return v / length(v)[..., None]


def dot(a, b):
    """Dot product over the last axis."""
    a = jnp.asarray(a)
    return jnp.sum(a * jnp.asarray(b, a.dtype), axis=-1)


def cross(a, b):
    """Cross product over the last axis."""
    return jnp.cross(jnp.asarray(a), jnp.asarray(b))


def angle(a, b):
    """Angle between vectors in radians, always in [0, pi]
    (`Vector3D::angle`, vector3d.rs:276).  Collinear float32 rounding can
    push |cos| past 1 -> NaN, exactly like the reference (callers that need
    the reference's NaN disambiguation handle it themselves, cf. hbonds)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b, a.dtype)
    return jnp.arccos(dot(a, b) / (length(a) * length(b)))


def shift(v, orientation, distance):
    """Shift point(s) along `orientation` by `distance`
    (`Vector3D::shift`): v + unit(orientation) * distance."""
    v = jnp.asarray(v)
    u = to_unit(jnp.asarray(orientation, v.dtype))
    return v + u * jnp.asarray(distance, v.dtype)[..., None]


def rotate(v, rotation_matrix):
    """Rotate point(s) by a 3x3 rotation matrix (`Vector3D::rotate`,
    column-vector convention `R @ x`; for row-vector arrays x @ R^T)."""
    v = jnp.asarray(v)
    r = jnp.asarray(rotation_matrix, v.dtype)
    # HIGHEST: the default f32 matmul precision on a GPU is TF32 (10-bit
    # mantissa), ~1e-3 relative on rotations; f32 parity needs full f32
    import jax

    return jnp.einsum("...j,...ij->...i", v, r,
                      precision=jax.lax.Precision.HIGHEST)


def rotation_about_axis(axis, theta):
    """Rotation matrix for a counterclockwise rotation of `theta` radians
    about `axis` (Rodrigues).  Returns `[..., 3, 3]`."""
    u = to_unit(jnp.asarray(axis, jnp.result_type(float)))
    theta = jnp.asarray(theta, u.dtype)
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    one_c = 1.0 - c
    row0 = jnp.stack([c + ux * ux * one_c, ux * uy * one_c - uz * s,
                      ux * uz * one_c + uy * s], axis=-1)
    row1 = jnp.stack([uy * ux * one_c + uz * s, c + uy * uy * one_c,
                      uy * uz * one_c - ux * s], axis=-1)
    row2 = jnp.stack([uz * ux * one_c - uy * s, uz * uy * one_c + ux * s,
                      c + uz * uz * one_c], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)
