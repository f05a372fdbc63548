"""Periodic-boundary-condition kernels (pure JAX, shape-polymorphic).

Batched re-design of the reference's scalar PBC math
(`src/structures/vector3d.rs:380-592`).  The reference uses loop-subtract
wrapping because scalar `floor` is slow on CPU; here the closed
`floor`-based forms evaluate elementwise over `[..., 3]` arrays, with exact-
boundary fixes so semantics match the reference's loops bit-for-bit on the
boundary cases (`x == L` stays `L`, `dx == ±L/2` keeps its sign).

All functions broadcast: `points` may be `[3]`, `[N, 3]`, or `[B, N, 3]`;
`box` is the `(3,)` vector of orthogonal box lengths (broadcastable, e.g.
`[B, 1, 3]` for per-frame boxes).

The exact triclinic minimum image (which the reference does NOT have — its
PBC math is orthogonal-only, `src/lib.rs:353-355`) lives at the bottom:
`min_image_triclinic` / `distance_triclinic`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# every f32 contraction here pins HIGHEST: the default f32 matmul
# precision on a GPU is TF32 (10-bit mantissa, ~1e-3 relative), which
# would break float32 parity with the reference
_HI = jax.lax.Precision.HIGHEST

__all__ = [
    "wrap",
    "min_image",
    "vector_to",
    "distance",
    "distance_naive",
    "displacement",
    "min_image_triclinic",
    "distance_triclinic",
    "wrap_triclinic",
    "min_image_triclinic_frames",
    "min_image_frames_any",
    "distance_triclinic_frames",
    "wrap_triclinic_frames",
]


def wrap(points, box):
    """Wrap coordinates into the box.

    Matches `Vector3D::wrap` (vector3d.rs:380-417) including the boundary
    convention of the loop form: positive exact multiples of L map to L
    (`while wrapped > box_len`), non-positive multiples map to 0.
    """
    points = jnp.asarray(points)
    box = jnp.asarray(box, dtype=points.dtype)
    m = points - box * jnp.floor(points / box)
    # loop semantics: x == k*L (k>=1) stays at L, never 0
    return jnp.where((m == 0.0) & (points > 0.0), box, m)


def min_image(dx, box):
    """Minimum-image a displacement (per-axis).

    Matches `Vector3D::min_image` (vector3d.rs:575-592) including both
    inclusive endpoints: values in [-L/2, L/2] are untouched; the +L/2
    congruence class keeps the sign convention of the loop form.
    """
    dx = jnp.asarray(dx)
    box = jnp.asarray(box, dtype=dx.dtype)
    half = box * 0.5
    m = dx - box * jnp.floor(dx / box + 0.5)
    # loop semantics: dx in {L/2 + k*L, k>=0} maps to +L/2, not -L/2
    return jnp.where((m == -half) & (dx > -half), half, m)


def vector_to(a, b, box):
    """Shortest vector from `a` to `b` under PBC.

    Matches `Vector3D::vector_to` (vector3d.rs:561-569):
    `floor_mod(b - a + L/2, L) - L/2`.
    """
    a = jnp.asarray(a)
    box = jnp.asarray(box, dtype=a.dtype)
    half = box * 0.5
    d = jnp.asarray(b) - a + half
    return d - box * jnp.floor(d / box) - half


def displacement(a, b, box):
    """Minimum-image displacement `a - b` per axis (oriented)."""
    return min_image(jnp.asarray(a) - jnp.asarray(b), box)


def distance(a, b, box, dim_mask=(True, True, True)):
    """PBC distance between points, masked by dimensions.

    Matches `Vector3D::distance` (vector3d.rs:458-486): with a single active
    axis the result is the ORIENTED per-axis minimum image of `a - b`;
    with 2-3 active axes it is the Euclidean norm over those axes.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    mask = jnp.asarray(dim_mask, dtype=bool)
    n_active = int(jnp.sum(mask)) if mask.ndim == 0 else int(sum(bool(v) for v in dim_mask))
    d = min_image(a - b, box)
    if n_active == 0:
        return jnp.zeros(d.shape[:-1], dtype=d.dtype)
    if n_active == 1:
        return jnp.sum(jnp.where(mask, d, 0.0), axis=-1)
    d = jnp.where(mask, d, 0.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def distance_naive(a, b, dim_mask=(True, True, True)):
    """Distance ignoring PBC (`Vector3D::distance_naive`, vector3d.rs:500+)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    mask = jnp.asarray(dim_mask, dtype=bool)
    n_active = int(sum(bool(v) for v in dim_mask))
    d = a - b
    if n_active == 0:
        return jnp.zeros(d.shape[:-1], dtype=d.dtype)
    if n_active == 1:
        return jnp.sum(jnp.where(mask, d, 0.0), axis=-1)
    d = jnp.where(mask, d, 0.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


# --------------------------------------------------------------------------
# Exact triclinic PBC (surpass feature; the reference reads triclinic boxes
# but computes wrong orthogonal-only distances for them).
# --------------------------------------------------------------------------

# relative image shifts (27 neighbours incl. self), static constant
_SHIFTS = jnp.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=jnp.float32,
)


def min_image_triclinic(d, box_matrix):
    """Exact minimum-image displacement for a general triclinic box.

    `d`: `[..., 3]` raw displacement; `box_matrix`: `(3,3)` row-major box
    vectors (Gromacs convention: lower-triangular).  Reduces `d` into the
    primary cell via fractional rounding, then exhaustively checks the 27
    neighbouring images (sufficient for Gromacs-legal boxes where
    off-diagonals are bounded by half the diagonal).
    """
    d = jnp.asarray(d)
    h = jnp.asarray(box_matrix, dtype=d.dtype)  # rows are box vectors
    hinv = jnp.linalg.inv(h)
    # fractional coords: d = s @ h  =>  s = d @ h^-1
    s = jnp.matmul(d, hinv, precision=_HI)
    d0 = d - jnp.matmul(jnp.round(s), h, precision=_HI)
    # candidate images: d0 + shift @ h  for all 27 shifts
    cands = d0[..., None, :] + jnp.matmul(_SHIFTS.astype(d.dtype), h, precision=_HI)  # [..., 27, 3]
    n2 = jnp.sum(cands * cands, axis=-1)  # [..., 27]
    best = jnp.argmin(n2, axis=-1)  # [...]
    return jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]


def distance_triclinic(a, b, box_matrix):
    """Exact triclinic minimum-image distance between points."""
    d = min_image_triclinic(jnp.asarray(a) - jnp.asarray(b), box_matrix)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def wrap_triclinic(points, box_matrix):
    """Put points inside the primary triclinic cell (fractional in [0, 1))."""
    p = jnp.asarray(points)
    h = jnp.asarray(box_matrix, dtype=p.dtype)
    hinv = jnp.linalg.inv(h)
    s = jnp.matmul(p, hinv, precision=_HI)
    return jnp.matmul(s - jnp.floor(s), h, precision=_HI)


# ---- per-frame box-matrix variants ([B, 3, 3] boxes; explicit einsums
# because matmul silently mis-broadcasts [B, 3] @ [B, 3, 3]) ----


def min_image_triclinic_frames(d, boxes):
    """Exact triclinic minimum image with one box matrix per frame.

    d: `[B, N, 3]` or `[B, 3]` displacements; boxes: `[B, 3, 3]`.
    """
    d = jnp.asarray(d)
    h = jnp.asarray(boxes, dtype=d.dtype)
    single = d.ndim == 2
    if single:
        d = d[:, None, :]
    hinv = jnp.linalg.inv(h)
    s = jnp.einsum("bni,bij->bnj", d, hinv, precision=_HI)
    d0 = d - jnp.einsum("bni,bij->bnj", jnp.round(s), h, precision=_HI)
    shift_vecs = jnp.einsum(
        "ki,bij->bkj", _SHIFTS.astype(d.dtype), h, precision=_HI
    )  # [B, 27, 3]
    cands = d0[:, :, None, :] + shift_vecs[:, None, :, :]  # [B, N, 27, 3]
    n2 = jnp.sum(cands * cands, axis=-1)
    best = jnp.argmin(n2, axis=-1)
    out = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    return out[:, 0, :] if single else out


def min_image_frames_any(d, boxes):
    """Per-frame minimum image dispatching on the box representation.

    d: `[F, ..., 3]` displacements (any middle rank); boxes: `[F, 3]`
    orthorhombic lengths (per-axis reduction, bit-identical to the
    direct `min_image` broadcast) or `[F, 3, 3]` triclinic matrices
    (exact 27-image search).  The shared entry point for kernels that
    must accept both (sasa/mdmat/dssp/msd/... triclinic support)."""
    d = jnp.asarray(d)
    boxes = jnp.asarray(boxes)
    if boxes.ndim == 2:
        b = boxes.reshape((d.shape[0],) + (1,) * (d.ndim - 2) + (3,))
        return min_image(d, b)
    flat = d.reshape(d.shape[0], -1, 3)
    return min_image_triclinic_frames(flat, boxes).reshape(d.shape)


def distance_triclinic_frames(a, b, boxes):
    """Exact triclinic minimum-image distance, per-frame boxes `[B, 3, 3]`."""
    d = min_image_triclinic_frames(jnp.asarray(a) - jnp.asarray(b), boxes)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def wrap_triclinic_frames(points, boxes):
    """Wrap `[B, N, 3]` points into per-frame triclinic cells `[B, 3, 3]`."""
    p = jnp.asarray(points)
    h = jnp.asarray(boxes, dtype=p.dtype)
    hinv = jnp.linalg.inv(h)
    s = jnp.einsum("bni,bij->bnj", p, hinv, precision=_HI)
    return jnp.einsum("bni,bij->bnj", s - jnp.floor(s), h, precision=_HI)
