"""Center-of-geometry / center-of-mass kernels (Bai-Breen, vectorized).

Batched re-design of the reference's center pipeline:
- `estimate_center` — Bai & Breen (2008) circular-mean estimate
  (`src/structures/iterators.rs:1152`, trig helpers `src/auxiliary.rs:58-99`)
- `center` (refined) — estimate, then unwrap every atom around the estimate
  with `vector_to` and take the plain (weighted) mean
  (`src/structures/iterators.rs:1237-1266`, `:1404`).

Instead of the reference's three scalar passes, everything here is one fused
masked reduction over `[..., N, 3]` arrays: the trig pass and the unwrap pass
both vectorize, and XLA fuses wrap + trig + reduce into a single HBM read.

All functions accept arbitrary leading batch dims (e.g. `[B, N, 3]` frames)
and per-frame boxes via broadcasting (`box` of shape `[3]` or `[B, 1, 3]` →
pass `box[..., 0, :]`-style broadcastable shapes).
"""

from __future__ import annotations

import jax.numpy as jnp

from .pbc import vector_to, wrap

__all__ = ["estimate_center", "center", "center_naive", "center_triclinic"]

_TWO_PI = 6.283185307179586


def _prep(positions, box, mask, weights):
    positions = jnp.asarray(positions)
    dtype = positions.dtype
    box = jnp.asarray(box, dtype=dtype)
    if mask is None:
        w = jnp.ones(positions.shape[:-1], dtype=dtype)
    else:
        w = jnp.asarray(mask).astype(dtype)
        w = jnp.broadcast_to(w, positions.shape[:-1])
    if weights is not None:
        w = w * jnp.asarray(weights, dtype=dtype)
    return positions, box, w


def estimate_center(positions, box, mask=None, weights=None):
    """Bai-Breen circular-mean center estimate.

    positions: `[..., N, 3]`; box: broadcastable orthogonal lengths `(3,)`;
    mask: optional `[..., N]` bool selecting atoms; weights: optional
    `[..., N]` masses (COM) — omit for center of geometry.

    Returns `[..., 3]`.  Empty selection yields NaN (reference behaviour).
    """
    positions, box, w = _prep(positions, box, mask, weights)
    theta = wrap(positions, box) * (_TWO_PI / box)
    wx = w[..., None]
    xi = jnp.sum(wx * jnp.cos(theta), axis=-2)
    zeta = jnp.sum(wx * jnp.sin(theta), axis=-2)
    theta_c = jnp.arctan2(-zeta, -xi) + jnp.pi  # [..., 3] (atom axis reduced)
    # box may carry an atom axis (e.g. [B, 1, 3]); reduce it away so the
    # rescale matches theta_c's shape instead of broadcasting a new axis
    box_r = jnp.broadcast_to(box, positions.shape)[..., 0, :]
    out = theta_c * (box_r / _TWO_PI)
    empty = jnp.sum(w, axis=-1, keepdims=True) == 0
    return jnp.where(empty, jnp.nan, out)


def center(positions, box, mask=None, weights=None):
    """Refined center: Bai-Breen estimate -> unwrap around estimate -> mean.

    Matches `AtomIteratorWithBox::get_center` / `get_com`
    (iterators.rs:1237-1266, :1404): the estimate is always the *geometric*
    Bai-Breen estimate (unweighted), while the final mean uses `weights`
    (masses) when provided.
    """
    positions, box, w = _prep(positions, box, mask, weights)
    est = estimate_center(positions, box, mask=mask)  # geometric estimate
    unwrapped = est[..., None, :] + vector_to(est[..., None, :], positions, box)
    num = jnp.sum(w[..., None] * unwrapped, axis=-2)
    den = jnp.sum(w, axis=-1, keepdims=True)
    return num / den


def center_triclinic(positions, box_matrix, mask=None, weights=None):
    """Refined Bai-Breen center for a general triclinic box.

    positions: `[..., N, 3]`; box_matrix: `[..., 3, 3]` row-major box
    vectors (Gromacs convention).  The circular-mean estimate and the
    unwrap refinement both run in fractional coordinates (period 1 per
    axis), then map back to Cartesian.  Surpass feature: the reference's
    center math is orthogonal-only (`src/lib.rs:353-355`).

    Returns `[..., 3]`.
    """
    positions = jnp.asarray(positions)
    dtype = positions.dtype
    h = jnp.asarray(box_matrix, dtype=dtype)
    if mask is None:
        w = jnp.ones(positions.shape[:-1], dtype=dtype)
    else:
        w = jnp.asarray(mask).astype(dtype)
        w = jnp.broadcast_to(w, positions.shape[:-1])
    if weights is not None:
        w = w * jnp.asarray(weights, dtype=dtype)

    import jax

    # HIGHEST: the default f32 matmul precision on a GPU is TF32, whose
    # 10-bit mantissa would cost ~1e-3 relative on these coordinates
    _hi = jax.lax.Precision.HIGHEST
    hinv = jnp.linalg.inv(h)
    s = jnp.matmul(positions, hinv, precision=_hi)  # fractional [..., N, 3]
    theta = (s - jnp.floor(s)) * _TWO_PI
    wx = w[..., None]
    xi = jnp.sum(wx * jnp.cos(theta), axis=-2)
    zeta = jnp.sum(wx * jnp.sin(theta), axis=-2)
    est = (jnp.arctan2(-zeta, -xi) + jnp.pi) / _TWO_PI  # [..., 3] fractional

    # unwrap every atom around the estimate (min-image in fractional space)
    d = s - est[..., None, :]
    d = d - jnp.round(d)
    num = jnp.sum(wx * (est[..., None, :] + d), axis=-2)
    den = jnp.sum(w, axis=-1, keepdims=True)
    frac = num / den
    return jnp.squeeze(jnp.matmul(frac[..., None, :], h, precision=_hi),
                       axis=-2)


def center_naive(positions, mask=None, weights=None):
    """Plain (weighted) mean ignoring PBC (`AtomIterable::get_center_naive`)."""
    positions = jnp.asarray(positions)
    dtype = positions.dtype
    if mask is None:
        w = jnp.ones(positions.shape[:-1], dtype=dtype)
    else:
        w = jnp.asarray(mask).astype(dtype)
        w = jnp.broadcast_to(w, positions.shape[:-1])
    if weights is not None:
        w = w * jnp.asarray(weights, dtype=dtype)
    num = jnp.sum(w[..., None] * positions, axis=-2)
    den = jnp.sum(w, axis=-1, keepdims=True)
    return num / den
