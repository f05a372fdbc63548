"""Kabsch RMSD / fit kernels (batched over frames).

Batched re-design of the reference RMSD pipeline (`src/system/rmsd.rs`):

- `kabsch` — mass-weighted Kabsch (`rmsd.rs:547-604`): unweighted covariance
  H = sum(p_c q_c^T), 3x3 SVD with determinant sign fix, R = U D V^T,
  RMSD = sqrt(sum w |R^T p_c - q_c|^2 / sum w).  Here batched: coords of
  shape `[..., n, 3]` give `[..., 3, 3]` rotations and `[...]` RMSDs in one
  jitted call (`jnp.linalg.svd` batches the tiny SVDs).
- `prepare_coords` — the reference's `extract_data_from_system`
  (`rmsd.rs:425-447`): shift the group so its COM sits at the box center,
  then wrap.  Keeps PBC-broken molecules compact before the fit, which is
  why groan_rs beats gmx/MDAnalysis on broken dimers
  (`comparison/rmsd/info.md`).
- `fit_transform` — apply the fit to all atoms (`rmsd.rs:508-533`):
  translate group COM to box center (with PBC wrap), then rotate about the
  box center and translate to the reference group COM, both without PBC.

Conventions follow the reference exactly: `kabsch(p=reference, q=target)`
and the resulting `rotation` matrix is applied to target atoms as
`x @ rotation` (nalgebra's `rotate_nopbc` computes R * x with column
vectors; for row-vector arrays that is `x @ R^T`, and the reference rotates
by `R^T`'s transpose... see `fit_structure`, hence `x @ rotation` here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# every f32 contraction here pins HIGHEST: the default f32 matmul
# precision on a GPU is TF32 (10-bit mantissa, ~1e-3 relative), which
# would break float32 parity with the reference
_HI = jax.lax.Precision.HIGHEST

from .center import center
from .pbc import wrap

__all__ = [
    "kabsch",
    "prepare_coords",
    "rmsd_frames",
    "rmsd_matrix",
    "fit_transform",
    "prepare_coords_triclinic",
    "rmsd_frames_triclinic",
]


def prepare_coords(positions, box, mask=None, weights=None):
    """Shift selected atoms so their COM is at the box center, then wrap.

    positions `[..., N, 3]`, box broadcastable `(3,)`.
    Returns (shifted_wrapped_positions `[..., N, 3]`, box_center `[..., 3]`).
    """
    positions = jnp.asarray(positions)
    box = jnp.asarray(box, dtype=positions.dtype)  # [..., 3] (no atom axis)
    box_center = jnp.broadcast_to(box * 0.5, positions.shape[:-2] + (3,))
    box_b = box[..., None, :] if box.ndim > 1 else box
    com = center(positions, box_b, mask=mask, weights=weights)
    shifted = positions + (box_center - com)[..., None, :]
    return wrap(shifted, box_b), box_center


def _quaternion_to_matrix(qv):
    """Unit quaternion `[..., 4]` (w, x, y, z) -> rotation matrix `[..., 3, 3]`."""
    qw, qx, qy, qz = qv[..., 0], qv[..., 1], qv[..., 2], qv[..., 3]
    r00 = qw * qw + qx * qx - qy * qy - qz * qz
    r11 = qw * qw - qx * qx + qy * qy - qz * qz
    r22 = qw * qw - qx * qx - qy * qy + qz * qz
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def kabsch(p, q, w, centroid_p, centroid_q):
    """Batched mass-weighted Kabsch alignment (reference rmsd.rs:547-604).

    p, q: `[..., n, 3]` point sets (p = reference, q = target, matching the
    reference's call convention); w: `[n]` or `[..., n]` weights;
    centroid_p/q: `[..., 3]`.

    The optimal rotation comes from the QCP quaternion formulation
    (Theobald 2005) — a symmetric 4x4 eigenproblem — instead of the
    reference's 3x3 SVD: in float32 the eigh path is ~4 orders of magnitude
    more accurate than SVD (2e-7 vs 5e-3 rotation error) and batches as
    one `eigh` over `[..., 4, 4]`.  The proper-rotation constraint (the reference's
    determinant sign fix, rmsd.rs:578-583) is inherent to the quaternion
    parameterization.

    Returns (rotation `[..., 3, 3]`, translation `[..., 3]`, rmsd `[...]`),
    with `rotation` in the reference's convention: `pc @ rotation` aligns
    centered `p` onto centered `q`.
    """
    p = jnp.asarray(p)
    q = jnp.asarray(q)
    w = jnp.asarray(w, dtype=p.dtype)
    pc = p - jnp.asarray(centroid_p)[..., None, :]
    qc = q - jnp.asarray(centroid_q)[..., None, :]

    # unweighted covariance S_ij = sum_n pc_ni qc_nj  -> [..., 3, 3]
    h = jnp.einsum("...ni,...nj->...ij", pc, qc, precision=_HI)

    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]

    k0 = jnp.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], axis=-1)
    k1 = jnp.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], axis=-1)
    k2 = jnp.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], axis=-1)
    k3 = jnp.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], axis=-1)
    kmat = jnp.stack([k0, k1, k2, k3], axis=-2)

    _, vecs = jnp.linalg.eigh(kmat)
    qv = vecs[..., :, -1]  # eigenvector of the largest eigenvalue
    rot_q = _quaternion_to_matrix(qv)  # aligns as pc @ rot_q^T
    r = jnp.swapaxes(rot_q, -1, -2)  # reference convention: pc @ r

    p_rot = jnp.einsum("...ni,...ij->...nj", pc, r, precision=_HI)
    d = p_rot - qc
    w_b = jnp.broadcast_to(w, d.shape[:-1])
    num = jnp.sum(w_b * jnp.sum(d * d, axis=-1), axis=-1)
    rmsd = jnp.sqrt(num / jnp.sum(w_b, axis=-1))

    trans = jnp.asarray(centroid_q) - jnp.asarray(centroid_p)
    return r, jnp.broadcast_to(trans, rmsd.shape + (3,)), rmsd


def rmsd_frames(ref_prepared, ref_center, frames, boxes, w, mask=None):
    """RMSD of a `[B, N, 3]` frame batch vs a prepared reference.

    ref_prepared: `[n, 3]` reference coords already shifted to the reference
    box center (from `prepare_coords` + gather); ref_center: `[3]`;
    frames: `[B, n, 3]` gathered group coords per frame; boxes: `[B, 3]`;
    w: `[n]` masses.  Returns (rotations `[B, 3, 3]`, rmsd `[B]`).
    """
    tgt, tgt_center = prepare_coords(frames, boxes, mask=mask, weights=w)
    r, _, rms = kabsch(
        ref_prepared[None, ...],
        tgt,
        w if mask is None else jnp.asarray(w) * jnp.asarray(mask),
        ref_center[None, :],
        tgt_center,
    )
    return r, rms


def rmsd_matrix(frames, boxes, w, *, chunk: int = 8):
    """All-pairs fitted RMSD of a frame batch -> `[F, F]` (the `gmx rms
    -m` matrix; feeds GROMOS clustering).

    frames: `[F, K, 3]` group coords per frame; boxes: `[F, 3]` lengths
    (or `[F, 3, 3]` triclinic matrices — frames then unwrap around the
    exact triclinic refined COM, the `rmsd_frames_triclinic`
    convention); w: `[K]` masses.  Every pair uses EXACTLY the
    single-pair `calc_rmsd`
    convention (mass-weighted centroids, unweighted covariance, mass-
    weighted deviations — rmsd.rs:547-604), so `out[i, j]` equals
    `calc_rmsd` between frame-i and frame-j systems; the matrix is
    exactly symmetric with a zero diagonal by that convention.  Rows are
    processed `chunk` at a time under `lax.map` so peak memory is
    `[chunk, F, K, 3]` while the covariance builds stay batched
    einsums.
    """
    frames = jnp.asarray(frames, jnp.float32)
    f = int(frames.shape[0])
    boxes = jnp.asarray(boxes, jnp.float32)
    if boxes.ndim == 3:
        from .center import center_triclinic
        from .pbc import min_image_triclinic_frames

        wj0 = jnp.asarray(w, jnp.float32)
        com = center_triclinic(frames, boxes, weights=wj0)   # [F, 3]
        prepped = com[:, None, :] + min_image_triclinic_frames(
            frames - com[:, None, :], boxes)                 # [F, K, 3]
        ctr = (jnp.sum(wj0[None, :, None] * prepped, axis=1)
               / jnp.sum(wj0))                               # [F, 3]
    else:
        prepped, ctr = prepare_coords(frames, boxes, weights=w)

    n_chunks = -(-f // chunk)
    pad = n_chunks * chunk - f
    if pad:
        prepped_p = jnp.concatenate([prepped, prepped[:pad]], axis=0)
        ctr_p = jnp.concatenate([ctr, ctr[:pad]], axis=0)
    else:
        prepped_p, ctr_p = prepped, ctr

    wj = jnp.asarray(w, jnp.float32)

    def rows(start):
        p = jax.lax.dynamic_slice_in_dim(prepped_p, start, chunk, axis=0)
        cp = jax.lax.dynamic_slice_in_dim(ctr_p, start, chunk, axis=0)
        _, _, rms = kabsch(p[:, None], prepped[None], wj,
                           cp[:, None], ctr[None])
        return rms                                           # [chunk, F]

    out = jax.lax.map(rows, jnp.arange(n_chunks) * chunk)
    return out.reshape(-1, f)[:f]


def prepare_coords_triclinic(positions, box_matrix, mask=None, weights=None):
    """Triclinic analogue of `prepare_coords` for a single structure.

    positions `[n, 3]`, box_matrix `[3, 3]`.  Unwraps every atom around the
    triclinic refined COM (exact minimum image), so PBC-broken molecules are
    compact before the fit.  Returns (unwrapped `[n, 3]`, weighted centroid
    `[3]`).  Surpass feature — the reference's RMSD is orthogonal-only.
    """
    from .center import center_triclinic
    from .pbc import min_image_triclinic

    positions = jnp.asarray(positions)
    com = center_triclinic(positions, box_matrix, mask=mask, weights=weights)
    unwrapped = com[None, :] + min_image_triclinic(positions - com[None, :], box_matrix)
    w = jnp.ones(positions.shape[:-1], positions.dtype) if weights is None \
        else jnp.asarray(weights, positions.dtype)
    if mask is not None:
        w = w * jnp.asarray(mask).astype(positions.dtype)
    centroid = jnp.sum(w[:, None] * unwrapped, axis=0) / jnp.sum(w)
    return unwrapped, centroid


def rmsd_frames_triclinic(ref_prepared, ref_centroid, frames, boxes, w, mask=None):
    """RMSD of a `[B, n, 3]` frame batch vs a prepared reference with
    per-frame triclinic boxes `[B, 3, 3]`.

    ref_prepared/ref_centroid come from `prepare_coords_triclinic`.
    Returns (rotations `[B, 3, 3]`, rmsd `[B]`).
    """
    from .center import center_triclinic
    from .pbc import min_image_triclinic_frames

    frames = jnp.asarray(frames)
    w = jnp.asarray(w, frames.dtype)
    w_eff = w if mask is None else w * jnp.asarray(mask).astype(frames.dtype)
    com = center_triclinic(frames, boxes, mask=mask, weights=w)
    tgt = com[:, None, :] + min_image_triclinic_frames(
        frames - com[:, None, :], boxes
    )
    wb = jnp.broadcast_to(w_eff, tgt.shape[:-1])
    cq = jnp.sum(wb[..., None] * tgt, axis=-2) / jnp.sum(wb, axis=-1, keepdims=True)
    r, _, rms = kabsch(
        jnp.asarray(ref_prepared)[None, ...], tgt, w_eff,
        jnp.asarray(ref_centroid)[None, :], cq,
    )
    return r, rms


def fit_transform(all_positions, box, group_com, rotation, ref_group_com):
    """Apply an RMSD fit to all atoms of a frame (reference rmsd.rs:508-533).

    1. translate every atom by (box_center - group_com), wrapping into the box
    2. translate by -box_center (no PBC)
    3. rotate by `rotation` (no PBC)
    4. translate by `ref_group_com` (no PBC)
    """
    all_positions = jnp.asarray(all_positions)
    box = jnp.asarray(box, dtype=all_positions.dtype)
    box_center = box * 0.5
    moved = wrap(all_positions + (box_center - jnp.asarray(group_com))[..., None, :], box)
    centered = moved - box_center
    # reference applies nalgebra `rotate_nopbc(R)` = R @ x (column vectors);
    # with row-vector arrays that is x @ R^T
    rotated = jnp.einsum("...ni,...ji->...nj", centered, jnp.asarray(rotation), precision=_HI)
    return rotated + jnp.asarray(ref_group_com)[..., None, :]
