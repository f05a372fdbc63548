"""Distance kernels: centers, pairs, N x M distance matrices and pair
reductions.

Batched re-design of `src/system/analysis.rs`:
- `group_distance` (analysis.rs:348) -> `center_distance`
- `group_all_distances` (analysis.rs:401, N x M pair matrix) ->
  `distance_matrix`.

Callers that only need a reduction over the pair matrix (minimum
distance, contact counts) use `min_distance` / `contact_count`, which never
form the N x M matrix: rows of the first set are taken a chunk at a time
under `lax.map`, and each chunk is one fused elementwise-plus-reduce pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import pbc
from .center import center
from .pbc import distance, min_image

# elements of one [frames, rows, M] chunk of the pair reduction: bounds the
# intermediate should XLA not fuse the reduction into its producer
_PAIR_CHUNK_ELEMS = 1 << 27


def _box_rows(box, like):
    """Normalize a broadcast-shaped box ([..., 1, 3]) to [..., 3]."""
    box = jnp.asarray(box, dtype=like.dtype)
    if box.ndim >= 2 and box.shape[-2] == 1:
        box = box.reshape(box.shape[:-2] + (3,))
    return box

__all__ = [
    "center_distance",
    "pair_distances",
    "distance_matrix",
    "distance_matrix_masked",
    "contact_count",
    "min_distance",
    "residue_min_matrix",
    "self_image_min",
]


def residue_min_matrix(pos, boxes, block_idx, block_mask, *,
                       chunk: int = 16):
    """Smallest atom-atom PBC distance between residue blocks, per frame
    (the `gmx mdmat` kernel; surpass — the reference has whole-group
    N x M matrices only, analysis.rs:401).

    pos: `[F, K, 3]`; boxes: `[F, 3]` lengths or `[F, 3, 3]` triclinic
    matrices (exact 27-image minimum image); block_idx: `[R, P]` atom
    indices into K, padded; block_mask: `[R, P]` validity.  Returns
    `[F, R, R]`.
    Rows evaluate `chunk` residues at a time under `lax.map` so peak
    memory is the `[chunk, R, P, P, 3]` displacement tile.
    """
    pos = jnp.asarray(pos, jnp.float32)
    bi = jnp.asarray(block_idx, jnp.int32)
    bm = jnp.asarray(block_mask, bool)
    r, p = bi.shape
    n_chunks = -(-r // chunk)
    pad = n_chunks * chunk - r
    bi_p = jnp.concatenate([bi, jnp.zeros((pad, p), bi.dtype)]) if pad else bi
    bm_p = jnp.concatenate([bm, jnp.zeros((pad, p), bool)]) if pad else bm
    big = jnp.float32(1e30)

    def one_frame(args):
        pf, box = args
        g = pf[bi]                                   # [R, P, 3]
        g_p = pf[bi_p]                               # [R+pad, P, 3]

        def rows(start):
            ga = jax.lax.dynamic_slice_in_dim(g_p, start, chunk)  # [C,P,3]
            ma = jax.lax.dynamic_slice_in_dim(bm_p, start, chunk)  # [C,P]
            d = ga[:, None, :, None, :] - g[None, :, None, :, :]
            d = (pbc.min_image_triclinic(d, box) if box.ndim == 2
                 else min_image(d, box))              # [C, R, P, P, 3]
            d2 = jnp.sum(d * d, axis=-1)
            valid = ma[:, None, :, None] & bm[None, :, None, :]
            d2 = jnp.where(valid, d2, big)
            return jnp.sqrt(jnp.min(d2, axis=(-2, -1)))  # [C, R]

        out = jax.lax.map(rows, jnp.arange(n_chunks) * chunk)
        return out.reshape(-1, r)[:r]

    return jax.lax.map(one_frame, (pos, boxes))


def center_distance(pos_a, pos_b, box, dim_mask, mask_a=None, mask_b=None,
                    weights_a=None, weights_b=None):
    """Distance between the (refined) centers of two selections.

    Matches `System::group_distance` (analysis.rs:348): centers via the
    refined Bai-Breen pipeline, then a PBC distance along `dim_mask`.
    """
    ca = center(pos_a, box, mask=mask_a, weights=weights_a)
    cb = center(pos_b, box, mask=mask_b, weights=weights_b)
    return distance(ca, cb, box, dim_mask)


def pair_distances(a, b, box, dim_mask=(True, True, True)):
    """Elementwise distances between matched points `[..., K, 3]` -> `[..., K]`."""
    return distance(a, b, box, dim_mask)


def _axis_min_image_diff(a, b, box):
    """Per-axis min-image differences a[..., N, 1, :] - b[..., 1, M, :]."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return min_image(d, box[..., None, None, :])


def distance_matrix(a, b, box, dim_mask=(True, True, True)):
    """`[..., N, M]` PBC distance matrix between two point sets.

    Matches `System::group_all_distances` (analysis.rs:401).  With a single
    active axis the entries are oriented differences (reference semantics).
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    box = jnp.asarray(box, dtype=a.dtype)
    mask = jnp.asarray(dim_mask, dtype=bool)
    n_active = int(sum(bool(v) for v in dim_mask))
    d = _axis_min_image_diff(a, b, box)
    if n_active == 0:
        return jnp.zeros(d.shape[:-1], dtype=a.dtype)
    if n_active == 1:
        return jnp.sum(jnp.where(mask, d, 0.0), axis=-1)
    d = jnp.where(mask, d, 0.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def distance_matrix_masked(a, b, box, mask_a, mask_b, fill=jnp.nan,
                           dim_mask=(True, True, True)):
    """Distance matrix with invalid rows/cols filled (for padded selections)."""
    m = distance_matrix(a, b, box, dim_mask)
    valid = jnp.asarray(mask_a)[..., :, None] & jnp.asarray(mask_b)[..., None, :]
    return jnp.where(valid, m, fill)


def _pair_reduce(a, b, box, cut2, mask_a, mask_b, chunk_elems=None):
    """Reduce minimum-image d^2 over all (i, j) pairs of `a` [..., N, 3]
    and `b` [..., M, 3] in an orthorhombic `box` ([..., 3] or [..., 1, 3]):
    the smallest d^2 when `cut2` is None, else the number of pairs with
    d^2 < cut2.  Masked-out atoms take no part.  -> [...]

    Per axis d - L * floor(d * (1/L) + 0.5), then dx^2 + dy^2 + dz^2 (the
    sign convention of `pbc.min_image` at exactly L/2 does not change d^2).
    Rows of `a` go `chunk_elems // (frames * M)` at a time under `lax.map`
    (default `_PAIR_CHUNK_ELEMS`).  Lowered for a GPU, an unmasked
    reduction with no explicit `chunk_elems` runs as the `ops.pair_triton`
    kernel instead: the same arithmetic, faster on an H100 (PERF.md).
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    box = _box_rows(box, a)
    n, m = a.shape[-2], b.shape[-2]
    lead = jnp.broadcast_shapes(a.shape[:-2], b.shape[:-2], box.shape[:-1])
    f = int(np.prod(lead, dtype=np.int64))
    a = jnp.broadcast_to(a, lead + (n, 3)).reshape(f, n, 3)
    b = jnp.broadcast_to(b, lead + (m, 3)).reshape(f, m, 3)
    box = jnp.broadcast_to(box, lead + (3,)).reshape(f, 3)
    inv = 1.0 / box

    if mask_a is None and mask_b is None and chunk_elems is None:
        from . import pair_triton

        def plain(a, b, box):
            return _pair_reduce(a, b, box, cut2, None, None,
                                _PAIR_CHUNK_ELEMS)

        out = jax.lax.platform_dependent(
            a, b, box, default=plain,
            cuda=lambda a, b, box: pair_triton.pair_reduce(a, b, box, cut2))
        return out.reshape(lead)
    if chunk_elems is None:
        chunk_elems = _PAIR_CHUNK_ELEMS
    rows = int(max(1, min(n, chunk_elems // max(1, f * m))))
    n_chunks = -(-n // rows)
    pad = n_chunks * rows - n
    ma = None
    if mask_a is not None or pad:
        ma = (jnp.ones((f, n), bool) if mask_a is None else
              jnp.broadcast_to(jnp.asarray(mask_a, bool), lead + (n,))
              .reshape(f, n))
        ma = jnp.pad(ma, ((0, 0), (0, pad)))
        ma = ma.reshape(f, n_chunks, rows).transpose(1, 0, 2)
    mb = (None if mask_b is None else
          jnp.broadcast_to(jnp.asarray(mask_b, bool), lead + (m,))
          .reshape(f, 1, m))
    a_c = jnp.pad(a, ((0, 0), (0, pad), (0, 0)))
    a_c = a_c.reshape(f, n_chunks, rows, 3).transpose(1, 3, 0, 2)
    b_s = [b[:, None, :, k] for k in range(3)]          # [F, 1, M] each
    box_s = [box[:, k, None, None] for k in range(3)]   # [F, 1, 1] each
    inv_s = [inv[:, k, None, None] for k in range(3)]

    def chunk(args):
        ac, mc = args                                   # [3, F, rows]
        d2 = None
        for k in range(3):
            d = ac[k][:, :, None] - b_s[k]
            d = d - box_s[k] * jnp.floor(d * inv_s[k] + 0.5)
            d2 = d * d if d2 is None else d2 + d * d
        valid = None
        if mc is not None:
            valid = mc[:, :, None]
        if mb is not None:
            valid = mb if valid is None else valid & mb
        if cut2 is None:
            if valid is not None:
                d2 = jnp.where(valid, d2, jnp.inf)
            return jnp.min(d2, axis=(1, 2))
        hit = d2 < cut2
        if valid is not None:
            hit = hit & valid
        return jnp.sum(hit, axis=(1, 2), dtype=jnp.int32)

    parts = jax.lax.map(chunk, (a_c, ma))               # [n_chunks, F]
    out = jnp.min(parts, axis=0) if cut2 is None else jnp.sum(parts, axis=0)
    return out.reshape(lead)


def contact_count(a, b, box, cutoff, mask_a=None, mask_b=None):
    """Number of pairs within `cutoff` (d^2 < cutoff^2, both float32),
    without forming the N x M matrix.  a [..., N, 3], b [..., M, 3]."""
    cut2 = float(np.float32(cutoff) * np.float32(cutoff))
    return _pair_reduce(a, b, box, cut2, mask_a, mask_b)


def min_distance(a, b, box, mask_a=None, mask_b=None):
    """Minimum PBC distance between two selections, without forming the
    N x M matrix (reference analogue: the minimum of
    group_all_distances, analysis.rs:401); inf when a mask leaves no
    pair."""
    return jnp.sqrt(_pair_reduce(a, b, box, None, mask_a, mask_b))


def pair_distance_histogram(a, b, box, r_max, n_bins: int,
                            exclude_self: bool = False, dist=None):
    """Per-frame histogram of PBC pair distances in (0, r_max] -> `[..., n_bins]`.

    The RDF building block (surpass feature; the reference has no RDF).
    Bin k counts pairs with distance in (k*dr, (k+1)*dr], dr = r_max/n_bins.
    `exclude_self=True` drops the diagonal (same-group RDF).  The bin index
    is computed on device and accumulated with a scatter-add; XLA keeps the
    [N, M] intermediate fused with the binning.  `dist` supplies a
    precomputed `[..., N, M]` distance matrix (the triclinic path, whose
    minimum image `distance_matrix` does not evaluate).
    """
    d = distance_matrix(a, b, box) if dist is None else jnp.asarray(dist)
    dr = r_max / n_bins
    idx = jnp.ceil(d / dr).astype(jnp.int32) - 1  # (0, dr] -> bin 0
    valid = (d > 0.0) & (idx >= 0) & (idx < n_bins)
    if exclude_self:
        n, m = d.shape[-2], d.shape[-1]
        eye = jnp.eye(n, m, dtype=bool)
        valid = valid & ~eye
    idx = jnp.clip(idx, 0, n_bins - 1)

    flat_idx = idx.reshape(idx.shape[:-2] + (-1,))
    flat_ok = valid.reshape(valid.shape[:-2] + (-1,))

    def one(ii, ok):
        return jnp.zeros(n_bins, jnp.int32).at[ii].add(ok.astype(jnp.int32))

    if flat_idx.ndim == 1:
        return one(flat_idx, flat_ok)
    return jax.vmap(one)(flat_idx.reshape(-1, flat_idx.shape[-1]),
                         flat_ok.reshape(-1, flat_ok.shape[-1])).reshape(
        idx.shape[:-2] + (n_bins,))


def rdf_normalization(box_lengths, n_a: int, n_b: int, r_max, n_bins: int,
                      exclude_self: bool = False):
    """Ideal-gas shell counts for normalizing a pair histogram into g(r):
    g(r_k) = hist_k / (n_pairs * V_shell_k / V_box), `[..., n_bins]`."""
    dr = r_max / n_bins
    edges = np.arange(n_bins + 1) * dr
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    b = jnp.asarray(box_lengths, jnp.float32)
    # [B, 3] orthorhombic lengths or [B, 3, 3] triclinic matrices (the
    # batched forms both call sites use; ndim disambiguates — a shape
    # test could not tell 3 frames of lengths from one matrix)
    vol = (jnp.abs(jnp.linalg.det(b)) if b.ndim >= 3
           else jnp.prod(b, axis=-1))
    n_pairs = n_a * n_b - (n_a if exclude_self else 0)
    return n_pairs * jnp.asarray(shell, jnp.float32) / vol[..., None]


def self_image_min(pos, boxes, *, chunk: int = 128):
    """Shortest distance between a group and its own periodic images,
    per frame (the `gmx mindist -pi` kernel; surpass — absent from the
    reference).

    For every non-zero image shift S = n @ B (n in {-1, 0, 1}^3, B the
    box row vectors — triclinic supported) and every atom pair (i, j)
    including i == j (an atom's distance to its own image is |S|), take
    min |x_i - x_j + S|.  Alongside it, the group's largest INTERNAL
    distance max_ij |x_i - x_j| (no image) — the two numbers gmx
    mindist -pi prints to judge whether the box is large enough.

    pos: `[F, K, 3]`; boxes: `[F, 3]` lengths or `[F, 3, 3]` row
    matrices.  Row chunks of `chunk` atoms evaluate under `lax.map`
    (peak tile `[chunk, K, 3]`); the 26 shifts fold in a `fori_loop`
    over a running `[chunk, K]` minimum so the tile never grows with
    the image count.

    Returns `(min_image [F], max_internal [F])` in nm (float32).
    """
    pos = jnp.asarray(pos, jnp.float32)
    f, k, _ = pos.shape
    boxes = jnp.asarray(boxes, jnp.float32)
    rows = (jnp.eye(3, dtype=jnp.float32)[None] * boxes[:, None, :]
            if boxes.ndim == 2 else boxes)

    nvec = np.array([(a, b, c)
                     for a in (-1, 0, 1) for b in (-1, 0, 1)
                     for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)],
                    np.float32)                                   # [26, 3]
    nvec = jnp.asarray(nvec)

    n_chunks = -(-k // chunk)
    pad = n_chunks * chunk - k
    pos_p = (jnp.concatenate(
        [pos, jnp.zeros((f, pad, 3), jnp.float32)], axis=1) if pad else pos)
    big = jnp.float32(1e30)

    def one_frame(args):
        pf, rw = args                       # [Kp, 3], [3, 3]
        shifts = nvec @ rw                  # [26, 3]

        def one_chunk(c):
            xc = jax.lax.dynamic_slice(pf, (c * chunk, 0), (chunk, 3))
            rmask = (c * chunk + jnp.arange(chunk)) < k       # [chunk]
            d = xc[:, None, :] - pf[None, :k, :]              # [chunk,K,3]
            d2_0 = jnp.sum(d * d, axis=-1)                    # [chunk, K]
            mx = jnp.max(jnp.where(rmask[:, None], d2_0, -1.0))

            def body(i, carry):
                dd = d + shifts[i][None, None, :]
                d2 = jnp.sum(dd * dd, axis=-1)
                return jnp.minimum(
                    carry, jnp.min(jnp.where(rmask[:, None], d2, big)))

            mn = jax.lax.fori_loop(0, 26, body, big)
            return mn, mx

        mins, maxs = jax.lax.map(one_chunk, jnp.arange(n_chunks))
        return jnp.sqrt(jnp.min(mins)), jnp.sqrt(jnp.maximum(
            jnp.max(maxs), 0.0))

    mn, mx = jax.lax.map(one_frame, (pos_p, rows))
    return mn, mx
