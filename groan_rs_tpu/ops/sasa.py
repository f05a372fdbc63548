"""Solvent-accessible surface area — Shrake-Rupley on device (surpass).

The reference has no SASA analysis; this covers the `gmx sasa` workload
the batched way: a Fibonacci-lattice point sphere per atom, neighbour
occlusion tested as one dense batched tensor op per frame.  The
algorithm is exact-by-construction for the returned result: neighbour
candidates are capped at `max_neighbors` per atom for the [K, N, M]
occlusion tensor, but the number of RELEVANT neighbours (those whose
spheres can overlap at all) is counted on device and the caller raises
if the cap was ever exceeded — no silent truncation.

Shapes are static and chunked so peak memory stays bounded:
`lax.map` over frames, `lax.map` over atom chunks inside a frame
(pairwise rows [C, K] -> top-M neighbour gather [C, M] -> occlusion
[C, N, M]).  Everything is float32 elementwise work that XLA fuses;
the per-chunk top_k is the only non-trivial primitive.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fibonacci_sphere", "sasa_frames", "sasa_frames_host_f64"]


def fibonacci_sphere(n: int) -> np.ndarray:
    """`[n, 3]` near-uniform unit sphere points (golden-spiral lattice)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.pi * (np.sqrt(5.0) + 1.0) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=1).astype(np.float32)


def sasa_frames(pos, boxes, radii, *, probe: float = 0.14,
                n_points: int = 192, max_neighbors: int = 64,
                chunk: int = 256):
    """Per-atom SASA for a batch of frames.

    pos: `[F, K, 3]` positions; boxes: `[F, 3]` orthorhombic lengths or
    `[F, 3, 3]` triclinic box matrices (exact 27-image minimum image);
    radii: `[K]` vdW radii (nm).  Returns `(areas, max_relevant)`:
    `areas [F, K]` in nm^2 and the largest per-atom relevant-neighbour
    count over the whole batch (validate `<= max_neighbors` host-side).
    """
    import jax
    import jax.numpy as jnp

    from .pbc import min_image, min_image_triclinic

    pos = jnp.asarray(pos, jnp.float32)
    boxes = jnp.asarray(boxes, jnp.float32)
    k = int(pos.shape[1])
    m = min(int(max_neighbors), k - 1) if k > 1 else 1
    c = min(int(chunk), k)
    n_chunks = -(-k // c)
    pad = n_chunks * c - k

    big = jnp.float32(1e9)
    r_ext = jnp.asarray(radii, jnp.float32) + jnp.float32(probe)  # [K]
    pts = jnp.asarray(fibonacci_sphere(int(n_points)))            # [N, 3]

    def one_frame(args):
        p, box = args                       # [K, 3], [3]
        if pad:
            # pad rows far away so they never interact
            p_pad = jnp.concatenate(
                [p, jnp.full((pad, 3), 2.0 * big, p.dtype)], axis=0)
        else:
            p_pad = p

        def one_chunk(start):
            pc = jax.lax.dynamic_slice_in_dim(p_pad, start, c, axis=0)
            rc = jax.lax.dynamic_slice_in_dim(
                jnp.concatenate([r_ext, jnp.zeros((pad,), r_ext.dtype)])
                if pad else r_ext, start, c, axis=0)        # [C]
            # j relative to i (x_j - x_i), matching the host oracle
            raw = p[None, :, :] - pc[:, None, :]
            d = (min_image_triclinic(raw, box) if box.ndim == 2
                 else min_image(raw, box))                  # [C, K, 3]
            d2 = jnp.sum(d * d, axis=-1)                        # [C, K]
            rows = start + jnp.arange(c)
            self_mask = rows[:, None] == jnp.arange(k)[None, :]
            dist = jnp.sqrt(d2)
            # j is relevant to i iff their extended spheres intersect
            relevant = (dist < rc[:, None] + r_ext[None, :]) & ~self_mask
            n_rel = jnp.sum(relevant, axis=1)                   # [C]
            # rank by how deeply j's sphere cuts i's: most negative
            # (dist - R_i - R_j) first; irrelevant pairs pushed to +big
            key = jnp.where(relevant, dist - rc[:, None] - r_ext[None, :],
                            big)
            neg_key, idx = jax.lax.top_k(-key, m)               # [C, M]
            valid = neg_key > -big / 2                           # relevant
            dj = jnp.take_along_axis(d, idx[:, :, None], axis=1)  # [C, M, 3]
            rj = r_ext[idx]                                      # [C, M]
            # sphere points of atom i: q_n = R_i * u_n (relative to x_i);
            # blocked by j iff |q_n - d_ij| < R_j
            q = rc[:, None, None] * pts[None, :, :]              # [C, N, 3]
            diff = q[:, :, None, :] - dj[:, None, :, :]          # [C, N, M, 3]
            dd2 = jnp.sum(diff * diff, axis=-1)                  # [C, N, M]
            blocked = (dd2 < (rj * rj)[:, None, :]) & valid[:, None, :]
            acc = 1.0 - jnp.any(blocked, axis=-1).astype(jnp.float32)
            frac = jnp.mean(acc, axis=-1)                        # [C]
            area = 4.0 * jnp.pi * rc * rc * frac
            return area, n_rel

        starts = jnp.arange(n_chunks) * c
        areas, n_rel = jax.lax.map(one_chunk, starts)
        return areas.reshape(-1)[:k], n_rel.reshape(-1)[:k]

    areas, n_rel = jax.lax.map(one_frame, (pos, boxes))
    return areas, jnp.max(n_rel)


def sasa_frames_host_f64(pos, boxes, radii, *, probe: float = 0.14,
                         n_points: int = 192):
    """Float64 host oracle: identical point set, ALL neighbours (no cap);
    orthorhombic minimum image, or brute-force 125-image search for
    `[F, 3, 3]` triclinic boxes."""
    pos = np.asarray(pos, np.float64)
    boxes = np.asarray(boxes, np.float64)
    r = np.asarray(radii, np.float64) + probe
    pts = fibonacci_sphere(n_points).astype(np.float64)
    f, k = pos.shape[0], pos.shape[1]
    shifts = None
    if boxes.ndim == 3:
        g = np.array([-2, -1, 0, 1, 2])
        shifts = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                          axis=-1).reshape(-1, 3).astype(np.float64)
    out = np.zeros((f, k))
    for fi in range(f):
        box = boxes[fi]
        for i in range(k):
            d = pos[fi] - pos[fi, i]
            if shifts is not None:
                cands = d[:, None, :] + (shifts @ box)[None, :, :]
                best = np.argmin((cands * cands).sum(-1), axis=1)
                d = cands[np.arange(k), best]
            else:
                d -= box * np.round(d / box)             # [K, 3], j rel. i
            q = r[i] * pts                               # [N, 3]
            blocked = np.zeros(len(pts), bool)
            for j in range(k):
                if j == i:
                    continue
                dd = q - d[j]
                blocked |= (dd * dd).sum(1) < r[j] * r[j]
            out[fi, i] = 4.0 * np.pi * r[i] * r[i] * (1.0 - blocked.mean())
    return out
