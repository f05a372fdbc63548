"""Seeded synthetic membrane-protein trajectories and float64 references.

The benchmark (`bench.py`) and the on-card smoke run (`chip_smoke.py`)
both drive the flagship pass over the same synthetic system and check it
against the same plain float64 host recomputations, kept here:

- `ensure_trajectory` writes (once, atomically) an XTC with the native
  codec: a Gaussian protein blob at the box center, a lipid-like membrane
  slab, and water triplets, all spatially sorted like real Gromacs output;
- `build_system` gives it a programmatic `System` with seeded masses and
  the `Protein` / `Membrane` / `Peptide` groups;
- `host_refined_center`, `host_kabsch_rmsd`, `host_flagship_series` and
  `host_pair_reference` are the float64 references (refined Bai-Breen
  center, iterators.rs:1237-1266; Kabsch with an unweighted covariance
  and a mass-weighted RMSD, rmsd.rs:547-604; minimum-image pair
  distances).
"""

from __future__ import annotations

import os

import numpy as np

BOX_NM = 21.0
PRECISION = 1000.0


def group_sizes(n_atoms: int) -> tuple[int, int]:
    """(protein, membrane) atom counts of an `n_atoms` system: 99k and
    300k at 1M atoms, scaled down for smaller systems."""
    return min(99_000, n_atoms // 10), min(300_000, n_atoms // 3)


def _cell_order(points, cell=0.5):
    """Spatial sort order (cell-major), as solvate/insert tools lay out
    molecules: real XTC files are spatially coherent, which is what the
    3dfcoord delta coder exploits."""
    key = np.floor(points / cell).astype(np.int64)
    return np.lexsort((key[:, 2], key[:, 1], key[:, 0]))


def initial_positions(n_atoms: int, seed: int = 42) -> np.ndarray:
    """Frame-0 coordinates `[n_atoms, 3]` (float32, nm)."""
    n_prot, n_mem = group_sizes(n_atoms)
    rng = np.random.default_rng(seed)
    box = np.full(3, BOX_NM, np.float32)
    pos = np.empty((n_atoms, 3), np.float32)

    # protein: Gaussian blob at the box center with physical atom density
    # (~100 atoms/nm^3); an overdense blob makes consecutive sorted atoms
    # nearly coincident, which defeats the XTC encoder's run coding
    sigma = max(1.0, (n_prot / 100.0) ** (1.0 / 3.0) / 2.0)
    prot = box / 2 + rng.normal(size=(n_prot, 3)).astype(np.float32) * sigma
    pos[:n_prot] = prot[_cell_order(prot)]

    # membrane: ~50-atom lipids; heads uniform in the slab, atoms a short
    # random walk below the head; lipids sorted by position
    lip_sz = 50
    n_lip = (n_mem + lip_sz - 1) // lip_sz
    heads = rng.uniform(0, 1, size=(n_lip, 3)).astype(np.float32)
    heads[:, :2] *= box[:2]
    heads[:, 2] = 8.0 + heads[:, 2] * 5.0
    heads = heads[_cell_order(heads, cell=1.0)]
    walk = np.cumsum(
        rng.normal(size=(n_lip, lip_sz, 3)).astype(np.float32) * 0.08, axis=1)
    pos[n_prot:n_prot + n_mem] = (heads[:, None, :] + walk).reshape(-1, 3)[:n_mem]

    # water: triplet molecules, spatially sorted like gmx solvate's fill
    n_wat = n_atoms - n_prot - n_mem
    n_mol = (n_wat + 2) // 3
    centers = rng.uniform(0, 1, size=(n_mol, 3)).astype(np.float32) * box
    centers = centers[_cell_order(centers)]
    offsets = rng.normal(size=(n_mol, 2, 3)).astype(np.float32) * 0.06
    trip = np.stack(
        [centers, centers + offsets[:, 0], centers + offsets[:, 1]], axis=1)
    pos[n_prot + n_mem:] = trip.reshape(-1, 3)[:n_wat]
    pos %= box
    return pos


def write_trajectory(path, n_atoms: int, n_frames: int, seed: int = 42,
                     log=None):
    """Write `n_frames` frames: frame 0 from `initial_positions`, then a
    seeded rigid drift plus per-atom jitter each frame."""
    from .io import native

    box = np.full(3, BOX_NM, np.float32)
    box9 = np.diag(box).astype(np.float32).reshape(9)
    drift_rng = np.random.default_rng(7)
    cur = initial_positions(n_atoms, seed)
    for f in range(n_frames):
        if f:
            cur = (cur
                   + drift_rng.normal(size=(1, 3)).astype(np.float32) * 0.05
                   + drift_rng.normal(size=cur.shape).astype(np.float32) * 0.01
                   ) % box
        native.xtc_write_frame(path, n_atoms, f * 1000, f * 10.0, box9, cur,
                               PRECISION)
        if log is not None:
            log(f"  wrote frame {f + 1}/{n_frames}")


def ensure_trajectory(cache_dir, n_atoms: int, n_frames: int, log=None) -> str:
    """Path of the cached synthetic XTC, written on first use.  A cached
    file with the wrong frame or atom count (an interrupted build) is
    rebuilt; the build writes to a temporary name and renames it."""
    from .io import native

    os.makedirs(cache_dir, exist_ok=True)
    xtc = os.path.join(cache_dir, f"bench_v4_{n_atoms}_{n_frames}.xtc")
    if os.path.exists(xtc):
        try:
            offs, _, _, nat = native.xtc_scan(xtc)
            if len(offs) == n_frames and nat == n_atoms:
                return xtc
        except Exception:  # unreadable cache entry: rebuild below
            pass
        os.unlink(xtc)
    tmp = xtc + ".tmp"
    if os.path.exists(tmp):
        os.unlink(tmp)
    write_trajectory(tmp, n_atoms, n_frames, log=log)
    os.replace(tmp, xtc)
    return xtc


def build_system(n_atoms: int, frame0, box):
    """Programmatic System with seeded masses and index groups (no text
    I/O) -> (system, masses)."""
    from .core.simbox import SimBox
    from .core.topology import Topology
    from .system import System

    n_prot, n_mem = group_sizes(n_atoms)
    rng = np.random.default_rng(3)
    masses = rng.uniform(1.0, 16.0, size=n_atoms).astype(np.float32)
    topo = Topology(n_atoms)
    topo.mass = masses
    topo.has_mass = np.ones(n_atoms, bool)
    topo.atomnum = np.arange(1, n_atoms + 1, dtype=np.int64)
    topo.resnum = np.arange(n_atoms, dtype=np.int64) // 3 + 1
    s = System("bench", topo, simbox=SimBox.from_lengths(*map(float, box)),
               positions=frame0)
    s.set_precision(int(PRECISION))
    s.group_create_from_ranges("Protein", [(0, n_prot - 1)])
    s.group_create_from_ranges("Membrane", [(n_prot, n_prot + n_mem - 1)])
    s.group_create_from_ranges("Peptide", [(0, min(400, n_prot) - 1)])
    return s, masses


# float32 reach on coordinates up to 21 nm: ~2e-6 nm of rounding per
# coordinate plus a few 1e-6 nm of error in a 1e5-atom center
WRAP_DELTA_NM = 1e-5


def _estimate(p, box):
    """Bai-Breen circular-mean estimate of `p` and the distance its float32
    evaluation may be off -> ([3], [3]) nm.  Each float32 trig term is
    good to ~5e-7 and the sums to ~1e-6 sqrt(N); the estimate's angle
    moves by that over the resultant length, which is small for a group
    spread evenly over the box (a membrane slab along x and y)."""
    theta = np.mod(p, box) * (2 * np.pi / box)
    xi = np.cos(theta).sum(0)
    zeta = np.sin(theta).sum(0)
    est = (np.arctan2(-zeta, -xi) + np.pi) * box / (2 * np.pi)
    err = box / (2 * np.pi) * 1e-6 * np.sqrt(len(p)) / np.hypot(xi, zeta)
    return est, err


def _unwrapped_mean(p, box, est, w=None):
    half = box / 2
    d = p - est + half
    unwrapped = est + (d - box * np.floor(d / box) - half)
    if w is None:
        return unwrapped.mean(0)
    w = np.asarray(w, np.float64)
    return (unwrapped * w[:, None]).sum(0) / w.sum()


def host_refined_center(p, box, w=None):
    """Float64 refined Bai-Breen center (iterators.rs:1237-1266)."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    return _unwrapped_mean(p, box, _estimate(p, box)[0], w)


def center_spread(p, box, w=None):
    """Refined center and how far float32 evaluation may move it ->
    ([3], [3]) nm: the center recomputed with the estimate shifted by its
    float32 uncertainty plus `WRAP_DELTA_NM`, which flips the atoms that
    sit that close to an unwrap plane."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    est, err = _estimate(p, box)
    c = _unwrapped_mean(p, box, est, w)
    shift = err + WRAP_DELTA_NM
    return c, np.maximum(
        np.abs(_unwrapped_mean(p, box, est + shift, w) - c),
        np.abs(_unwrapped_mean(p, box, est - shift, w) - c))


def wrap_fraction(p, box, center, delta, w=None):
    """Largest per-axis weight fraction of `p` within `delta` of the
    periodic wrap planes center +- box/2."""
    box = np.asarray(box, np.float64)
    d = np.mod(np.asarray(p, np.float64) - center + box / 2, box)
    near = np.minimum(d, box - d) < delta
    w = np.ones(len(d)) if w is None else np.asarray(w, np.float64)
    return float(((w[:, None] * near).sum(0) / w.sum()).max())


def host_kabsch_rmsd(ref, ref_com, p, box, w):
    """Float64 Kabsch RMSD vs prepared reference coords (rmsd.rs:547-604:
    center both on the box center via the refined COM, unweighted
    covariance, SVD with the determinant sign fix, mass-weighted RMSD;
    the convention of `ops.rmsd.kabsch`)."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    w = np.asarray(w, np.float64)
    com = host_refined_center(p, box, w)
    center = box / 2
    qc = np.mod(p + (center - com), box) - center
    pc = np.asarray(ref, np.float64) - np.asarray(ref_com, np.float64)
    h = pc.T @ qc
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    p_rot = pc @ rot.T
    return float(np.sqrt((w * ((p_rot - qc) ** 2).sum(-1)).sum() / w.sum()))


def host_flagship_series(coords, frame0, box, idx_a, idx_b, w_a):
    """Float64 series of the flagship observables over `coords` [F, N, 3]:
    -> dict(com [F, 3] of group a (mass-weighted), dist [F] between the
    COM of a and the center of geometry of b, rmsd [F] of a vs frame0,
    flip [F]: the most float32 evaluation may move any of them in that
    frame, through the centers' estimates (`center_spread`) and through
    atoms on the RMSD's wrap planes)."""
    box = np.asarray(box, np.float64)
    l2 = float((box * box).sum())
    ref_com = host_refined_center(frame0[idx_a], box, w_a)
    ref = np.mod(np.asarray(frame0[idx_a], np.float64) + (box / 2 - ref_com),
                 box) - box / 2
    ref_near = wrap_fraction(frame0[idx_a], box, ref_com, WRAP_DELTA_NM, w_a)
    n = len(coords)
    com = np.empty((n, 3))
    dist = np.empty(n)
    rmsd = np.empty(n)
    flip = np.empty(n)
    for f in range(n):
        pa = np.asarray(coords[f][idx_a], np.float64)
        pb = np.asarray(coords[f][idx_b], np.float64)
        com[f], spread_a = center_spread(pa, box, w_a)
        cb, spread_b = center_spread(pb, box)
        d = com[f] - cb
        d -= box * np.round(d / box)
        dist[f] = np.sqrt((d * d).sum())
        rmsd[f] = host_kabsch_rmsd(ref, np.zeros(3), pa, box, w_a)
        # the RMSD wraps around the COM: atoms within its float32 reach of
        # a wrap plane may land a box length away
        near = ref_near + wrap_fraction(pa, box, com[f],
                                        WRAP_DELTA_NM + spread_a.max(), w_a)
        rmsd_flip = np.sqrt(rmsd[f] ** 2 + l2 * near) - rmsd[f]
        flip[f] = max(np.linalg.norm(spread_a) + np.linalg.norm(spread_b),
                      rmsd_flip + np.linalg.norm(spread_a))
    return {"com": com, "dist": dist, "rmsd": rmsd, "flip": flip}


def host_pair_reference(a, b, box, cutoff, band, rows: int = 512):
    """Float64 minimum-image pair reduction between `a` [N, 3] and `b`
    [M, 3] in an orthorhombic `box` -> (min distance, contacts with
    d < cutoff - band, contacts with d < cutoff + band)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    box = np.asarray(box, np.float64)
    lo2 = (cutoff - band) ** 2
    hi2 = (cutoff + band) ** 2
    best, n_lo, n_hi = np.inf, 0, 0
    for r0 in range(0, len(a), rows):
        d2 = np.zeros((min(rows, len(a) - r0), len(b)))
        for ax in range(3):
            d = a[r0:r0 + rows, ax, None] - b[None, :, ax]
            d -= box[ax] * np.round(d / box[ax])
            d2 += d * d
        best = min(best, float(d2.min()))
        n_lo += int((d2 < lo2).sum())
        n_hi += int((d2 < hi2).sum())
    return float(np.sqrt(best)), n_lo, n_hi
