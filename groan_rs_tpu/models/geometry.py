"""Geometric/surface analyses (SASA, free volume, SDF grids, helix/bundle/angle/pair-distance tools, ordered-atom selections).

Split out of models/pipeline.py (one module per analysis family); shared
loaders/helpers live in `models.pipeline`.  All public names remain
importable as `groan_rs_tpu.models.<name>` and `groan_rs_tpu.models.pipeline.<name>`.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.dimension import Dimension
from ..errors import GroupError, ParallelError, RMSDError
from ..ops import center as center_ops
from ..ops import distances as distance_ops
from ..ops import geometry
from ..ops import pbc
from ..ops import rmsd as rmsd_ops

from .pipeline import (  # shared core helpers
    _AXIS,
    _G1_SITE_WIDTH,
    _resident_group_pos,
    _residue_blocks,
    _sel_indices,
    _transient_indices,
    _unit_tables,
)

# four float32 ulps below 1: the closest to 1 a float32 bond correlation
# can be told apart from it
_C1_ULPS = 4 * float(np.finfo(np.float32).eps)


def _mi(d, box):
    """Per-frame minimum image: `box` is [3] orthorhombic lengths or a
    [3, 3] triclinic row matrix (exact 27-image search).  Shared by the
    per-frame lax.map bodies below so every geometric analysis accepts
    box-matrix trajectories."""
    return (pbc.min_image_triclinic(d, box) if box.ndim == 2
            else pbc.min_image(d, box))


def _ctr(pf, box, w=None):
    """Per-frame refined center dispatching on the box representation."""
    if box.ndim == 2:
        return center_ops.center_triclinic(pf, box, weights=w)
    return center_ops.center(pf, box, weights=w)


def sasa(system, trajectory, group: str, *, probe: float = 0.14,
         n_points: int = 192, max_neighbors: int = 64, radii=None,
         batch_size: int = 32):
    """Solvent-accessible surface area per frame and atom (surpass —
    `gmx sasa` / Shrake-Rupley; the reference has no SASA analysis).

    Each atom gets a Fibonacci lattice of `n_points` test points on its
    extended sphere (vdW + `probe`, nm); a point is buried if it falls
    inside any neighbour's extended sphere.  The occlusion test runs as
    dense batched tensor ops on device (`ops/sasa.py`), `lax.map` over
    frames and atom chunks — no per-atom host loop.  Neighbour
    candidates are capped at `max_neighbors` for the occlusion tensor,
    but the true relevant-neighbour count is checked and a
    ParallelError asks for a larger cap if it was ever exceeded — the
    result is exact for the point set by construction, never silently
    truncated.  Minimum-image PBC; triclinic boxes use the exact
    27-image minimum image (surpass — the reference is orthogonal-only,
    lib.rs:353-355).

    `radii` overrides the per-atom vdW radii ([K] nm); by default they
    come from the topology (run `guess_elements()` first — the same
    vdwradii.dat-derived table the reference's guessing uses,
    `config/elements.yaml`).

    Returns a dict: 'indices' [K], 'area' [F, K] (nm^2), 'total' [F].
    """
    from ..ops import sasa as sasa_ops

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)

    if radii is None:
        if not np.asarray(system.topology.has_vdw)[gsel].all():
            raise GroupError(
                f"group '{group}' has atoms without a vdW radius; run "
                "guess_elements() / guess_properties() or pass radii=",
                code="InvalidVdW")
        radii = np.asarray(system.topology.vdw, np.float32)[gsel]
    else:
        radii = np.asarray(radii, np.float32)
        if radii.shape != (gsel.shape[0],):
            raise GroupError(
                f"radii must have shape [{gsel.shape[0]}] to match group "
                f"'{group}'", code="InvalidVdW")

    areas, max_rel = sasa_ops.sasa_frames(
        pos, boxes, radii, probe=probe, n_points=n_points,
        max_neighbors=max_neighbors)
    max_rel = int(max_rel)
    if max_rel > min(int(max_neighbors), max(1, gsel.shape[0] - 1)):
        raise ParallelError(
            f"an atom had {max_rel} relevant neighbours but "
            f"max_neighbors={max_neighbors}; raise max_neighbors to keep "
            "the occlusion test exact")
    areas = np.asarray(areas)
    return {"indices": gsel, "area": areas,
            "total": areas.sum(axis=1)}

def polystat(system, trajectory, group: str, *, mass_weighted: bool = False,
             batch_size: int = 32):
    """Polymer chain statistics of a selection (surpass — the
    `gmx polystat` workload; absent from the reference).

    Chains are the molecules of `group` from the bond graph
    (`Topology.molecule_ids`, iterating.rs:399), atoms in topology
    order; single-atom molecules are ignored.  Chains are rebuilt whole
    on device by accumulating minimum-image consecutive-atom vectors
    (exact while every bonded step is shorter than half a box vector —
    the make_molecules_whole assumption, modifying.rs:338), so wrapped
    input is fine.  Everything evaluates in two fused device dispatches
    (per-frame stats + one `lax.map` over bond-correlation lags).

    Returns a dict:

    - 'ete2' [F]: chain-averaged squared end-to-end distance per frame
    - 'ete'  [F]: RMS end-to-end distance per frame (sqrt of 'ete2')
    - 'rg2'  [F]: chain-averaged squared radius of gyration per frame
      (mass-weighted when `mass_weighted=True` — gmx polystat's -mw;
      requires TPR masses)
    - 'bond_corr' [Kb]: <u_i . u_{i+k}> over frames/chains/positions
      (unit bond vectors; k = 0..Lmax-2)
    - 'persistence_length': -<l_b> / ln(C(1)) in nm (nan when C(1)
      is outside (0, 1), or within float32 rounding of 1)
    - 'mean_bond_length': trajectory mean bonded-step length (nm)
    - 'n_chains', 'chain_lengths' [M]: chain inventory
    """
    import jax
    import jax.numpy as jnp

    gsel, pos, boxes, _dt = _resident_group_pos(
        system, trajectory, group, batch_size)

    mol = system.topology.molecule_ids()[gsel]
    order = np.argsort(mol, kind="stable")
    uniq, starts = np.unique(mol[order], return_index=True)
    splits = np.split(order, starts[1:])
    chains = [c for c in splits if len(c) >= 2]
    if not chains:
        raise GroupError(
            f"group '{group}' contains no molecule with >= 2 atoms (does "
            "the topology carry bonds? read a TPR / PDB CONECT or run "
            "guess_bonds)", code="NoBonds")
    m = len(chains)
    lens = np.array([len(c) for c in chains], np.int64)
    lmax = int(lens.max())
    cols = np.zeros((m, lmax), np.int32)
    amask = np.zeros((m, lmax), bool)
    for i, c in enumerate(chains):
        cols[i, :len(c)] = c
        amask[i, :len(c)] = True

    if mass_weighted:
        topo = system.topology
        gmass = topo.mass[gsel]
        if not topo.has_mass[gsel].all():
            raise GroupError(
                f"group '{group}' has atoms without mass (mass-weighted "
                "polystat needs a TPR)", code="InvalidMass")
        w_np = np.where(amask, gmass[cols], 0.0).astype(np.float32)
    else:
        w_np = amask.astype(np.float32)

    _HI = jax.lax.Precision.HIGHEST
    cols_j = jnp.asarray(cols)
    w = jnp.asarray(w_np)                          # [M, L]
    bmask = jnp.asarray(amask[:, 1:])              # [M, L-1] valid bonds
    last = jnp.asarray(lens - 1)                   # [M]
    triclinic = boxes.ndim == 3

    def _minimg(d, boxes):
        f, mm, lb, _ = d.shape
        flat = d.reshape(f, mm * lb, 3)
        if triclinic:
            flat = pbc.min_image_triclinic_frames(flat, boxes)
        else:
            flat = pbc.min_image(flat, boxes[:, None, :])
        return flat.reshape(f, mm, lb, 3)

    @jax.jit
    def frame_stats(pos, boxes):
        g = pos[:, cols_j, :]                              # [F, M, L, 3]
        b = _minimg(g[:, :, 1:, :] - g[:, :, :-1, :], boxes)
        b = b * bmask[None, :, :, None]
        rel = jnp.concatenate(
            [jnp.zeros_like(g[:, :, :1, :]), jnp.cumsum(b, axis=2)], axis=2)
        ete_v = jnp.take_along_axis(
            rel, last[None, :, None, None].astype(jnp.int32)
            * jnp.ones((1, 1, 1, 3), jnp.int32), axis=2)[:, :, 0, :]
        ete2 = jnp.sum(ete_v * ete_v, axis=-1)             # [F, M]
        sw = jnp.sum(w, axis=1)                            # [M]
        # HIGHEST: a GPU's default f32 contraction is TF32 (PERF.md)
        com = jnp.einsum("fmla,ml->fma", rel, w,
                         precision=_HI) / sw[None, :, None]
        dev = (rel - com[:, :, None, :]) * w[None, :, :, None]
        rg2 = jnp.einsum("fmla,fmla->fm", dev, rel - com[:, :, None, :],
                         precision=_HI) / sw[None, :]
        blen = jnp.sqrt(jnp.sum(b * b, axis=-1))           # [F, M, L-1]
        nb = jnp.sum(bmask)
        return (jnp.mean(ete2, axis=1), jnp.mean(rg2, axis=1),
                jnp.sum(blen, axis=(1, 2)) / nb,
                b / jnp.where(blen == 0.0, 1.0, blen)[..., None])

    ete2_f, rg2_f, blen_f, u = frame_stats(pos, boxes)
    lb = lmax - 1

    @jax.jit
    def corr(u):
        def one(k):
            v = jnp.roll(u, -k, axis=2)
            pm = (bmask & jnp.roll(bmask, -k, axis=1)
                  & (jnp.arange(lb)[None, :] < lb - k))    # [M, L-1]
            dots = jnp.einsum("fmla,fmla->fml", u, v, precision=_HI)
            return (jnp.sum(dots * pm[None, :, :])
                    / (u.shape[0] * jnp.maximum(jnp.sum(pm), 1)))
        return jax.lax.map(one, jnp.arange(lb))

    bond_corr = np.asarray(corr(u), np.float64)
    mean_bl = float(np.asarray(blen_f, np.float64).mean())
    c1 = bond_corr[1] if lb > 1 else np.nan
    # the float32 correlation cannot tell C(1) from 1 within a few ulps
    # (a straight rod reads 1 - 1 ulp on a GPU): no measurable decay
    lp = (-mean_bl / np.log(c1)) if 0.0 < c1 < 1.0 - _C1_ULPS else float("nan")
    e2 = np.asarray(ete2_f, np.float64)
    return {"ete2": e2, "ete": np.sqrt(e2),
            "rg2": np.asarray(rg2_f, np.float64),
            "bond_corr": bond_corr, "persistence_length": float(lp),
            "mean_bond_length": mean_bl, "n_chains": m,
            "chain_lengths": lens}

def freevolume(system, trajectory, group: str = "all", *,
               probe: float = 0.0, n_samples: int = 8192, seed: int = 0,
               radii=None, points=None, batch_size: int = 32,
               chunk: int = 1024):
    """Free-volume fraction by Monte Carlo probe insertion (surpass —
    the `gmx freevolume` workload; absent from the reference).

    Per frame, `n_samples` uniform points are drawn in the box (seeded
    `jax.random`, deterministic; fractional coordinates mapped through
    the box matrix, so triclinic cells sample uniformly too); a point
    is FREE when its minimum-image distance (exact 27-image search for
    triclinic boxes) to every atom of `group` exceeds that atom's vdW
    radius + `probe` (nm).  The [points x atoms] occlusion test evaluates as
    dense device tiles (`chunk` points at a time under `lax.map`, all
    frames in one jitted dispatch).  Radii come from the topology
    (`guess_elements()`, the same vdwradii.dat-derived table the
    reference's guessing uses) or the `radii=` override; `points=`
    ([F, P, 3] in box units) replaces the random draw for exact
    oracle testing.

    Returns a dict: 'fraction' [F], 'free_volume' [F] (nm^3),
    'box_volume' [F] (nm^3), 'mean_fraction', 'stderr_fraction'
    (binomial MC error of the mean, NOT the frame-to-frame physical
    variance), 'n_samples'.
    """
    import jax
    import jax.numpy as jnp

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)

    if radii is None:
        if not np.asarray(system.topology.has_vdw)[gsel].all():
            raise GroupError(
                f"group '{group}' has atoms without a vdW radius; run "
                "guess_elements() / guess_properties() or pass radii=",
                code="InvalidVdW")
        radii = np.asarray(system.topology.vdw, np.float32)[gsel]
    else:
        radii = np.asarray(radii, np.float32)
        if radii.shape != (gsel.shape[0],):
            raise GroupError(
                f"radii must have shape [{gsel.shape[0]}] to match group "
                f"'{group}'", code="InvalidVdW")
    r2 = jnp.asarray((radii + np.float32(probe)) ** 2)

    f = int(pos.shape[0])
    if points is None:
        pts = jax.random.uniform(jax.random.PRNGKey(seed),
                                 (f, int(n_samples), 3), jnp.float32)
    else:
        pts = jnp.asarray(points, jnp.float32)
        if pts.shape[0] != f or pts.ndim != 3 or pts.shape[2] != 3:
            raise ParallelError(
                f"points must be [F={f}, P, 3], got {pts.shape}")
    p = int(pts.shape[1])
    n_chunks = -(-p // chunk)
    pad = n_chunks * chunk - p

    @jax.jit
    def _free(pos, boxes, pts):
        def one_frame(args):
            pf, box, u = args
            tri = box.ndim == 2
            # fractional draw -> cartesian (u @ H for triclinic cells)
            xyz = (jnp.matmul(u, box) if tri else u * box[None, :])  # [P,3]
            if pad:
                xyz = jnp.concatenate(
                    [xyz, jnp.zeros((pad, 3), xyz.dtype)])

            def rows(start):
                c = jax.lax.dynamic_slice_in_dim(xyz, start, chunk)
                d = c[:, None, :] - pf[None, :, :]
                d = (pbc.min_image_triclinic(d, box) if tri
                     else pbc.min_image(d, box))
                d2 = jnp.sum(d * d, axis=-1)          # [C, K]
                return jnp.all(d2 > r2[None, :], axis=1)

            free = jax.lax.map(rows, jnp.arange(n_chunks) * chunk)
            return jnp.sum(free.reshape(-1)[:p].astype(jnp.float32)) / p

        return jax.lax.map(one_frame, (pos, boxes, pts))

    frac = np.asarray(_free(pos, boxes, pts), np.float64)
    bx = np.asarray(boxes, np.float64)
    bvol = (np.abs(np.linalg.det(bx)) if bx.ndim == 3
            else np.prod(bx, axis=1))
    mean = float(frac.mean())
    stderr = float(np.sqrt(max(mean * (1.0 - mean), 0.0) / (f * p)))
    return {"fraction": frac, "free_volume": frac * bvol,
            "box_volume": bvol, "mean_fraction": mean,
            "stderr_fraction": stderr, "n_samples": p}

def sdf(system, trajectory, group: str, ref_group: str, *,
        side: float = 2.0, bins: int = 32, fit: bool = False,
        weights: str = "number", batch_size: int = 32):
    """3D spatial distribution function around a reference group
    (surpass — the `gmx spatial` workload; absent from the reference).

    Per frame the reference COM (refined Bai-Breen) recenters a cube of
    `side` nm and `bins`^3 voxels; `group` atoms scatter their weights
    ("number" or "mass") into it min-imaged.  `fit=True` additionally
    rotates each frame's offsets by the Kabsch fit of the reference
    group onto its frame-0 conformation (rotational SDF).  All frames
    in one jitted dispatch.

    Returns a dict: 'grid' [bins, bins, bins] time-averaged density
    (nm^-3, voxel-volume normalized), 'counts' raw weighted counts,
    'origin' [3] cube corner relative to the COM, 'voxel' (nm),
    'occupancy' fraction of group-atom-frames inside the cube.
    """
    import jax
    import jax.numpy as jnp

    gsel = _sel_indices(system, group)
    rsel = _sel_indices(system, ref_group)
    if gsel.size == 0 or rsel.size == 0:
        raise GroupError("sdf needs non-empty group and ref_group",
                         code="EmptyGroup")
    union = "__sdf_union"
    system.group_create_from_indices(union, np.union1d(gsel, rsel))
    try:
        usel, pos, boxes, _ = _resident_group_pos(
            system, trajectory, union, batch_size)
    finally:
        system.group_remove(union)
    lut = np.full(system.topology.n_atoms, -1, np.int64)
    lut[usel] = np.arange(usel.size)
    g_l = jnp.asarray(lut[gsel])
    r_l = jnp.asarray(lut[rsel])
    w_ref = jnp.asarray(np.asarray(system.topology.mass, np.float32)[rsel])

    if weights == "number":
        w = np.ones(gsel.size, np.float32)
    elif weights == "mass":
        w = np.asarray(system.topology.mass, np.float32)[gsel]
    else:
        raise ParallelError(
            f"weights must be 'number' or 'mass', got '{weights}'")

    nb = int(bins)
    vox = float(side) / nb
    f = int(pos.shape[0])

    @jax.jit
    def _grid(pos, boxes, w):
        # frame-0 reference conformation for the rotational fit
        p0 = pos[0][r_l]
        box0 = boxes[0]
        com0 = _ctr(p0, box0, w=w_ref)
        ref0 = _mi(p0 - com0[None, :], box0)              # [R, 3]

        def one_frame(args):
            pf, box = args
            com = _ctr(pf[r_l], box, w=w_ref)
            off = _mi(pf[g_l] - com[None, :], box)        # [K, 3]
            if fit:
                # both point sets are COM-centered (mass-weighted), so
                # the mass-weighted Kabsch centroids are zero; `cur @
                # rot` aligns the frame onto the frame-0 conformation
                cur = _mi(pf[r_l] - com[None, :], box)
                zero = jnp.zeros((1, 3), cur.dtype)
                rot, _, _ = rmsd_ops.kabsch(
                    cur[None], ref0[None], w_ref[None], zero, zero)
                off = off @ rot[0]
            ijk = jnp.floor((off + side / 2.0) / vox).astype(jnp.int32)
            inside = jnp.all((ijk >= 0) & (ijk < nb), axis=1)
            ijk = jnp.clip(ijk, 0, nb - 1)
            flat = (ijk[:, 0] * nb + ijk[:, 1]) * nb + ijk[:, 2]
            ww = w * inside.astype(jnp.float32)
            h = jnp.zeros((nb * nb * nb,), jnp.float32).at[flat].add(ww)
            return h, jnp.sum(inside.astype(jnp.float32))

        return jax.lax.map(one_frame, (pos, boxes))

    h, n_in = _grid(pos, boxes, jnp.asarray(w))
    counts = np.asarray(h, np.float64).sum(axis=0).reshape(nb, nb, nb)
    dens = counts / (f * vox ** 3)
    return {"grid": dens, "counts": counts,
            "origin": np.full(3, -side / 2.0), "voxel": vox,
            "occupancy": float(np.asarray(n_in, np.float64).sum())
            / (f * gsel.size)}

def write_cube(path, grid, origin, voxel, *, comment="groan_rs_tpu SDF"):
    """Write a 3D grid as a Gaussian cube file (the standard SDF
    visualization format; units converted nm -> Bohr).  One dummy atom
    marks the cube center."""
    bohr = 1.0 / 0.052917721092                      # nm -> Bohr
    nx, ny, nz = grid.shape
    with open(path, "w") as fh:
        fh.write(f"{comment}\n")
        fh.write("time-averaged density (nm^-3)\n")
        ox, oy, oz = (o * bohr for o in origin)
        fh.write(f"{1:5d}{ox:12.6f}{oy:12.6f}{oz:12.6f}\n")
        v = voxel * bohr
        fh.write(f"{nx:5d}{v:12.6f}{0.0:12.6f}{0.0:12.6f}\n")
        fh.write(f"{ny:5d}{0.0:12.6f}{v:12.6f}{0.0:12.6f}\n")
        fh.write(f"{nz:5d}{0.0:12.6f}{0.0:12.6f}{v:12.6f}\n")
        fh.write(f"{1:5d}{0.0:12.6f}{0.0:12.6f}{0.0:12.6f}{0.0:12.6f}\n")
        flat = np.asarray(grid, np.float64).reshape(nx * ny, nz)
        for row in flat:
            for i in range(0, nz, 6):
                fh.write("".join(f"{x:13.5e}" for x in row[i:i + 6]))
                fh.write("\n")

def helixorient(system, trajectory, group: str, *, axis: str = "z",
                batch_size: int = 32):
    """Local helix geometry from CA positions (surpass — the
    `gmx helixorient` / `gmx helix` workload; absent from the
    reference).

    The group's CA atoms (residue order) are rebuilt whole on device by
    min-image accumulation, then the Sugeta-Miyazawa construction
    gives, per residue window: the radial bisector b_i =
    unit(u_{i-1} - u_i) (u = consecutive CA bonds; for an ideal helix
    b points at the axis), the local axis a_i = unit(b_i x b_{i+1})
    (sign along the chain), local rise = u_i . a_i, local twist =
    angle(b_i, b_{i+1}), and local radius = |u_i|^2-ish from the exact
    circle relation r = rise-free chord / (2 sin(twist/2)) using the
    axis-perpendicular chord component.  All frames in one jitted
    dispatch.

    Returns a dict: 'axis_vec' [F, 3] (mean local axis, unit),
    'tilt' [F] (deg vs +`axis`), 'rise' [F] / 'twist' [F] /
    'radius' [F] (per-frame means; nm, deg, nm),
    'rise_per_residue' [F, W], 'twist_per_residue' [F, W],
    'local_axes' [F, W, 3] (W = R - 3 windows), 'resids' [R].
    """
    import jax
    import jax.numpy as jnp

    if axis not in _AXIS:
        raise ParallelError(f"axis must be one of xyz, got '{axis}'")
    ax_ref = np.zeros(3, np.float32)
    ax_ref[_AXIS[axis]] = 1.0

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)
    # CA atoms in residue order
    names = system.topology.atomname
    ca_cols = [i for i in range(len(gsel))
               if names.get(int(gsel[i])) == "CA"]
    if len(ca_cols) < 5:
        raise GroupError(
            f"group '{group}' has {len(ca_cols)} CA atoms; helixorient "
            "needs at least 5", code="InvalidSelection")
    resids = np.asarray(system.topology.resnum)[gsel[ca_cols]]
    order = np.argsort(resids, kind="stable")
    ca_cols = np.asarray(ca_cols)[order]
    resids = resids[order]

    cac = jnp.asarray(ca_cols)

    @jax.jit
    def _geom(pos, boxes):
        def one_frame(args):
            pf, box = args
            ca = pf[cac]                                  # [R, 3]
            d = _mi(ca[1:] - ca[:-1], box)      # [R-1, 3] bonds
            whole = jnp.concatenate(
                [ca[:1], ca[:1] + jnp.cumsum(d, axis=0)])
            u = whole[1:] - whole[:-1]                    # [R-1, 3]
            b = u[:-1] - u[1:]                            # [R-2, 3]
            b = b / jnp.maximum(
                jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
            a = jnp.cross(b[:-1], b[1:])                  # [R-3, 3]
            a = a / jnp.maximum(
                jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
            # sign: along the chain (positive projection on the chord)
            chord = u[1:-1]
            sgn = jnp.sign(jnp.sum(a * chord, axis=-1))
            a = a * jnp.where(sgn == 0, 1.0, sgn)[:, None]
            rise = jnp.sum(u[1:-1] * a, axis=-1)          # [R-3]
            cosw = jnp.clip(jnp.sum(b[:-1] * b[1:], axis=-1), -1.0, 1.0)
            twist = jnp.arccos(cosw)                      # [R-3] rad
            # circle radius from the axis-perpendicular chord
            perp = u[1:-1] - rise[:, None] * a
            radius = jnp.linalg.norm(perp, axis=-1) / jnp.maximum(
                2.0 * jnp.sin(twist / 2.0), 1e-12)
            mean_axis = jnp.mean(a, axis=0)
            mean_axis = mean_axis / jnp.maximum(
                jnp.linalg.norm(mean_axis), 1e-12)
            tilt = jnp.degrees(jnp.arccos(jnp.clip(
                jnp.dot(mean_axis, jnp.asarray(ax_ref)), -1.0, 1.0)))
            return (mean_axis, tilt, jnp.mean(rise),
                    jnp.degrees(jnp.mean(twist)),
                    jnp.mean(radius), rise,
                    jnp.degrees(twist), a)

        return jax.lax.map(one_frame, (pos, boxes))

    (axv, tilt, rise, twist, radius, rise_pr, twist_pr, axes) = (
        np.asarray(x, np.float64) for x in _geom(pos, boxes))
    return {"axis_vec": axv, "tilt": tilt, "rise": rise, "twist": twist,
            "radius": radius, "rise_per_residue": rise_pr,
            "twist_per_residue": twist_pr, "local_axes": axes,
            "resids": resids}

def _part_tables(system, specs, n_axes, kind):
    """Split `specs` (one group name/query, split into `n_axes` equal
    consecutive parts, or an explicit list of one name/query per axis)
    into per-axis global index arrays."""
    if isinstance(specs, str):
        idx = _transient_indices(system, specs)
        if n_axes is None:
            raise ParallelError("bundle needs n_axes when "
                                f"{kind} is a single group")
        if idx.size % n_axes:
            raise GroupError(
                f"{kind} group has {idx.size} atoms, not divisible into "
                f"{n_axes} axes", code="InvalidSelection")
        return np.split(idx, n_axes)
    parts = [_transient_indices(system, s) for s in specs]
    if n_axes is not None and len(parts) != n_axes:
        raise ParallelError(
            f"{kind} lists {len(parts)} groups but n_axes={n_axes}")
    return parts

def bundle(system, trajectory, tops, bottoms, *, n_axes: int | None = None,
           axis: str = "z", mass_weighted: bool = True,
           batch_size: int = 32):
    """Helix-bundle axis geometry (surpass — the `gmx bundle` workload;
    absent from the reference).

    Each bundle axis runs from the center of a "bottom" part to the
    center of a "top" part.  `tops` / `bottoms` are either ONE group
    name/GSL query split into `n_axes` equal consecutive parts (index
    order — gmx's -na split) or explicit per-axis lists of names/queries.
    Centers are mass-weighted by default (`mass_weighted=False` uses
    geometric centers) and PBC-robust: each part is rebuilt whole by
    minimum image around its first atom, and the top anchor is
    min-imaged to the bottom anchor — exact whenever each helix fits in
    half the box.

    Per frame and axis (e = unit vector of `axis`, default z; v = unit
    axis vector; m = axis midpoint; c = bundle center = mean of
    midpoints, min-imaged to the first axis):

    - 'length'  [F, A]: |top − bottom| (nm)
    - 'distance' [F, A]: |(m − c) ⊥ e| — midpoint offset from the
      bundle center in the plane perpendicular to e (gmx -od)
    - 'zshift'  [F, A]: (m − c) · e (gmx -oz)
    - 'tilt'    [F, A]: angle(v, e), degrees (gmx -ot)
    - 'tiltr'   [F, A]: degrees(asin(v · r̂)) — tilt component in the
      radial direction r̂ = unit((m − c) ⊥ e) (gmx -otr)
    - 'tiltl'   [F, A]: degrees(asin(v · l̂)), l̂ = e × r̂ (gmx -otl)
    - 'axes'    [F, A, 3]: unit axis vectors; 'center' [F, 3]

    All frames evaluate in one jitted `lax.map` over the device-resident
    trajectory.
    """
    import jax
    import jax.numpy as jnp

    if axis not in _AXIS:
        raise ParallelError(f"axis must be one of xyz, got '{axis}'")
    e = np.zeros(3, np.float32)
    e[_AXIS[axis]] = 1.0

    top_parts = _part_tables(system, tops, n_axes, "tops")
    bot_parts = _part_tables(system, bottoms, n_axes, "bottoms")
    if len(top_parts) != len(bot_parts):
        raise ParallelError(
            f"{len(top_parts)} top parts vs {len(bot_parts)} bottom parts")
    n_ax = len(top_parts)
    if n_ax < 1:
        raise ParallelError("bundle needs at least one axis")
    for p in (*top_parts, *bot_parts):
        if p.size == 0:
            raise GroupError("empty bundle part", code="EmptyGroup")

    union = np.unique(np.concatenate(top_parts + bot_parts))
    name = "__bundle_union"
    system.group_create_from_indices(name, union)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(
            system, trajectory, name, batch_size)
    finally:
        system.group_remove(name)

    def _padded(parts):
        width = max(p.size for p in parts)
        cols = np.zeros((n_ax, width), np.int64)
        w = np.zeros((n_ax, width), np.float32)
        for i, p in enumerate(parts):
            cols[i, :p.size] = np.searchsorted(gsel, p)
            if mass_weighted:
                from ..system.rmsd import _masses

                w[i, :p.size] = _masses(system, "bundle part", p)
            else:
                w[i, :p.size] = 1.0
            w[i] /= w[i].sum()
        return jnp.asarray(cols), jnp.asarray(w)

    tcols, tw = _padded(top_parts)
    bcols, bw = _padded(bot_parts)
    ej = jnp.asarray(e)

    @jax.jit
    def _geom(pos, boxes):
        def one_frame(args):
            pf, box = args

            def part_com(cols, w):
                x = pf[cols]                             # [A, P, 3]
                x0 = x[:, :1]
                rel = _mi(x - x0, box)
                return x0[:, 0] + jnp.sum(w[..., None] * rel, axis=1)

            bcom = part_com(bcols, bw)                   # [A, 3]
            t0 = pf[tcols][:, 0]
            b0 = pf[bcols][:, 0]
            # top part re-anchored into the bottom anchor's image
            tx = pf[tcols]
            trel = _mi(tx - tx[:, :1], box)
            t0b = b0 + _mi(t0 - b0, box)
            tcom = t0b + jnp.sum(tw[..., None] * trel, axis=1)

            vec = tcom - bcom                            # [A, 3]
            length = jnp.linalg.norm(vec, axis=-1)
            v = vec / jnp.maximum(length[:, None], 1e-12)
            mid = bcom + 0.5 * vec
            dmid = _mi(mid - mid[:1], box)
            center = mid[0] + jnp.mean(dmid, axis=0)
            off = _mi(mid - center, box)       # [A, 3]
            zshift = off @ ej
            perp = off - zshift[:, None] * ej
            dist = jnp.linalg.norm(perp, axis=-1)
            r_hat = perp / jnp.maximum(dist[:, None], 1e-12)
            l_hat = jnp.cross(ej, r_hat)
            tilt = jnp.degrees(jnp.arccos(jnp.clip(v @ ej, -1.0, 1.0)))
            safe = (dist > 1e-9)[:, None]
            tiltr = jnp.degrees(jnp.arcsin(jnp.clip(
                jnp.sum(v * jnp.where(safe, r_hat, 0.0), axis=-1),
                -1.0, 1.0)))
            tiltl = jnp.degrees(jnp.arcsin(jnp.clip(
                jnp.sum(v * jnp.where(safe, l_hat, 0.0), axis=-1),
                -1.0, 1.0)))
            return length, dist, zshift, tilt, tiltr, tiltl, v, center

        return jax.lax.map(one_frame, (pos, boxes))

    (length, dist, zshift, tilt, tiltr, tiltl, axes_v, centers) = (
        np.asarray(x, np.float64) for x in _geom(pos, boxes))
    return {"length": length, "distance": dist, "zshift": zshift,
            "tilt": tilt, "tiltr": tiltr, "tiltl": tiltl,
            "axes": axes_v, "center": centers}

def dyecoupl(system, trajectory, donor, acceptor, *, r0: float | None = None,
             batch_size: int = 32):
    """FRET dye-pair coupling (surpass — the `gmx dyecoupl` workload;
    absent from the reference).

    `donor` and `acceptor` each name a group/GSL query with EXACTLY two
    atoms — the endpoints of the dye's transition-dipole vector.  Per
    frame, with u_D/u_A the unit dipole vectors and r̂ the unit vector
    between the dipole midpoints (all minimum-image):

    - 'r'      [F]: donor-acceptor midpoint distance R (nm)
    - 'kappa2' [F]: κ² = (u_D·u_A − 3 (u_D·r̂)(u_A·r̂))²
    - 'efficiency' [F] (when `r0` is given): the κ²-corrected Förster
      efficiency E = 1 / (1 + (2/(3κ²)) (R/R0)⁶), where `r0` is the
      isotropic (κ² = 2/3) Förster radius in nm.

    One jitted dispatch over the device-resident trajectory.
    """
    import jax
    import jax.numpy as jnp

    d_idx = _transient_indices(system, donor)
    a_idx = _transient_indices(system, acceptor)
    for nm, ix in (("donor", d_idx), ("acceptor", a_idx)):
        if ix.size != 2:
            raise GroupError(
                f"{nm} must select exactly 2 atoms (dipole endpoints), "
                f"got {ix.size}", code="InvalidSelection")

    union = np.unique(np.concatenate([d_idx, a_idx]))
    name = "__dye_union"
    system.group_create_from_indices(name, union)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(
            system, trajectory, name, batch_size)
    finally:
        system.group_remove(name)
    dc = jnp.asarray(np.searchsorted(gsel, d_idx))
    ac = jnp.asarray(np.searchsorted(gsel, a_idx))

    @jax.jit
    def _coupl(pos, boxes):
        def one_frame(args):
            pf, box = args
            dvec = _mi(pf[dc[1]] - pf[dc[0]], box)
            avec = _mi(pf[ac[1]] - pf[ac[0]], box)
            dmid = pf[dc[0]] + 0.5 * dvec
            amid = pf[ac[0]] + 0.5 * avec
            rvec = _mi(amid - dmid, box)
            r = jnp.linalg.norm(rvec)
            ud = dvec / jnp.maximum(jnp.linalg.norm(dvec), 1e-12)
            ua = avec / jnp.maximum(jnp.linalg.norm(avec), 1e-12)
            ur = rvec / jnp.maximum(r, 1e-12)
            kappa = ud @ ua - 3.0 * (ud @ ur) * (ua @ ur)
            return r, kappa * kappa

        return jax.lax.map(one_frame, (pos, boxes))

    r, k2 = (np.asarray(x, np.float64) for x in _coupl(pos, boxes))
    out = {"r": r, "kappa2": k2}
    if r0 is not None:
        if r0 <= 0:
            raise ParallelError(f"r0 must be positive, got {r0}")
        with np.errstate(divide="ignore"):
            out["efficiency"] = 1.0 / (
                1.0 + (2.0 / (3.0 * k2)) * (r / float(r0)) ** 6)
    return out

def gangle(system, trajectory, group1, *, g1: str = "vector",
           g2: str = "z", group2=None, batch_size: int = 32):
    """Angles between selection-defined vectors/planes and a reference
    (surpass — the `gmx gangle` workload; absent from the reference).

    `group1` (name or GSL query) supplies sites in index order: with
    `g1="vector"` consecutive atom PAIRS define vectors (atom0 → atom1,
    minimum image); with `g1="plane"` consecutive TRIPLES define planes
    whose normals are used.  The reference `g2` is one of:

    - "x" / "y" / "z": a fixed box axis
    - "t0": each site's own orientation in the FIRST frame
    - "vector" / "plane": sites from `group2`, paired 1:1 with the
      `group1` sites (or one single site broadcast to all)

    Returns a dict: 'angles' [F, K] (degrees, 0-180), 'mean' [F]
    (per-frame mean over sites).  All frames evaluate in one jitted
    `lax.map` over the device-resident trajectory.
    """
    import jax
    import jax.numpy as jnp

    if g1 not in _G1_SITE_WIDTH:
        raise ParallelError(f"g1 must be 'vector' or 'plane', got '{g1}'")
    fixed_axis = g2 in _AXIS
    if not fixed_axis and g2 not in ("t0", "vector", "plane"):
        raise ParallelError(
            f"g2 must be x/y/z/t0/vector/plane, got '{g2}'")
    if g2 in ("vector", "plane") and group2 is None:
        raise ParallelError(f"g2='{g2}' needs group2")

    idx1 = _transient_indices(system, group1)
    w1 = _G1_SITE_WIDTH[g1]
    if idx1.size == 0 or idx1.size % w1:
        raise GroupError(
            f"group1 has {idx1.size} atoms, not a multiple of {w1} "
            f"({g1} sites)", code="InvalidSelection")
    k = idx1.size // w1

    idx2 = np.empty(0, np.int64)
    w2 = 0
    if g2 in ("vector", "plane"):
        w2 = _G1_SITE_WIDTH[g2]
        idx2 = _transient_indices(system, group2)
        if idx2.size == 0 or idx2.size % w2:
            raise GroupError(
                f"group2 has {idx2.size} atoms, not a multiple of {w2}",
                code="InvalidSelection")
        k2 = idx2.size // w2
        if k2 not in (1, k):
            raise ParallelError(
                f"group2 defines {k2} sites; need 1 or {k}")

    union = np.unique(np.concatenate([idx1, idx2]))
    name = "__gangle_union"
    system.group_create_from_indices(name, union)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(
            system, trajectory, name, batch_size)
    finally:
        system.group_remove(name)

    s1 = jnp.asarray(np.searchsorted(gsel, idx1).reshape(k, w1))
    s2 = None
    if w2:
        k2 = idx2.size // w2
        cols2 = np.searchsorted(gsel, idx2).reshape(k2, w2)
        if k2 == 1:
            cols2 = np.repeat(cols2, k, axis=0)
        s2 = jnp.asarray(cols2)

    def site_dirs(pf, box, cols, width):
        a = pf[cols[:, 0]]
        d1 = _mi(pf[cols[:, 1]] - a, box)
        if width == 2:
            v = d1
        else:
            d2 = _mi(pf[cols[:, 2]] - a, box)
            v = jnp.cross(d1, d2)
        return v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)

    if fixed_axis:
        ref_const = np.zeros(3, np.float32)
        ref_const[_AXIS[g2]] = 1.0
        ref_const = jnp.asarray(np.repeat(ref_const[None], k, axis=0))
    elif g2 == "t0":
        import jax as _jax

        first = _jax.jit(
            lambda p, b: site_dirs(p, b, s1, w1))(pos[0], boxes[0])
        ref_const = first
    else:
        ref_const = None

    @jax.jit
    def _angles(pos, boxes):
        def one_frame(args):
            pf, box = args
            v1 = site_dirs(pf, box, s1, w1)
            ref = (site_dirs(pf, box, s2, w2) if ref_const is None
                   else ref_const)
            cosang = jnp.clip(jnp.sum(v1 * ref, axis=-1), -1.0, 1.0)
            return jnp.degrees(jnp.arccos(cosang))

        return jax.lax.map(one_frame, (pos, boxes))

    ang = np.asarray(_angles(pos, boxes), np.float64)
    return {"angles": ang, "mean": ang.mean(axis=1)}

def pairdist(system, trajectory, group1, group2, *, split: str = "res",
             mode: str = "min", batch_size: int = 32, chunk: int = 16):
    """Per-frame distance matrices between two selections' units
    (surpass — the `gmx pairdist` workload; the reference has only
    whole-group atom matrices, analysis.rs:401).

    Each selection resolves to units per `split`: "res" = (chain,
    resnum) blocks in order of appearance, "atom" = one unit per atom,
    "group" = the whole selection as one unit.  `mode="min"` gives the
    smallest minimum-image atom-atom distance between the units
    (`ops.distances.residue_min_matrix` tiles); `mode="com"` the
    minimum-image distance between mass-weighted unit centers (each
    unit rebuilt whole around its first atom, like `bundle`).

    Returns a dict: 'dist' [F, K1, K2] nm, plus per-side 'resids1/2'
    and 'resnames1/2' (for split="res").
    """
    import jax
    import jax.numpy as jnp

    if split not in ("res", "atom", "group"):
        raise ParallelError(f"split must be res/atom/group, got '{split}'")
    if mode not in ("min", "com"):
        raise ParallelError(f"mode must be min/com, got '{mode}'")

    idx1 = _transient_indices(system, group1)
    idx2 = _transient_indices(system, group2)
    for nm, ix in (("group1", idx1), ("group2", idx2)):
        if ix.size == 0:
            raise GroupError(f"{nm} is empty", code="EmptyGroup")

    union = np.unique(np.concatenate([idx1, idx2]))
    name = "__pairdist_union"
    system.group_create_from_indices(name, union)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(
            system, trajectory, name, batch_size)
    finally:
        system.group_remove(name)

    out = {}

    def units(idx, tag):
        cols = np.searchsorted(gsel, idx)
        if split == "res":
            resids, resnames, blocks = _residue_blocks(system, idx)
            out[f"resids{tag}"] = resids
            out[f"resnames{tag}"] = resnames
            return [[int(cols[j]) for j in b] for b in blocks]
        if split == "atom":
            return [[int(c)] for c in cols]
        return [[int(c) for c in cols]]

    u1 = units(idx1, 1)
    u2 = units(idx2, 2)
    k1, k2 = len(u1), len(u2)

    if mode == "min":
        blocks = u1 + u2
        p = max(len(b) for b in blocks)
        block_idx = np.zeros((k1 + k2, p), np.int32)
        block_mask = np.zeros((k1 + k2, p), bool)
        for i, b in enumerate(blocks):
            block_idx[i, : len(b)] = b
            block_mask[i, : len(b)] = True
        m = np.asarray(distance_ops.residue_min_matrix(
            pos, boxes, block_idx, block_mask, chunk=chunk))
        out["dist"] = m[:, :k1, k1:]
        return out

    from ..system.rmsd import _masses

    def com_table(ulist, idx):
        p = max(len(b) for b in ulist)
        cols = np.zeros((len(ulist), p), np.int64)
        w = np.zeros((len(ulist), p), np.float32)
        gmass = _masses(system, "pairdist unit", idx)
        local = {int(c): float(mq)
                 for c, mq in zip(np.searchsorted(gsel, idx), gmass)}
        for i, b in enumerate(ulist):
            cols[i, : len(b)] = b
            w[i, : len(b)] = [local[j] for j in b]
            w[i] /= w[i].sum()
        return jnp.asarray(cols), jnp.asarray(w)

    c1, w1 = com_table(u1, idx1)
    c2, w2 = com_table(u2, idx2)

    @jax.jit
    def _dist(pos, boxes):
        def one_frame(args):
            pf, box = args

            def coms(cols, w):
                x = pf[cols]
                rel = _mi(x - x[:, :1], box)
                return x[:, 0] + jnp.sum(w[..., None] * rel, axis=1)

            a = coms(c1, w1)
            b = coms(c2, w2)
            d = _mi(a[:, None, :] - b[None, :, :], box)
            return jnp.linalg.norm(d, axis=-1)

        return jax.lax.map(one_frame, (pos, boxes))

    out["dist"] = np.asarray(_dist(pos, boxes), np.float64)
    return out

def select_dynamic(system, trajectory, group, *, within: float | None = None,
                   of: str | None = None, shape=None,
                   whole_res: bool = False, batch_size: int = 32,
                   chunk: int = 8192):
    """Per-frame dynamic selection (surpass — the `gmx select` workload;
    the reference re-evaluates geometry filters host-side per frame,
    system/iterating.rs `filter_geometry`).

    Evaluates, for every frame, which atoms of `group` satisfy a
    geometric criterion — the batched form of gmx's dynamic selections:

    - ``within=r, of=ref``: minimum-image distance to ANY atom of the
      `ref` selection is `< r` (gmx ``... and within r of ...``); the
      [F, K] min-distance table is computed as dense device tiles
      (candidates chunked by `chunk` to bound the [K, M] frame tile).
    - ``shape=Shape``: inside a `core.shapes` Sphere / Rectangular /
      Cylinder, with exactly `Shape.inside`'s PBC semantics
      (`ops.geometry.inside_shape`).
    - ``whole_res=True``: membership extends to every group atom of any
      touched (chain, resnum) unit (gmx ``same residue as ...``).

    `group` / `of` accept group names or GSL queries.  Returns a dict:

    - 'indices' [K]: global atom indices of the candidate group
    - 'masks' [F, K] bool: per-frame membership
    - 'sizes' [F]: atoms selected per frame (gmx select -os)
    - 'occupancy' [K]: fraction of frames each atom is selected
      (gmx select -ofpdb occupancy column)
    """
    import jax
    import jax.numpy as jnp

    if (within is None) == (shape is None):
        raise ParallelError(
            "select_dynamic needs exactly one criterion: within=r, of=ref "
            "OR shape=Shape")
    if within is not None and of is None:
        raise ParallelError("within=r needs of=<reference selection>")

    idx = _transient_indices(system, group)
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")

    if within is not None:
        ref_idx = _transient_indices(system, of)
        if ref_idx.size == 0:
            raise GroupError(f"reference '{of}' is empty", code="EmptyGroup")
        union = np.unique(np.concatenate([idx, ref_idx]))
        name = "__select_union"
        system.group_create_from_indices(name, union)
        try:
            gsel, pos, boxes, _ = _resident_group_pos(
                system, trajectory, name, batch_size)
        finally:
            system.group_remove(name)
        cand_cols = np.searchsorted(gsel, idx)
        ref_cols = jnp.asarray(np.searchsorted(gsel, ref_idx))

        @jax.jit
        def _mask(pc, pr, boxes):
            def one_frame(args):
                c, r, box = args
                d = _mi(c[:, None, :] - r[None, :, :], box)
                return jnp.min(jnp.sum(d * d, axis=-1), axis=1) \
                    < jnp.float32(within) ** 2

            return jax.lax.map(one_frame, (pc, pr, boxes))

        # host-side candidate chunking bounds the [chunk, M] frame tile
        # (a single static-shape kernel per chunk width)
        ref_pos = pos[:, ref_cols, :]
        parts = []
        for c0 in range(0, len(cand_cols), chunk):
            cols = jnp.asarray(cand_cols[c0:c0 + chunk])
            parts.append(np.asarray(_mask(pos[:, cols, :], ref_pos, boxes)))
        masks = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=1)
    else:
        name = "__select_grp"
        system.group_create_from_indices(name, idx)
        try:
            gsel, pos, boxes, _ = _resident_group_pos(
                system, trajectory, name, batch_size)
        finally:
            system.group_remove(name)
        cols = jnp.asarray(np.searchsorted(gsel, idx))
        # raise on unsupported shapes before the trace
        geometry.inside_shape(shape, np.zeros((1, 1, 3), np.float32),
                              np.ones((1, 3), np.float32))

        @jax.jit
        def _mask(pos, boxes):
            return geometry.inside_shape(shape, pos[:, cols, :], boxes)

        masks = np.asarray(_mask(pos, boxes))

    if whole_res:
        masks = np.array(masks)        # np.asarray(jax out) is read-only
        _, _, blocks = _residue_blocks(system, idx)
        for b in blocks:
            b = np.asarray(b)
            hit = masks[:, b].any(axis=1)
            masks[:, b] = hit[:, None]

    return {
        "indices": idx,
        "masks": masks,
        "sizes": masks.sum(axis=1).astype(np.int64),
        "occupancy": masks.mean(axis=0).astype(np.float64),
    }

def saltbr(system, trajectory, group: str = "all", *,
           min_charge: float = 0.5, trunc: float | None = None,
           batch_size: int = 32):
    """Salt-bridge distance series (surpass — the `gmx saltbr` workload;
    absent from the reference, whose distance API stops at whole-group
    matrices, analysis.rs:401).

    Charged units are the residues of `group` whose net topology charge
    satisfies |q| >= `min_charge` (0.5 by default so force-field charge
    rounding on neutral residues never spawns units).  Every charged
    pair's minimum-image mass-weighted COM distance is evaluated per
    frame on device (the shared `pairdist` COM tiles); pairs are
    classified by charge signs and, like gmx's `-t`, `trunc` keeps only
    pairs whose minimum over the pass is below it.

    Returns a dict: 'dist' [F, P] nm, 'pairs' [P, 2] unit indices,
    'kinds' [P] in {'++', '--', '+-'}, 'labels' [P] "RESNAME-RESID",
    'charges' [R], 'resids' [R], 'resnames' [R].
    """
    idx = _transient_indices(system, group)
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    topo = system.topology
    if not topo.has_charge[idx].all():
        raise GroupError(f"group '{group}' has atoms without charge",
                         code="InvalidCharge")

    resids, resnames, blocks = _residue_blocks(system, idx)
    q_all = np.asarray(topo.charge, np.float64)
    q_res = np.asarray([q_all[idx[b]].sum() for b in blocks])
    keep = np.flatnonzero(np.abs(q_res) >= float(min_charge))
    if keep.size < 2:
        raise GroupError(
            f"need at least 2 residues with |net charge| >= {min_charge}, "
            f"found {keep.size}", code="EmptyGroup")

    charged = np.concatenate([idx[blocks[u]] for u in keep])
    name = "__saltbr_units"
    system.group_create_from_indices(name, np.sort(charged))
    try:
        pd = pairdist(system, trajectory, name, name, split="res",
                      mode="com", batch_size=batch_size)
    finally:
        system.group_remove(name)

    dist = pd["dist"]                                  # [F, R, R]
    r = keep.size
    iu, ju = np.triu_indices(r, k=1)
    series = dist[:, iu, ju]                           # [F, P]
    if trunc is not None:
        sel = series.min(axis=0) < float(trunc)
        iu, ju, series = iu[sel], ju[sel], series[:, sel]

    q = q_res[keep]
    sign = np.sign(q)
    kinds = np.where(sign[iu] * sign[ju] < 0, "+-",
                     np.where(sign[iu] > 0, "++", "--"))
    labels = np.asarray([f"{resnames[u]}-{resids[u]}" for u in keep],
                        object)
    return {
        "dist": series,
        "pairs": np.stack([iu, ju], axis=1),
        "kinds": kinds,
        "labels": labels,
        "charges": q,
        "resids": resids[keep],
        "resnames": resnames[keep],
    }

def trjorder(system, trajectory, ref_group: str, solvent: str, *,
             mode: str = "atom", da: int = 0, shell: float | None = None,
             output: str | None = None, outfmt: str | None = None,
             out_group: str = "all", batch_size: int = 32,
             chunk: int = 512):
    """Order solvent molecules by distance to a reference group
    (surpass — the `gmx trjorder` workload; absent from the reference).

    Solvent molecules are the residues of `solvent`.  Per frame, each
    molecule's distance to the CLOSEST `ref_group` atom is evaluated on
    device (min-image): from its `da`-th atom (`mode="atom"`, gmx -da),
    from its closest own atom (`mode="min"`), or from its mass-weighted
    COM rebuilt whole (`mode="com"`, gmx -da 0 semantics with masses).
    `shell` also counts molecules within that radius per frame
    (gmx -nshell).  With `output`, a second host pass writes the
    trajectory with solvent coordinates permuted into sorted order
    (closest molecule first — gmx trjorder's reordered output),
    restricted to `out_group`.

    Returns a dict: 'dist' [F, M] nm, 'order' [F, M] molecule
    permutation (stable argsort), 'nshell' [F] (when `shell`),
    'molecules' [M] first-atom global indices.
    """
    import jax
    import jax.numpy as jnp

    if mode not in ("atom", "min", "com"):
        raise ParallelError(f"mode must be atom/min/com, got '{mode}'")

    ridx = _transient_indices(system, ref_group)
    sidx = _transient_indices(system, solvent)
    for nm, ix in (("ref_group", ridx), ("solvent", sidx)):
        if ix.size == 0:
            raise GroupError(f"{nm} is empty", code="EmptyGroup")

    union = np.unique(np.concatenate([ridx, sidx]))
    name = "__trjorder_union"
    system.group_create_from_indices(name, union)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(
            system, trajectory, name, batch_size)
    finally:
        system.group_remove(name)

    _, _, blocks = _residue_blocks(system, sidx)
    loc = np.searchsorted(gsel, sidx)
    if mode == "atom":
        for b in blocks:
            if da >= len(b):
                raise GroupError(
                    f"da={da} out of range for a {len(b)}-atom molecule",
                    code="InvalidSelection")
        sites = [[b[da]] for b in blocks]
    else:
        sites = blocks
    cols, w, _, _ = _unit_tables(system, sidx, sites, loc)
    mask = np.zeros(cols.shape, bool)
    for i, b in enumerate(sites):
        mask[i, : len(b)] = True
    m_units = len(blocks)
    n_chunks = -(-m_units // chunk)
    pad = n_chunks * chunk - m_units
    cols_p = np.concatenate([cols, np.zeros((pad, cols.shape[1]),
                                            cols.dtype)]) if pad else cols
    mask_p = np.concatenate([mask, np.zeros((pad, mask.shape[1]),
                                            bool)]) if pad else mask
    w_p = np.concatenate([w, np.ones((pad, w.shape[1]), w.dtype)
                          / w.shape[1]]) if pad else w
    cols_j, mask_j, w_j = (jnp.asarray(cols_p), jnp.asarray(mask_p),
                           jnp.asarray(w_p))
    ref_l = jnp.asarray(np.searchsorted(gsel, ridx))
    starts = jnp.arange(n_chunks) * chunk
    big = jnp.float32(1e30)

    @jax.jit
    def _dist(pos, boxes):
        def one_frame(args):
            pf, box = args
            pr = pf[ref_l]                              # [R, 3]

            def block(c0):
                c = jax.lax.dynamic_slice_in_dim(cols_j, c0, chunk)
                mk = jax.lax.dynamic_slice_in_dim(mask_j, c0, chunk)
                x = pf[c]                               # [C, P, 3]
                if mode == "com":
                    wt = jax.lax.dynamic_slice_in_dim(w_j, c0, chunk)
                    rel = _mi(x - x[:, :1], box)
                    x = (x[:, 0] + jnp.sum(wt[..., None] * rel,
                                           axis=1))[:, None, :]
                    mk = mk[:, :1]
                d = _mi(
                    x[:, :, None, :] - pr[None, None, :, :], box)
                d2 = jnp.sum(d * d, axis=-1)            # [C, P, R]
                d2 = jnp.where(mk[..., None], d2, big)
                return jnp.min(d2, axis=(1, 2))         # [C]

            return jax.lax.map(block, starts).reshape(-1)[:m_units]

        return jax.lax.map(one_frame, (pos, boxes))

    d = np.sqrt(np.asarray(_dist(pos, boxes), np.float64))
    order = np.argsort(d, axis=1, kind="stable")
    out = {
        "dist": d,
        "order": order,
        "molecules": np.asarray([int(sidx[b[0]]) for b in blocks]),
    }
    if shell is not None:
        out["nshell"] = (d < float(shell)).sum(axis=1).astype(np.int64)

    if output is not None:
        if not isinstance(trajectory, (str, os.PathLike, list)):
            raise ParallelError(
                "trjorder output writing needs the trajectory path(s), "
                "not a DeviceTrajectory")
        atom_blocks = [sidx[np.asarray(b)] for b in blocks]
        slots = np.concatenate(atom_blocks)
        if len({len(b) for b in atom_blocks}) != 1:
            raise GroupError(
                "reordered output requires equal-size solvent molecules",
                code="InvalidSelection")
        g = "__trjorder_out"
        system.group_create_from_indices(
            g, np.arange(system.topology.n_atoms) if out_group == "all"
            else _transient_indices(system, out_group))
        try:
            files = trajectory if isinstance(trajectory, list) \
                else [trajectory]
            reader = system.traj_cat_iter(files)
            system.group_traj_writer_init(g, output, fmt=outfmt)
            try:
                for f, _ in enumerate(reader):
                    src = np.concatenate(
                        [atom_blocks[m] for m in order[f]])
                    system.positions[slots] = \
                        system.positions[src].copy()
                    system.traj_write_frame()
            finally:
                system.traj_writers_close()
        finally:
            system.group_remove(g)
        out["written"] = output
    return out

def pi_mindist(system, trajectory, group: str = "all", *,
               chunk: int = 128, batch_size: int = 32,
               start_time=None, end_time=None, step=None):
    """Shortest distance between a group and its own periodic images
    (surpass — the `gmx mindist -pi` workload; absent from the
    reference).

    Per frame: min over the 26 non-zero image shifts S = n @ B and all
    atom pairs (including an atom against its own image, distance |S|)
    of |x_i - x_j + S|, plus the group's largest internal distance
    max_ij |x_i - x_j| — together they answer gmx mindist -pi's
    question: can the group see its own image through the PBC (min
    image distance smaller than the relevant interaction cutoff, or
    smaller than the max internal extent, signals a too-small box)?
    Triclinic boxes supported; the whole trajectory evaluates on device
    in one dispatch (`ops.distances.self_image_min`, chunked `[chunk,
    K]` tiles under `lax.map`).

    `group` is a group name or GSL query; `trajectory` a filename or
    DeviceTrajectory.

    Returns a dict: 'indices' [K], 'times' [F] (ps), 'min_image' [F]
    and 'max_internal' [F] (nm).
    """
    gsel, pos, boxes, dt = _resident_group_pos(
        system, trajectory, group, batch_size,
        start_time=start_time, end_time=end_time, step=step)
    mn, mx = distance_ops.self_image_min(pos, boxes, chunk=int(chunk))
    return {"indices": gsel, "times": np.asarray(dt.times, np.float64),
            "min_image": np.asarray(mn, np.float64),
            "max_internal": np.asarray(mx, np.float64)}
