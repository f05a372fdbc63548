"""Multi-device sharded analysis step (frames x atoms mesh).

The full "training step" of this framework: one jitted `shard_map` over a
`(frames, atoms)` `jax.sharding.Mesh` that evaluates a user-configured
observable suite (the same observables `TrajectoryAnalysis` composes:
Bai-Breen centers/COM, group-center distances, mass-weighted Kabsch RMSD,
min distance, contact counts) with

- the batch (frame) axis sharded over `frames`   — data parallelism, the
  array form of the reference's thread map-reduce (parallel.rs:208)
- the atom axis sharded over `atoms`             — the "sequence-parallel"
  analogue (SURVEY §2.3): per-atom partial sums (trig sums, covariances,
  weighted means) are computed locally and combined with `psum` over the
  `atoms` axis; only 3-vectors and 3x3 matrices cross devices.
  Pair observables (min distance / contacts) `all_gather` ONE side's
  coordinates over the atoms axis and reduce with `pmin`/`psum`.

All collectives are XLA collectives inserted by shard_map; nothing is
hand-scheduled.

The step is built from a declarative observable spec
(`TrajectoryAnalysis.sharded(mesh)` compiles its configured observables to
this form), so the multi-chip dryrun certifies the same observable
definitions the single-chip engine runs — the reference's
serial-vs-parallel equivalence contract (`src/system/parallel.rs` tests).

Wire formats: positions may arrive as float32 or as the q16 wire (int16
quantized XTC ints); the per-frame dequantization factor `inv_prec[B]`
comes from the decoder (`FrameBatch.precisions`) — never hardcoded.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_TWO_PI = 6.283185307179586

# array roles -> PartitionSpec over the (frames, atoms) mesh
_ROLE_ATOM_VEC = "a"    # [N]    sharded over atoms
_ROLE_ATOM_MAT = "a3"   # [N, 3] sharded over atoms
_ROLE_REPL = "r"        # any    replicated
_ROLE_REPL_ATOM = "ra"  # [N]    replicated but atom-indexed: padded to
                        # n_pad like the sharded arrays (a gathered side
                        # of a pair observable must match the padded
                        # atom axis; pad entries carry zero weight)


@dataclass
class CompiledSpec:
    """One observable compiled to mask form over the full atom layout."""

    name: str
    kind: str
    arrays: list = field(default_factory=list)  # [(role, np.ndarray), ...]
    static: dict = field(default_factory=dict)


def _mi_box(d, box):
    """Minimum image dispatching on the box representation.

    d: [b, ..., 3]; box: [b, 3] orthorhombic lengths (per-axis, the
    reference's semantics) or [b, 3, 3] triclinic row matrices (exact
    27-image search, `ops.pbc.min_image_triclinic_frames`).  Pure
    shard-local math — safe inside shard_map bodies."""
    from .pbc import min_image, min_image_frames_any

    if box.ndim == 3:
        return min_image_frames_any(d, box)
    b = box.reshape((d.shape[0],) + (1,) * (d.ndim - 2) + (3,))
    return min_image(d, b)


def _masked_bai_breen_center(pos, box, w):
    """Local partial Bai-Breen + psum over 'atoms' -> refined center.

    pos: [b, n_local, 3]; box: [b, 3] lengths or [b, 3, 3] triclinic
    matrices (the circular mean then runs in fractional coordinates,
    period 1 per axis — `ops.center.center_triclinic` in mask form);
    w: [n_local] weights (0 = excluded).
    Returns ([b, 3] center, [b] total weight).
    """
    import jax
    import jax.numpy as jnp

    from .pbc import vector_to, wrap

    wx = w[None, :, None]
    if box.ndim == 3:
        _hi = jax.lax.Precision.HIGHEST  # not TF32 (see ops/rmsd.py)
        hinv = jnp.linalg.inv(box)
        s = jnp.einsum("bni,bij->bnj", pos, hinv, precision=_hi)
        theta = (s - jnp.floor(s)) * _TWO_PI
        xi = jax.lax.psum(jnp.sum(wx * jnp.cos(theta), axis=1), "atoms")
        zeta = jax.lax.psum(jnp.sum(wx * jnp.sin(theta), axis=1), "atoms")
        est = (jnp.arctan2(-zeta, -xi) + jnp.pi) / _TWO_PI  # [b, 3] frac
        d = s - est[:, None, :]
        d = d - jnp.round(d)
        num = jax.lax.psum(jnp.sum(wx * (est[:, None, :] + d), axis=1),
                           "atoms")
        den = jax.lax.psum(jnp.sum(w), "atoms")
        frac = num / den[..., None] if den.ndim else num / den
        ctr = jnp.einsum("bi,bij->bj", frac, box, precision=_hi)
        return ctr, den

    # the estimate is the GEOMETRIC one over the selected atoms, as in
    # `ops.center.center` (iterators.rs:1237-1266); only the final mean
    # carries the weights
    mx = (w > 0).astype(pos.dtype)[None, :, None]
    scale = _TWO_PI / box  # [b, 3]
    theta = wrap(pos, box[:, None, :]) * scale[:, None, :]
    xi = jax.lax.psum(jnp.sum(mx * jnp.cos(theta), axis=1), "atoms")
    zeta = jax.lax.psum(jnp.sum(mx * jnp.sin(theta), axis=1), "atoms")
    est = (jnp.arctan2(-zeta, -xi) + jnp.pi) / scale  # [b, 3]

    unwrapped = est[:, None, :] + vector_to(est[:, None, :], pos, box[:, None, :])
    num = jax.lax.psum(jnp.sum(wx * unwrapped, axis=1), "atoms")
    den = jax.lax.psum(jnp.sum(w), "atoms")
    return num / den, den


def _eval_center(pos, box, static, arrays):
    (w,) = arrays
    c, _ = _masked_bai_breen_center(pos, box, w)
    return c


def _eval_gyration(pos, box, static, arrays):
    """Radius of gyration, atoms-sharded: refined center via psum, then a
    weighted psum of minimum-image squared distances (pad atoms carry
    zero weight)."""
    import jax
    import jax.numpy as jnp

    (w,) = arrays
    c, den = _masked_bai_breen_center(pos, box, w)
    d = _mi_box(pos - c[:, None, :], box)
    r2 = jnp.sum(d * d, axis=-1)  # [b, n_local]
    num = jax.lax.psum(jnp.sum(w[None, :] * r2, axis=-1), "atoms")
    return jnp.sqrt(num / den)


def _eval_gyration_axes(pos, box, static, arrays):
    """Rg plus gyration radii about x/y/z (gmx gyrate columns),
    atoms-sharded like _eval_gyration."""
    import jax
    import jax.numpy as jnp

    (w,) = arrays
    c, den = _masked_bai_breen_center(pos, box, w)
    d = _mi_box(pos - c[:, None, :], box)
    r2 = jnp.sum(d * d, axis=-1)  # [b, n_local]
    num = jax.lax.psum(jnp.sum(w[None, :] * r2, axis=-1), "atoms")
    cols = [jnp.sqrt(num / den)]
    for a in range(3):
        na = jax.lax.psum(
            jnp.sum(w[None, :] * (r2 - d[..., a] ** 2), axis=-1), "atoms")
        cols.append(jnp.sqrt(na / den))
    return jnp.stack(cols, axis=-1)


def _eval_distance(pos, box, static, arrays):
    import jax.numpy as jnp

    w1, w2 = arrays
    c1, _ = _masked_bai_breen_center(pos, box, w1)
    c2, _ = _masked_bai_breen_center(pos, box, w2)
    if box.ndim == 3:
        from .pbc import min_image_triclinic_frames

        d = min_image_triclinic_frames(c1 - c2, box)
    else:
        from .pbc import min_image

        d = min_image(c1 - c2, box)
    dim_mask = static["dim_mask"]
    n_active = sum(bool(v) for v in dim_mask)
    mask = jnp.asarray(dim_mask, bool)
    if n_active == 0:
        return jnp.zeros(d.shape[:-1], d.dtype)
    if n_active == 1:
        # single active axis: ORIENTED per-axis minimum image
        return jnp.sum(jnp.where(mask, d, 0.0), axis=-1)
    d = jnp.where(mask, d, 0.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def _eval_rmsd(pos, box, static, arrays):
    """Mass-weighted Kabsch RMSD vs a prepared reference, atoms-sharded.

    Mirrors `ops.rmsd.rmsd_frames` in mask form: shift the target group's
    refined COM to the box center, wrap, center, covariance via psum, QCP
    quaternion rotation (reference's SVD+det fix analogue, rmsd.rs:547-604).
    """
    import jax
    import jax.numpy as jnp

    from .pbc import wrap
    from .rmsd import _quaternion_to_matrix

    mask_f, wm, ref_local, ref_wsum = arrays
    com_t, _ = _masked_bai_breen_center(pos, box, wm)

    if box.ndim == 3:
        # triclinic (the rmsd_frames_triclinic convention in mask form):
        # unwrap the group around its exact triclinic refined COM, take
        # the mass-weighted centroid (psum), center about it
        unwrapped = com_t[:, None, :] + _mi_box(pos - com_t[:, None, :], box)
        cq_num = jax.lax.psum(
            jnp.sum(wm[None, :, None] * unwrapped, axis=1), "atoms")
        cq = cq_num / ref_wsum
        qc = (unwrapped - cq[:, None, :]) * mask_f[None, :, None]
    else:
        box_center = box * 0.5
        shifted = wrap(pos + (box_center - com_t)[:, None, :],
                       box[:, None, :])
        qc = (shifted - box_center[:, None, :]) * mask_f[None, :, None]
    pc = ref_local[None, :, :]  # already centered & masked

    h_local = jnp.einsum("bni,bnj->bij", jnp.broadcast_to(pc, qc.shape), qc,
                         precision=jax.lax.Precision.HIGHEST)
    h = jax.lax.psum(h_local, "atoms")

    sxx, sxy, sxz = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    syx, syy, syz = h[:, 1, 0], h[:, 1, 1], h[:, 1, 2]
    szx, szy, szz = h[:, 2, 0], h[:, 2, 1], h[:, 2, 2]
    k0 = jnp.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], axis=-1)
    k1 = jnp.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], axis=-1)
    k2 = jnp.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], axis=-1)
    k3 = jnp.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], axis=-1)
    kmat = jnp.stack([k0, k1, k2, k3], axis=-2)
    _, vecs = jnp.linalg.eigh(kmat)
    rot = _quaternion_to_matrix(vecs[..., :, -1])
    r = jnp.swapaxes(rot, -1, -2)

    p_rot = jnp.einsum("bni,bij->bnj", jnp.broadcast_to(pc, qc.shape), r,
                       precision=jax.lax.Precision.HIGHEST)
    dd = p_rot - qc
    local = jnp.sum(wm[None, :] * jnp.sum(dd * dd, axis=-1), axis=1)
    ssq = jax.lax.psum(local, "atoms")
    return jnp.sqrt(ssq / ref_wsum)


def _pair_valid_dist(pos, box, m1_local, m2_full):
    """[b, n_local, N] min-image pair distances + validity mask.

    One side stays shard-local; the other side's coordinates are
    `all_gather`ed over the atoms axis (its mask rides along replicated) —
    the blockwise-attention-style tiling of SURVEY §5's atom axis.
    """
    import jax
    import jax.numpy as jnp

    pos_full = jax.lax.all_gather(pos, "atoms", axis=1, tiled=True)  # [b, N, 3]
    d = pos[:, :, None, :] - pos_full[:, None, :, :]
    d = _mi_box(d, box)
    dist = jnp.sqrt(jnp.sum(d * d, axis=-1))  # [b, n_local, N]
    valid = (m1_local[None, :, None] > 0) & (m2_full[None, None, :] > 0)
    return dist, valid


def _eval_min_distance(pos, box, static, arrays):
    import jax
    import jax.numpy as jnp

    m1, m2_full = arrays
    dist, valid = _pair_valid_dist(pos, box, m1, m2_full)
    local = jnp.min(jnp.where(valid, dist, jnp.inf), axis=(1, 2))
    return jax.lax.pmin(local, "atoms")


def _eval_contacts(pos, box, static, arrays):
    import jax
    import jax.numpy as jnp

    m1, m2_full = arrays
    dist, valid = _pair_valid_dist(pos, box, m1, m2_full)
    local = jnp.sum((valid & (dist < static["cutoff"])).astype(jnp.int32),
                    axis=(1, 2))
    return jax.lax.psum(local, "atoms")


def _eval_rdf(pos, box, static, arrays):
    import jax
    import jax.numpy as jnp

    m1, m2_full = arrays
    r_max, n_bins = static["r_max"], static["n_bins"]
    dist, valid = _pair_valid_dist(pos, box, m1, m2_full)
    if static["exclude_self"]:
        # global-id diagonal: local row j is global shard_off + j
        n_local = m1.shape[0]
        gid = jax.lax.axis_index("atoms") * n_local + jnp.arange(n_local)
        valid &= (gid[None, :, None]
                  != jnp.arange(dist.shape[-1])[None, None, :])
    dr = r_max / n_bins
    idx = jnp.ceil(dist / dr).astype(jnp.int32) - 1
    ok = valid & (dist > 0.0) & (idx >= 0) & (idx < n_bins)
    idx = jnp.clip(idx, 0, n_bins - 1)
    flat_i = idx.reshape(idx.shape[0], -1)
    flat_ok = ok.reshape(ok.shape[0], -1)

    def one(ii, oo):
        return jnp.zeros(n_bins, jnp.int32).at[ii].add(oo.astype(jnp.int32))

    hist = jax.lax.psum(jax.vmap(one)(flat_i, flat_ok), "atoms")
    from .distances import rdf_normalization

    ideal = rdf_normalization(box, static["n1"], static["n2"], r_max,
                              n_bins, exclude_self=static["exclude_self"])
    return hist.astype(jnp.float32) / ideal


def _eval_density(pos, box, static, arrays):
    import jax
    import jax.numpy as jnp

    (mask,) = arrays
    ax0, ax1 = static["axes"]
    x0, x1, y0, y1 = static["span"]
    nx, ny = static["nx"], static["ny"]
    u = (pos[..., ax0] - x0) / (x1 - x0) * nx
    v = (pos[..., ax1] - y0) / (y1 - y0) * ny
    ui = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, nx - 1)
    vi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, ny - 1)
    inside = ((u >= 0) & (u < nx) & (v >= 0) & (v < ny)
              & (mask[None, :] > 0))
    flat = ui * ny + vi

    def one(ff, ii):
        return jnp.zeros(nx * ny, jnp.int32).at[ff].add(ii.astype(jnp.int32))

    hist = jax.lax.psum(jax.vmap(one)(flat, inside), "atoms")
    return hist.reshape(-1, nx, ny)


def _eval_density_profile(pos, box, static, arrays):
    """1D density profile, atoms-sharded: per-shard scatter-add histogram
    over fractional-coordinate slabs, psum over atoms (pad atoms carry
    zero weight), per-frame slab-volume normalization."""
    import jax
    import jax.numpy as jnp

    (w,) = arrays
    ax, n_bins, scale = static["axis"], static["n_bins"], static["scale"]
    if box.ndim == 3:
        # fractional coordinate along box vector `ax` (exact slabbing
        # for sheared cells); volume from the determinant
        hinv = jnp.linalg.inv(box)
        frac = jnp.einsum("bni,bij->bnj", pos, hinv,
                          precision=jax.lax.Precision.HIGHEST)[..., ax]
        vol = jnp.abs(jnp.linalg.det(box))
    else:
        frac = pos[..., ax] / box[:, None, ax]
        vol = jnp.prod(box, axis=-1)
    frac = frac - jnp.floor(frac)
    bi = jnp.clip((frac * n_bins).astype(jnp.int32), 0, n_bins - 1)

    def one(b1):
        return jnp.zeros(n_bins, jnp.float32).at[b1].add(w)

    hist = jax.lax.psum(jax.vmap(one)(bi), "atoms")
    return hist * (n_bins * scale) / vol[:, None]


def _eval_dipole(pos, box, static, arrays):
    """Dipole moment, atoms-sharded: refined COM via psum, then a psum of
    charge-weighted minimum-image displacements."""
    import jax
    import jax.numpy as jnp

    q, wm = arrays
    c, _ = _masked_bai_breen_center(pos, box, wm)
    d = _mi_box(pos - c[:, None, :], box)
    return jax.lax.psum(jnp.sum(q[None, :, None] * d, axis=1), "atoms")


def _eval_volume(pos, box, static, arrays):
    """Box volume: replicated sidecar math, no atom data touched."""
    import jax.numpy as jnp

    if box.ndim == 3:
        return jnp.abs(jnp.linalg.det(box))
    return jnp.prod(box, axis=-1)


def _eval_box_lengths(pos, box, static, arrays):
    """Box edge lengths: replicated sidecar math, no atom data touched.
    Triclinic matrices report the box-vector norms."""
    import jax.numpy as jnp

    if box.ndim == 3:
        return jnp.sqrt(jnp.sum(box * box, axis=-1))
    return box


_EVAL = {
    "center": _eval_center,
    "gyration": _eval_gyration,
    "gyration_axes": _eval_gyration_axes,
    "distance": _eval_distance,
    "rmsd": _eval_rmsd,
    "min_distance": _eval_min_distance,
    "contacts": _eval_contacts,
    "rdf": _eval_rdf,
    "density": _eval_density,
    "density_profile": _eval_density_profile,
    "dipole": _eval_dipole,
    "volume": _eval_volume,
    "box_lengths": _eval_box_lengths,
}

_OUT_RANK = {"center": 2, "gyration": 1, "gyration_axes": 2, "distance": 1, "rmsd": 1,
             "min_distance": 1, "contacts": 1, "rdf": 2, "density": 3,
             "density_profile": 2, "dipole": 2, "volume": 1,
             "box_lengths": 2}


def compile_decl(decl, system, triclinic: bool = False) -> CompiledSpec:
    """Compile one TrajectoryAnalysis observable declaration to mask form
    over the full-system atom layout.  `triclinic=True` prepares
    box-matrix observables (the step then receives `[B, 3, 3]` boxes)."""
    from ..errors import GroupError, ParallelError

    kind = decl["kind"]
    n = system.get_n_atoms()

    if triclinic and kind == "density":
        raise ParallelError(
            "the 2D density map bins absolute nm spans and has no "
            "triclinic formulation; use density_profile (fractional "
            "slabs) or an orthorhombic box")

    def group_w(group, com):
        mask = system.group_mask(group).astype(np.float32)
        if not mask.any():
            raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
        if com:
            idx = np.nonzero(mask)[0]
            if not system.topology.has_mass[idx].all():
                raise GroupError(
                    f"group '{group}' has atoms without mass", code="InvalidMass"
                )
            return mask * np.asarray(system.topology.mass, np.float32)
        return mask

    if kind == "center":
        w = group_w(decl["group"], decl["com"])
        return CompiledSpec(decl["name"], "center", [(_ROLE_ATOM_VEC, w)])

    if kind == "gyration":
        w = group_w(decl["group"], decl["com"])
        k = "gyration_axes" if decl.get("components") else "gyration"
        return CompiledSpec(decl["name"], k, [(_ROLE_ATOM_VEC, w)])

    if kind == "distance":
        w1 = group_w(decl["g1"], decl["com1"])
        w2 = group_w(decl["g2"], decl["com2"])
        return CompiledSpec(
            decl["name"], "distance",
            [(_ROLE_ATOM_VEC, w1), (_ROLE_ATOM_VEC, w2)],
            {"dim_mask": tuple(decl["dim"].value)},
        )

    if kind == "rmsd":
        from ..system.rmsd import _extract, _masses

        reference = decl["reference"]
        group = decl["group"]
        if triclinic:
            # prepare the reference with the triclinic convention
            # (`ops.rmsd.prepare_coords_triclinic`): unwrap around the
            # exact triclinic refined COM, centroid = weighted mean
            from .rmsd import prepare_coords_triclinic

            ref_idx = np.asarray(reference.group_indices(group))
            w = _masses(reference, group, ref_idx)
            ref_prep, ref_ctr = prepare_coords_triclinic(
                np.asarray(reference.positions[ref_idx], np.float32),
                np.asarray(reference.get_box().to_matrix(), np.float32),
                weights=w)
            ref_prep = np.asarray(ref_prep)
            ref_ctr = np.asarray(ref_ctr)
        else:
            # _extract returns prepared coords (COM shifted to the
            # reference box center, wrapped) + that centroid
            # (rmsd.rs:425 semantics)
            ref_prep, ref_ctr, ref_idx = _extract(reference, group)
            w = _masses(reference, group, ref_idx)
        mask = system.group_mask(group).astype(np.float32)
        idx = np.nonzero(mask)[0]
        if idx.shape[0] != ref_idx.shape[0]:
            from ..errors import RMSDError

            raise RMSDError(
                f"group '{group}' has {ref_idx.shape[0]} atoms in reference "
                f"but {idx.shape[0]} in target",
                code="InconsistentGroup",
            )
        wm = np.zeros(n, np.float32)
        wm[idx] = w
        ref_local = np.zeros((n, 3), np.float32)
        ref_local[idx] = np.asarray(ref_prep, np.float32) - np.asarray(
            ref_ctr, np.float32
        )
        return CompiledSpec(
            decl["name"], "rmsd",
            [
                (_ROLE_ATOM_VEC, mask),
                (_ROLE_ATOM_VEC, wm),
                (_ROLE_ATOM_MAT, ref_local),
                (_ROLE_REPL, np.float32(w.sum())),
            ],
        )

    if kind in ("min_distance", "contacts"):
        m1 = group_w(decl["g1"], False)
        m2 = group_w(decl["g2"], False)
        static = {"cutoff": float(decl["cutoff"])} if kind == "contacts" else {}
        return CompiledSpec(
            decl["name"], kind,
            [(_ROLE_ATOM_VEC, m1), (_ROLE_REPL_ATOM, m2)],
            static,
        )

    if kind == "rdf":
        m1 = group_w(decl["g1"], False)
        m2 = group_w(decl["g2"], False)
        return CompiledSpec(
            decl["name"], "rdf",
            [(_ROLE_ATOM_VEC, m1), (_ROLE_REPL_ATOM, m2)],
            {"r_max": float(decl["r_max"]), "n_bins": int(decl["n_bins"]),
             "exclude_self": bool(decl["same"]),
             "n1": int(m1.sum()), "n2": int(m2.sum())},
        )

    if kind == "density":
        mask = group_w(decl["group"], False)
        return CompiledSpec(
            decl["name"], "density",
            [(_ROLE_ATOM_VEC, mask)],
            {"axes": tuple(decl["axes"]), "span": tuple(decl["span"]),
             "nx": int(decl["nx"]), "ny": int(decl["ny"])},
        )

    if kind == "density_profile":
        mask = group_w(decl["group"], False)
        mode = decl["mode"]
        if mode == "mass":
            w = group_w(decl["group"], True)
        elif mode == "charge":
            idx = np.nonzero(mask)[0]
            if not system.topology.has_charge[idx].all():
                raise GroupError(
                    f"group '{decl['group']}' has atoms without charge",
                    code="InvalidCharge")
            w = mask * np.asarray(system.topology.charge, np.float32)
        else:
            w = mask
        return CompiledSpec(
            decl["name"], "density_profile", [(_ROLE_ATOM_VEC, w)],
            {"axis": int(decl["axis"]), "n_bins": int(decl["n_bins"]),
             "scale": float(decl["scale"])},
        )

    if kind == "dipole":
        wm = group_w(decl["group"], True)
        mask = system.group_mask(decl["group"])
        idx = np.nonzero(mask)[0]
        if not system.topology.has_charge[idx].all():
            raise GroupError(
                f"group '{decl['group']}' has atoms without charge",
                code="InvalidCharge")
        q = mask.astype(np.float32) * np.asarray(system.topology.charge,
                                                 np.float32)
        return CompiledSpec(
            decl["name"], "dipole",
            [(_ROLE_ATOM_VEC, q), (_ROLE_ATOM_VEC, wm)],
        )

    if kind == "volume":
        return CompiledSpec(decl["name"], "volume", [])

    if kind == "box_lengths":
        return CompiledSpec(decl["name"], "box_lengths", [])

    raise ParallelError(
        f"observable '{decl.get('name', kind)}' ({kind}) has no atoms-sharded "
        "formulation; run it on a frames-only mesh via TrajectoryAnalysis.run"
    )


def build_sharded_step(mesh, specs, n_atoms: int, triclinic: bool = False):
    """Compile the observable suite over `mesh` (frames x atoms).

    Returns `(step, params, n_pad)`:

    - `step(positions, boxes, frame_mask, inv_prec, *params) -> {name: out}`
      jitted shard_map.  `positions` is `[B, n_pad, 3]` float32 OR int16
      (the q16 wire: raw quantized XTC ints, dequantized in-shard with the
      decoder-reported `inv_prec[B]`); `boxes [B, 3]` lengths, or
      `[B, 3, 3]` row matrices with `triclinic=True` (every observable
      then runs its exact-triclinic form — fractional-space Bai-Breen,
      27-image minimum image); `frame_mask [B]`.
      B must be a multiple of the mesh's frames axis.
    - `params`: tuple of numpy arrays (atom arrays padded to `n_pad`);
      pass them through verbatim on every call.
    - `n_pad`: the padded atom count positions must be padded to (zeros;
      pad atoms carry zero weight in every observable).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import functools

    try:
        from jax import shard_map
    except ImportError:  # older jax: needs check_rep=False for psum outputs
        from jax.experimental.shard_map import shard_map

        shard_map = functools.partial(shard_map, check_rep=False)

    na = mesh.shape["atoms"]
    n_pad = -(-int(n_atoms) // na) * na

    params = []
    param_specs = []
    counts = []
    for s in specs:
        counts.append(len(s.arrays))
        for role, arr in s.arrays:
            arr = np.asarray(arr)
            if (role in (_ROLE_ATOM_VEC, _ROLE_ATOM_MAT, _ROLE_REPL_ATOM)
                    and arr.shape[0] != n_pad):
                pad = [(0, n_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
                arr = np.pad(arr, pad)
            params.append(arr)
            param_specs.append(
                P("atoms") if role == _ROLE_ATOM_VEC
                else P("atoms", None) if role == _ROLE_ATOM_MAT
                else P()
            )

    spec_list = list(specs)

    def body(pos, boxes, frame_mask, inv_prec, *args):
        if pos.dtype == jnp.int16:
            pos = pos.astype(jnp.float32) * inv_prec[:, None, None]
        out = {}
        i = 0
        for s, c in zip(spec_list, counts):
            out[s.name] = _EVAL[s.kind](pos, boxes, s.static, args[i : i + c])
            i += c
        return out

    out_specs = {
        s.name: P("frames", *([None] * (_OUT_RANK[s.kind] - 1)))
        for s in spec_list
    }
    smapped = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("frames", "atoms", None),  # positions
            (P("frames", None, None) if triclinic
             else P("frames", None)),  # box lengths / matrices
            P("frames"),  # frame mask
            P("frames"),  # per-frame dequant factor
            *param_specs,
        ),
        out_specs=out_specs,
    )
    # place the static observable arrays on the mesh once (masks and
    # reference coords are reused every batch — re-transferring them per
    # call would dominate small passes)
    from jax.sharding import NamedSharding

    params_dev = tuple(
        jax.device_put(arr, NamedSharding(mesh, spec))
        for arr, spec in zip(params, param_specs)
    )
    return jax.jit(smapped), params_dev, n_pad
