"""Conformational analyses (fits, RMSF, PCA, clustering, distance matrices, secondary structure, dihedral statistics, morphing).

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
    TrajectoryAnalysis,
    _CHI_SITES,
    _named_group,
    _resident_group_cols,
    _resident_group_pos,
    _residue_blocks,
    _system_triclinic,
    _transient_indices,
)


def _fit_inputs(system, dt, cols, group, gsel, reference, what: str):
    """Shared rmsf/pca setup: the group's device-resident float positions,
    per-frame boxes, fit masses, and a jittable `fit_frames(pos, boxes,
    fit)` closure applying the batched mass-weighted least-squares fit
    onto the reference structure (rmsd.rs:508-533 semantics)."""
    import jax
    import jax.numpy as jnp

    from ..system.rmsd import _extract, _masses

    ref_sys = system if reference is None else reference
    ref_idx = np.asarray(ref_sys.group_indices(group))
    if ref_idx.shape[0] != gsel.shape[0]:
        raise RMSDError(
            f"group '{group}' has {ref_idx.shape[0]} atoms in reference "
            f"but {gsel.shape[0]} in target", code="InconsistentGroup")
    w = np.asarray(_masses(ref_sys, group, ref_idx), np.float32)

    pos = jnp.asarray(dt.pos)[:, jnp.asarray(cols), :]
    if dt.kind == "q16":
        pos = pos.astype(jnp.float32) * jnp.asarray(dt.inv_prec)[:, None, None]
    boxes = jnp.asarray(dt.boxes)
    triclinic = boxes.ndim == 3
    ref_com = np.asarray(
        ref_sys.group_get_com_triclinic(group) if triclinic
        else ref_sys.group_get_com(group), np.float32)

    hi = jax.lax.Precision.HIGHEST

    if triclinic:
        # triclinic fit (surpass — calc_rmsd itself is orthogonal-only,
        # lib.rs:353-355): unwrap the group around its exact triclinic
        # refined COM (the add_rmsd/rmsd_frames_triclinic convention)
        # instead of the ortho translate-to-box-center + wrap, then
        # rotate about the group centroid and translate onto the
        # reference group COM
        ref_prep, ref_ctr = rmsd_ops.prepare_coords_triclinic(
            np.asarray(ref_sys.positions[ref_idx], np.float32),
            np.asarray(ref_sys.get_box().to_matrix(), np.float32),
            weights=w)
        ref_prep = jnp.asarray(ref_prep)
        ref_ctr = jnp.asarray(ref_ctr)

        def fit_frames(pos, boxes, fit):
            wj = jnp.asarray(w)
            com = center_ops.center_triclinic(pos, boxes, weights=wj)
            if fit:
                rot, _ = rmsd_ops.rmsd_frames_triclinic(
                    ref_prep, ref_ctr, pos, boxes, wj)
                unwrapped = com[:, None, :] + pbc.min_image_triclinic_frames(
                    pos - com[:, None, :], boxes)
                cq = (jnp.sum(wj[None, :, None] * unwrapped, axis=1)
                      / jnp.sum(wj))
                centered = unwrapped - cq[:, None, :]
                return jnp.einsum("fni,fji->fnj", centered, rot,
                                  precision=hi) + jnp.asarray(ref_com)
            return pos + (jnp.asarray(ref_com) - com)[:, None, :]

        return pos, boxes, w, fit_frames

    ref_coords, ref_center, _ = _extract(ref_sys, group)

    def fit_frames(pos, boxes, fit):
        wj = jnp.asarray(w)
        com = center_ops.center(pos, boxes[:, None, :], weights=wj)  # [F,3]
        if fit:
            rot, _ = rmsd_ops.rmsd_frames(
                jnp.asarray(ref_coords), jnp.asarray(ref_center),
                pos, boxes, wj)
            # apply the fit (rmsd.rs:508-533 semantics, batched): translate
            # the group COM to the box center (wrapping), rotate about it
            # by R^T (row vectors), translate to the reference group COM
            bc = boxes * 0.5
            moved = pbc.wrap(pos + (bc - com)[:, None, :], boxes[:, None, :])
            centered = moved - bc[:, None, :]
            return jnp.einsum("fni,fji->fnj", centered, rot,
                              precision=hi) + jnp.asarray(ref_com)
        return pos + (jnp.asarray(ref_com) - com)[:, None, :]

    return pos, boxes, w, fit_frames

def rmsf(system, trajectory, group: str, *, reference=None, fit: bool = True,
         batch_size: int = 32):
    """Per-atom root-mean-square fluctuation of a selection (surpass —
    the reference has RMSD/fit (`src/system/rmsd.rs`) but no RMSF;
    `gmx rmsf` semantics: every frame is least-squares fitted onto the
    reference structure with the group's masses as weights, then
    RMSF_i = sqrt(<|x_i(t) - <x_i>_t|^2>_t).

    `trajectory` is a filename (loaded device-resident once via
    `load_device`, shipping ONLY the group's atoms) or an existing
    `DeviceTrajectory` whose layout contains the group.  `reference`
    is a System providing the fit target coordinates (default: `system`
    itself, i.e. the structure file's positions — `gmx rmsf -s`).  The
    whole computation (batched QCP fit of every frame + the fluctuation
    reduction) runs on device in one jitted dispatch.  With
    `fit=False` frames are only translated (group COM to the reference
    COM), not rotated — for pre-fitted trajectories.  Orthorhombic
    boxes (the fit-path contract, as in `calc_rmsd`, rmsd.rs:425-447).

    Returns `(indices, rmsf)`: the group's global atom indices [n] and
    per-atom RMSF [n] in nm.
    """
    import jax
    import jax.numpy as jnp

    from ..parallel.engine import DeviceTrajectory

    gsel = np.asarray(system.group_indices(group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")

    if isinstance(trajectory, DeviceTrajectory):
        dt = trajectory
        cols = _resident_group_cols(system, dt, group, gsel)
    else:
        runner = TrajectoryAnalysis(
            system, triclinic=_system_triclinic(system)).runner(group=group)
        dt = runner.load_device(trajectory, batch_size=batch_size)
        cols = np.arange(len(gsel))

    pos, boxes, _, fit_frames = _fit_inputs(system, dt, cols, group, gsel,
                                            reference, what="rmsf")

    @jax.jit
    def _rmsf(pos, boxes):
        fitted = fit_frames(pos, boxes, fit)
        mean = jnp.mean(fitted, axis=0)
        d = fitted - mean[None]
        return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1), axis=0))

    return gsel, np.asarray(_rmsf(pos, boxes))

def _pca_math(fitted, sw, fmask, reduce, k):
    """Shared PCA core: deviations -> covariance -> eigh -> projections.

    `reduce` folds frame-partial sums (identity locally, `psum` over the
    'frames' mesh axis when sharded); `fmask` zeroes padded frames."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    wsum = reduce(jnp.sum(fmask))
    mean = reduce(jnp.sum(fitted * fmask[:, None, None], axis=0)) / wsum
    x = ((fitted - mean[None]) * sw[None, :, None]).reshape(
        fitted.shape[0], 3 * k)
    x = x * fmask[:, None]
    cov = reduce(jnp.matmul(x.T, x, precision=hi)) / wsum
    evals, evecs = jnp.linalg.eigh(cov)       # ascending
    evals = evals[::-1]
    evecs = evecs[:, ::-1]
    # deterministic sign: largest-|component| entry positive
    amax = jnp.argmax(jnp.abs(evecs), axis=0)
    sign = jnp.sign(evecs[amax, jnp.arange(3 * k)])
    sign = jnp.where(sign == 0, 1.0, sign)
    evecs = evecs * sign[None]
    proj = jnp.matmul(x, evecs, precision=hi)
    return mean, evals, evecs, proj, jnp.trace(cov)

def pca(system, trajectory, group: str, *, n_components: int | None = None,
        reference=None, fit: bool = True, mass_weighted: bool = True,
        batch_size: int = 32, mesh=None):
    """Principal component analysis of positional fluctuations (surpass —
    `gmx covar` + `gmx anaeig` semantics; the reference has no PCA).

    Every frame is least-squares fitted onto the reference structure
    (mass-weighted, exactly as `rmsf`/`calc_rmsd_and_fit`), then the
    3K x 3K covariance of the (optionally sqrt-mass-weighted) positional
    deviations is built in ONE `[F, 3K]^T @ [F, 3K]` matmul and
    eigendecomposed on device; frame projections
    onto the eigenvectors come from a second matmul.  The whole analysis
    is a single jitted dispatch over the device-resident trajectory.

    `trajectory` is a filename or a `DeviceTrajectory` whose layout
    contains the group.  With `mass_weighted=True` (gmx covar default)
    deviations are scaled by sqrt(m_i): eigenvalues are in amu nm^2 and
    projections in amu^(1/2) nm; unweighted, nm^2 and nm.  Eigenvector
    signs are fixed deterministically (largest-magnitude component
    positive) so results are reproducible across backends.

    With `mesh` (a `jax.sharding.Mesh` with a 'frames' axis) the whole
    analysis runs as ONE `shard_map`: frames shard over devices, each
    shard fits its frames and builds partial mean / `X^T X` sums,
    `psum` across devices combines them (two 3K-sized collectives total), and
    the eigendecomposition replicates — the data-parallel training-step
    shape.  Frame counts that don't divide the axis are zero-mask
    padded, never truncated.  Results are identical to the single-device
    path up to f32 reduction order.

    Returns a dict:
    - 'indices' [K]: the group's global atom indices
    - 'mean' [K, 3]: trajectory-average fitted structure (nm)
    - 'eigenvalues' [n]: descending
    - 'eigenvectors' [n, K, 3]: unit mass-weighted-coordinate modes
    - 'projections' [F, n]: per-frame coordinates along each mode
    - 'trace': total (mass-weighted) fluctuation, sum of ALL eigenvalues
      (gmx covar's "trace of the covariance matrix")
    """
    import jax
    import jax.numpy as jnp

    from ..parallel.engine import DeviceTrajectory

    gsel = np.asarray(system.group_indices(group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")

    if isinstance(trajectory, DeviceTrajectory):
        dt = trajectory
        cols = _resident_group_cols(system, dt, group, gsel)
    else:
        runner = TrajectoryAnalysis(
            system, triclinic=_system_triclinic(system)).runner(group=group)
        dt = runner.load_device(trajectory, batch_size=batch_size)
        cols = np.arange(len(gsel))

    pos, boxes, w, fit_frames = _fit_inputs(system, dt, cols, group, gsel,
                                            reference, what="pca")
    k = int(gsel.shape[0])
    f = int(pos.shape[0])
    if f < 2:
        raise ParallelError(
            f"pca needs at least 2 frames (trajectory has {f})")
    sw_np = (np.sqrt(np.asarray(w, np.float32)) if mass_weighted
             else np.ones((k,), np.float32))

    if mesh is None:
        @jax.jit
        def _pca(pos, boxes):
            fitted = fit_frames(pos, boxes, fit)
            return _pca_math(fitted, jnp.asarray(sw_np),
                             jnp.ones((f,), jnp.float32),
                             lambda t: t, k)

        mean, evals, evecs, proj, trace = (np.asarray(a)
                                           for a in _pca(pos, boxes))
    else:
        from jax.experimental.shard_map import shard_map
        from jax.sharding import NamedSharding, PartitionSpec

        nd = int(mesh.shape.get("frames", 1))
        f_pad = (-f) % nd
        fmask = np.concatenate([np.ones(f, np.float32),
                                np.zeros(f_pad, np.float32)])
        if f_pad:
            pos = jnp.concatenate([pos, pos[:f_pad]], axis=0)
            boxes = jnp.concatenate([boxes, boxes[:f_pad]], axis=0)
        sf = PartitionSpec("frames")
        sr = PartitionSpec()

        def _pca_shard(pos, boxes, fmask):
            fitted = fit_frames(pos, boxes, fit)
            return _pca_math(fitted, jnp.asarray(sw_np), fmask,
                             lambda t: jax.lax.psum(t, "frames"), k)

        stepped = jax.jit(shard_map(
            _pca_shard, mesh=mesh,
            in_specs=(sf, sf, sf),
            out_specs=(sr, sr, sr, sf, sr)))
        sharding = NamedSharding(mesh, sf)
        mean, evals, evecs, proj, trace = (np.asarray(a) for a in stepped(
            jax.device_put(pos, sharding), jax.device_put(boxes, sharding),
            jax.device_put(jnp.asarray(fmask), sharding)))
        proj = proj[:f]
    n = 3 * k if n_components is None else min(int(n_components), 3 * k)
    return {
        "indices": gsel,
        "mean": mean,
        "eigenvalues": evals[:n],
        "eigenvectors": evecs[:, :n].T.reshape(n, k, 3),
        "projections": proj[:, :n],
        "trace": float(trace),
        "mass_weighted": bool(mass_weighted),
        "sqrt_weights": sw_np.astype(np.float64),
    }

def rmsd_matrix(system, trajectory, group: str, *, batch_size: int = 32,
                chunk: int = 8):
    """All-pairs fitted RMSD matrix of a trajectory (surpass — the
    `gmx rms -m` workload; the reference computes single-pair RMSD only,
    rmsd.rs:432).

    Every frame pair is fitted and scored with EXACTLY the `calc_rmsd`
    convention (mass-weighted centroids, unweighted covariance fit,
    mass-weighted deviations; triclinic boxes unwrap around the exact
    triclinic refined COM first), batched on device: rows of the matrix
    evaluate `chunk` at a time, each as one QCP eigenproblem batch over
    all F columns (`ops.rmsd.rmsd_matrix`).  Feeds `models.cluster`.

    Returns `(indices [K], matrix [F, F])` in nm.
    """
    from ..system.rmsd import _masses

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)
    w = _masses(system, group, gsel)
    m = np.asarray(rmsd_ops.rmsd_matrix(pos, boxes, w, chunk=chunk))
    return gsel, m

def cluster(system, trajectory=None, group: str | None = None, *,
            cutoff: float = 0.1, method: str = "gromos",
            jp_m: int = 10, jp_p: int = 3, matrix=None,
            batch_size: int = 32, chunk: int = 8):
    """Conformational clustering (surpass — the `gmx cluster` methods;
    absent from the reference).

    Builds the all-pairs fitted RMSD matrix on device (`rmsd_matrix`),
    then clusters with `method`:

    - 'gromos' (Daura et al. 1999): iteratively take the frame with the
      most neighbours within `cutoff` (nm) as a centre, assign it and
      its neighbours, remove, repeat; ties break to the lowest index
      (gmx behaviour).
    - 'linkage': single-linkage — clusters are the connected components
      of the d < cutoff graph (gmx cluster -method linkage).
    - 'jarvis-patrick': frames cluster together when each is in the
      other's `jp_m` nearest-neighbour list AND they share at least
      `jp_p` of those neighbours (gmx -method jarvis-patrick with
      M=jp_m, P=jp_p; `cutoff` is ignored, as in gmx with -nonn 0...
      connected components of the acceptance graph).

    Pass a precomputed `matrix` ([F, F]) to skip the device pass (e.g.
    to sweep cutoffs).

    Returns a dict:
    - 'labels' [F]: cluster id per frame (0 = largest cluster)
    - 'centers' [C]: the representative frame of each cluster (gromos:
      the centre; others: the medoid — min summed intra-cluster RMSD)
    - 'sizes' [C]: frames per cluster
    - 'matrix' [F, F]: the RMSD matrix used
    """
    if matrix is None:
        if trajectory is None or group is None:
            raise ParallelError(
                "cluster needs (trajectory, group) or a precomputed matrix")
        _, matrix = rmsd_matrix(system, trajectory, group,
                                batch_size=batch_size, chunk=chunk)
    matrix = np.asarray(matrix)
    f = matrix.shape[0]
    if matrix.shape != (f, f):
        raise ParallelError(f"matrix must be square, got {matrix.shape}")

    if method == "gromos":
        neigh = matrix < float(cutoff)
        np.fill_diagonal(neigh, True)      # a frame is its own neighbour
        alive = np.ones(f, bool)
        labels = np.full(f, -1, np.int64)
        centers, sizes = [], []
        while alive.any():
            counts = (neigh & alive[None, :]).sum(axis=1)
            counts[~alive] = -1
            c = int(np.argmax(counts))     # ties -> lowest index
            members = neigh[c] & alive
            labels[members] = len(centers)
            centers.append(c)
            sizes.append(int(members.sum()))
            alive &= ~members
        return {"labels": labels, "centers": np.asarray(centers, np.int64),
                "sizes": np.asarray(sizes, np.int64), "matrix": matrix}

    if method == "linkage":
        adj = matrix < float(cutoff)
        np.fill_diagonal(adj, False)
    elif method == "jarvis-patrick":
        if jp_m < 1 or jp_m >= f:
            raise ParallelError(
                f"jp_m must be in [1, {f - 1}], got {jp_m}")
        # nearest-neighbour lists exclude self
        order = np.argsort(matrix + np.diag(np.full(f, np.inf)),
                           axis=1, kind="stable")[:, :jp_m]
        nn = np.zeros((f, f), bool)
        nn[np.repeat(np.arange(f), jp_m), order.reshape(-1)] = True
        mutual = nn & nn.T
        shared = (nn.astype(np.int32) @ nn.T.astype(np.int32)) >= jp_p
        adj = mutual & shared
        np.fill_diagonal(adj, False)
    else:
        raise ParallelError(
            f"method must be 'gromos', 'linkage', or 'jarvis-patrick', "
            f"got '{method}'")

    # connected components of adj, clusters ordered largest-first
    comp = _connected_components(adj)
    uniq, counts = np.unique(comp, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    labels = np.full(f, -1, np.int64)
    centers, sizes = [], []
    for new_id, ci in enumerate(order):
        members = np.flatnonzero(comp == uniq[ci])
        labels[members] = new_id
        sub = matrix[np.ix_(members, members)]
        centers.append(int(members[np.argmin(sub.sum(axis=1))]))
        sizes.append(len(members))
    return {"labels": labels, "centers": np.asarray(centers, np.int64),
            "sizes": np.asarray(sizes, np.int64), "matrix": matrix}

def mdmat(system, trajectory, group: str, *, per_frame: bool = False,
          batch_size: int = 32, chunk: int = 16):
    """Residue-residue smallest-distance matrix (surpass — `gmx mdmat`;
    the reference has whole-group N x M atom matrices only,
    analysis.rs:401).

    For every frame and residue pair (i, j) within `group`: the
    smallest minimum-image atom-atom distance between residue i's and
    residue j's atoms, evaluated as chunked dense tensor ops on the
    device-resident trajectory (`ops.distances.residue_min_matrix`);
    triclinic boxes use the exact 27-image minimum image.
    Residues are (chain, resnum) blocks in order of appearance.

    Returns a dict: 'resids' [R], 'resnames' [R], 'mean' [R, R] nm
    (frame average), and with `per_frame=True` also 'frames' [F, R, R].
    """
    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)
    resids, resnames, blocks = _residue_blocks(system, gsel)
    r = len(blocks)
    p = max(len(b) for b in blocks)
    block_idx = np.zeros((r, p), np.int32)
    block_mask = np.zeros((r, p), bool)
    for i, b in enumerate(blocks):
        block_idx[i, : len(b)] = b
        block_mask[i, : len(b)] = True

    m = np.asarray(distance_ops.residue_min_matrix(
        pos, boxes, block_idx, block_mask, chunk=chunk))
    out = {"resids": resids, "resnames": resnames,
           "mean": m.mean(axis=0)}
    if per_frame:
        out["frames"] = m
    return out

def dssp(system, trajectory, group: str, *, states: int = 3,
         batch_size: int = 32):
    """Secondary-structure assignment per residue per frame (surpass —
    Kabsch-Sander criteria; the reference has none and gmx shells out
    to an external dssp binary).  `states=3` (default) gives the
    pydssp-style H/E/- simplification; `states=8` the full DSSP codes
    H/G/I/E/B/T/S/- (`ops.dssp.assign_8state`).

    Backbone N/CA/C/O atoms are collected per residue from `group`
    (amide H estimated from the backbone, the pydssp convention, so
    united-atom and H-less structures work); the `[F, R, R]` hydrogen-
    bond energy matrix evaluates as one batched device op
    (`ops.dssp.hbond_energy`; triclinic boxes use the exact 27-image
    minimum image), and the Kabsch-Sander pattern algebra
    (3/4/5-turns -> minimal helices; parallel/antiparallel bridges ->
    strands) runs vectorized on the host.  Prolines and chain
    starts/gaps are never donors; patterns never span chain breaks.

    Returns a dict: 'resids' [R], 'resnames' [R], 'ss' [F, R]
    (state codes), 'frac' {code} -> float.
    """
    from ..ops import dssp as dssp_ops

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)
    resids, resnames, blocks = _residue_blocks(system, gsel)

    topo = system.topology
    names = topo.atomname
    bb = {}
    keep = []
    for i, b in enumerate(blocks):
        slot = {}
        for local in b:
            nm = names.get(int(gsel[local]))
            if nm in ("N", "CA", "C", "O") and nm not in slot:
                slot[nm] = local
        # terminal oxygens are sometimes named OC1/O1/OT1
        if "O" not in slot:
            for local in b:
                if names.get(int(gsel[local])) in ("OC1", "O1", "OT1"):
                    slot["O"] = local
                    break
        if len(slot) == 4:
            bb[i] = slot
            keep.append(i)
    if len(keep) < 5:
        raise GroupError(
            f"group '{group}' has {len(keep)} residues with a complete "
            "N/CA/C/O backbone; dssp needs at least 5",
            code="InvalidSelection")

    resids = resids[keep]
    resnames = resnames[keep]
    chains_col = system.topology.chain
    first_atom = [int(gsel[bb[i]["CA"]]) for i in keep]
    chain_of = np.asarray([chains_col.get(a) for a in first_atom], object)

    import jax.numpy as jnp

    cols = {nm: jnp.asarray([bb[i][nm] for i in keep]) for nm in
            ("N", "CA", "C", "O")}
    # consec[i]: residue i+1 directly follows residue i
    consec = np.zeros(len(keep), bool)
    consec[:-1] = (resids[1:] == resids[:-1] + 1) \
        & (chain_of[1:] == chain_of[:-1])
    donor_ok = np.ones(len(keep), bool)
    donor_ok[0] = False
    donor_ok[1:] = consec[:-1]          # needs C/O of the previous residue
    donor_ok &= np.asarray([rn != "PRO" for rn in resnames])

    if states not in (3, 8):
        raise ParallelError(f"states must be 3 or 8, got {states}")
    e = np.asarray(dssp_ops.hbond_energy(
        pos[:, cols["N"]], pos[:, cols["CA"]], pos[:, cols["C"]],
        pos[:, cols["O"]], boxes, donor_ok))
    if states == 8:
        ss = dssp_ops.assign_8state(
            e, consec, ca=np.asarray(pos[:, cols["CA"]]),
            boxes=np.asarray(boxes))
        codes = ("H", "G", "I", "E", "B", "T", "S", "-")
    else:
        ss = dssp_ops.assign_3state(e, consec)
        codes = ("H", "E", "-")
    flat = ss.ravel()
    frac = {c: float((flat == c).mean()) for c in codes}
    return {"resids": resids, "resnames": resnames, "ss": ss, "frac": frac}

def ramachandran(system, trajectory, group: str, *, batch_size: int = 32,
                 triclinic: bool = False):
    """Backbone phi/psi dihedrals per residue per frame (surpass — the
    `gmx rama` / Ramachandran workload; absent from the reference).

    phi_i = C(i-1)-N(i)-CA(i)-C(i), psi_i = N(i)-CA(i)-C(i)-N(i+1),
    built from atom names (N/CA/C) within `group`.  Residues pair only
    when adjacent (same chain, resnum difference 1) — chain breaks and
    gaps produce no angle, exactly like gmx.  Only residues with BOTH
    angles defined are reported.  The whole [F, R, 2] table evaluates
    as one batched `add_dihedrals` pass on device.

    Returns a dict: 'resids' [R], 'resnames' [R], 'phi' [F, R],
    'psi' [F, R] (signed degrees, IUPAC convention).
    """
    idx = np.asarray(system.group_indices(group))
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    topo = system.topology
    names = topo.atomname
    resnum = np.asarray(topo.resnum)
    chains = topo.chain

    # first N/CA/C of each residue, residues in order of appearance
    residues: dict[tuple, dict] = {}
    order = []
    for a in idx:
        key = (chains.get(a), int(resnum[a]))
        if key not in residues:
            residues[key] = {}
            order.append(key)
        nm = names.get(a)
        if nm in ("N", "CA", "C") and nm not in residues[key]:
            residues[key][nm] = int(a)

    phi_sites, psi_sites, out_keys = [], [], []
    for i, key in enumerate(order):
        r = residues[key]
        if not all(n in r for n in ("N", "CA", "C")):
            continue
        prev = order[i - 1] if i > 0 else None
        nxt = order[i + 1] if i + 1 < len(order) else None
        has_phi = (prev is not None and prev[0] == key[0]
                   and prev[1] == key[1] - 1 and "C" in residues[prev])
        has_psi = (nxt is not None and nxt[0] == key[0]
                   and nxt[1] == key[1] + 1 and "N" in residues[nxt])
        if has_phi and has_psi:
            phi_sites.append([residues[prev]["C"], r["N"], r["CA"], r["C"]])
            psi_sites.append([r["N"], r["CA"], r["C"], residues[nxt]["N"]])
            out_keys.append(key)
    if not out_keys:
        raise GroupError(
            f"group '{group}' has no residue with both phi and psi "
            "(needs N/CA/C names and adjacent residues)",
            code="InvalidSelection")

    pipe = (TrajectoryAnalysis(system, triclinic=triclinic)
            .add_dihedrals(np.asarray(phi_sites), name="phi")
            .add_dihedrals(np.asarray(psi_sites), name="psi"))
    out = pipe.run(trajectory, batch_size=batch_size)

    resids = np.asarray([k[1] for k in out_keys], np.int64)
    first_atom = {k: residues[k]["CA"] for k in out_keys}
    resnames = np.asarray(
        [topo.resname.get(first_atom[k]) for k in out_keys], object)
    return {"resids": resids, "resnames": resnames,
            "phi": np.asarray(out["phi"]), "psi": np.asarray(out["psi"])}

def entropy(system, trajectory, group: str, *, temperature: float = 300.0,
            reference=None, fit: bool = True, batch_size: int = 32):
    """Configurational entropy from positional covariance (surpass — the
    `gmx anaeig -entropy` workload; absent from the reference).

    Runs the mass-weighted positional PCA (`models.pca`: batched fit +
    one covariance matmul + device `eigh`) and evaluates both
    standard estimates over the eigenvalues lambda_i (amu nm^2):

    - Schlitter's upper bound:
      S = (kB/2) sum ln(1 + kB T e^2 lambda_i / hbar^2)
    - quasi-harmonic (Andricioaei & Karplus): per mode
      alpha_i = hbar omega_i / kB T with omega_i = sqrt(kB T / lambda_i),
      S = kB sum [alpha/(e^alpha - 1) - ln(1 - e^-alpha)]

    Near-zero modes (the six rigid-body directions removed by the fit)
    contribute nothing to either formula and are clamped at 0.  In the
    classical limit (large lambda) the two estimates agree mode-for-mode
    at kB (1 - ln alpha) — property-tested.

    Returns a dict: 'schlitter' and 'quasiharmonic' in kJ/(mol K),
    'eigenvalues' [3K] (amu nm^2, descending), 'alphas' [3K]
    (dimensionless hbar omega / kB T of the kept modes, inf for
    clamped ones).
    """
    if not temperature > 0:
        raise ParallelError("temperature must be positive")
    res = pca(system, trajectory, group, reference=reference, fit=fit,
              mass_weighted=True, batch_size=batch_size)
    lam = np.asarray(res["eigenvalues"], np.float64)

    kb_j = 1.380649e-23            # J/K, per molecule
    hbar = 1.0545718176e-34        # J s
    amu_nm2 = 1.66053906660e-27 * 1e-18   # amu nm^2 -> kg m^2
    kb_kj = 8.31446261815324e-3    # kJ/(mol K)

    lam_si = np.clip(lam, 0.0, None) * amu_nm2
    kbt = kb_j * float(temperature)
    arg = kbt * lam_si * np.e ** 2 / hbar ** 2
    s_schlitter = 0.5 * kb_kj * float(np.log1p(arg).sum())

    with np.errstate(divide="ignore"):
        alpha = hbar / np.sqrt(kbt * lam_si)   # = hbar omega / kB T
    pos_mask = lam_si > 0
    a = alpha[pos_mask]
    with np.errstate(over="ignore"):
        s_qh = kb_kj * float(
            (a / np.expm1(a) - np.log1p(-np.exp(-a))).sum())

    return {"schlitter": s_schlitter, "quasiharmonic": s_qh,
            "eigenvalues": lam, "alphas": alpha}

def rotmat(system, trajectory, group: str, *, reference=None,
           batch_size: int = 32):
    """Per-frame least-squares rotation matrices onto a reference
    structure (surpass — the `gmx rotmat` workload; the reference
    applies the fit, rmsd.rs:508-533, but never exposes the matrix).

    Every frame's group is fitted onto the reference with EXACTLY the
    `calc_rmsd` convention (mass-weighted centroids, unweighted
    covariance, batched QCP on device); `matrices[f]` is the proper
    rotation R with `x_ref ≈ R @ (x_frame - com_frame) + com_ref` —
    the matrix gmx rotmat prints, suitable for `trjconv -fit` style
    post-processing or box-alignment diagnostics.

    Returns a dict: 'indices' [K], 'matrices' [F, 3, 3], 'rmsd' [F]
    (nm, the fitted RMSD of each frame — same numbers as `add_rmsd`).
    """
    import jax
    import jax.numpy as jnp

    from ..system.rmsd import _extract, _masses

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)

    ref_sys = system if reference is None else reference
    ref_idx = np.asarray(ref_sys.group_indices(group))
    if ref_idx.shape[0] != gsel.shape[0]:
        raise RMSDError(
            f"group '{group}' has {ref_idx.shape[0]} atoms in reference "
            f"but {gsel.shape[0]} in target", code="InconsistentGroup")
    w = np.asarray(_masses(ref_sys, group, ref_idx), np.float32)

    if boxes.ndim == 3:
        # triclinic: the add_rmsd/rmsd_frames_triclinic convention
        ref_prep, ref_ctr = rmsd_ops.prepare_coords_triclinic(
            np.asarray(ref_sys.positions[ref_idx], np.float32),
            np.asarray(ref_sys.get_box().to_matrix(), np.float32),
            weights=w)

        @jax.jit
        def _rm(pos, boxes):
            return rmsd_ops.rmsd_frames_triclinic(
                jnp.asarray(np.asarray(ref_prep)),
                jnp.asarray(np.asarray(ref_ctr)), pos, boxes,
                jnp.asarray(w))
    else:
        ref_coords, ref_center, _ = _extract(ref_sys, group)

        @jax.jit
        def _rm(pos, boxes):
            return rmsd_ops.rmsd_frames(
                jnp.asarray(ref_coords), jnp.asarray(ref_center), pos,
                boxes, jnp.asarray(w))

    rot, r = _rm(pos, boxes)
    return {"indices": gsel, "matrices": np.asarray(rot),
            "rmsd": np.asarray(r)}

def dccm(system, trajectory, group: str, *, reference=None, fit: bool = True,
         batch_size: int = 32):
    """Dynamic cross-correlation matrix of atomic fluctuations (surpass —
    the classic DCCM analysis, Ichiye & Karplus 1991; neither the
    reference nor gmx ships it, though it is the standard companion to
    `gmx covar`).

    Every frame is least-squares fitted onto the reference structure
    (same mass-weighted convention as `rmsf`/`pca`; `fit=False`
    translates group COM only), then with dr_i(f) = x_i(f) - <x_i> the
    atom-pair covariance C_ij = <dr_i . dr_j> evaluates as ONE
    `[F,K,3] x [F,K,3] -> [K,K]` HIGHEST-precision einsum on device and
    is normalized to the correlation matrix
    DCCM_ij = C_ij / sqrt(C_ii C_jj) in [-1, 1].

    Returns a dict: 'indices' [K], 'dccm' [K, K] (unitless, diagonal
    exactly 1), 'covariance' [K, K] (nm^2).
    """
    import jax
    import jax.numpy as jnp

    from ..parallel.engine import DeviceTrajectory

    gsel = np.asarray(system.group_indices(group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")

    if isinstance(trajectory, DeviceTrajectory):
        dt = trajectory
        cols = _resident_group_cols(system, dt, group, gsel)
    else:
        runner = TrajectoryAnalysis(
            system, triclinic=_system_triclinic(system)).runner(group=group)
        dt = runner.load_device(trajectory, batch_size=batch_size)
        cols = np.arange(len(gsel))

    pos, boxes, _, fit_frames = _fit_inputs(system, dt, cols, group, gsel,
                                            reference, what="dccm")
    f = int(pos.shape[0])
    if f < 2:
        raise ParallelError(
            f"dccm needs at least 2 frames (trajectory has {f})")

    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def _dccm(pos, boxes):
        fitted = fit_frames(pos, boxes, fit)
        d = fitted - jnp.mean(fitted, axis=0)[None]
        c = jnp.einsum("fid,fjd->ij", d, d, precision=hi) / f
        var = jnp.diagonal(c)
        denom = jnp.sqrt(jnp.maximum(var[:, None] * var[None, :], 1e-30))
        m = c / denom
        # exact unit diagonal regardless of rounding
        m = m - jnp.diag(jnp.diagonal(m)) + jnp.eye(m.shape[0], dtype=m.dtype)
        return m, c

    m, c = _dccm(pos, boxes)
    return {"indices": gsel, "dccm": np.asarray(m),
            "covariance": np.asarray(c)}

def _connected_components(adj):
    """Union-find over a boolean [M, M] adjacency -> labels [M] (0-based,
    numbered by first appearance)."""
    m = adj.shape[0]
    parent = np.arange(m)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in np.argwhere(np.triu(adj, 1)):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri
    roots = np.fromiter((find(i) for i in range(m)), np.int64, m)
    _, labels = np.unique(roots, return_inverse=True)
    # renumber by first appearance
    first = np.full(labels.max() + 1 if m else 0, -1, np.int64)
    order = []
    for lab in labels:
        if first[lab] < 0:
            first[lab] = len(order)
            order.append(lab)
    return first[labels]

def clustsize(system, trajectory, group: str = "all", *,
              cutoff: float = 0.35, mode: str = "molecule",
              batch_size: int = 32, chunk: int = 16):
    """Aggregate / cluster-size analysis (surpass — the `gmx clustsize`
    workload; absent from the reference).

    Entities — the molecules of `group` from the bond graph
    (`Topology.molecule_ids`, iterating.rs:399), or single atoms with
    `mode="atom"` — are connected when their smallest minimum-image
    atom-atom distance is below `cutoff` (nm); connected components per
    frame are the clusters.  The contact matrix evaluates as chunked
    dense tensor tiles on device (the mdmat kernel,
    `ops.distances.residue_min_matrix`); component labeling is a host
    union-find over the [M, M] boolean adjacency.

    Returns a dict:
    - 'mode', 'n_entities' M, 'times' [F] (ps)
    - 'labels' [F, M]: cluster id per entity (0-based, numbered by
      first member)
    - 'n_clusters' [F], 'max_size' [F]
    - 'mean_size' [F]: number-averaged cluster size M / n_clusters
    - 'mean_size_w' [F]: weight-averaged size sum(s^2)/sum(s) (gmx
      clustsize's second moment)
    - 'size_hist' [M + 1]: size_hist[s] = number of (frame, cluster)
      pairs with exactly s entities
    """
    if mode not in ("molecule", "atom"):
        raise ParallelError(
            f"clustsize mode must be 'molecule' or 'atom', got {mode!r}")
    gsel, pos, boxes, dt = _resident_group_pos(
        system, trajectory, group, batch_size)

    if mode == "molecule":
        mol = np.asarray(system.topology.molecule_ids())[gsel]
        order, blocks = [], {}
        for local, mid in enumerate(mol):
            mid = int(mid)
            if mid not in blocks:
                blocks[mid] = []
                order.append(mid)
            blocks[mid].append(local)
        blocks = [blocks[mid] for mid in order]
    else:
        blocks = [[i] for i in range(len(gsel))]
    m = len(blocks)
    p = max(len(b) for b in blocks)
    block_idx = np.zeros((m, p), np.int32)
    block_mask = np.zeros((m, p), bool)
    for i, b in enumerate(blocks):
        block_idx[i, : len(b)] = b
        block_mask[i, : len(b)] = True

    dmin = np.asarray(distance_ops.residue_min_matrix(
        pos, boxes, block_idx, block_mask, chunk=chunk))   # [F, M, M]
    f = dmin.shape[0]
    labels = np.empty((f, m), np.int64)
    n_clusters = np.empty(f, np.int64)
    max_size = np.empty(f, np.int64)
    mean_w = np.empty(f, np.float64)
    hist = np.zeros(m + 1, np.int64)
    for fi in range(f):
        lab = _connected_components(dmin[fi] < cutoff)
        labels[fi] = lab
        sizes = np.bincount(lab)
        n_clusters[fi] = len(sizes)
        max_size[fi] = sizes.max()
        mean_w[fi] = (sizes.astype(np.float64) ** 2).sum() / sizes.sum()
        hist[: sizes.max() + 1] += np.bincount(sizes)[: sizes.max() + 1]
    return {"mode": mode, "n_entities": m,
            "times": np.asarray(dt.times, np.float64),
            "labels": labels, "n_clusters": n_clusters,
            "max_size": max_size,
            "mean_size": m / n_clusters.astype(np.float64),
            "mean_size_w": mean_w, "size_hist": hist}

def rmsdist(system, trajectory, group: str, *, reference=None,
            pbc_aware: bool = False, batch_size: int = 32,
            chunk: int = 256):
    """RMS deviation of intra-group atom-pair distances per frame vs a
    reference structure (surpass — the `gmx rmsdist` workload; absent
    from the reference).

    RMSdist(t) = sqrt(mean over i<j of (d_ij(t) - d_ij(ref))^2), the
    fit-free alternative to RMSD.  Distances are plain Euclidean (the
    gmx convention: molecules are assumed whole) unless `pbc_aware=True`
    (min-image with each frame's box, exact 27-image for triclinic
    cells — a surpass option).  The [K, K]
    pair matrices evaluate as device row tiles (`chunk` rows per step
    under `lax.map`, frames batched in one dispatch).

    `reference`: a System (defaults to `system`'s own coordinates).

    Returns a dict: 'rmsdist' [F] (nm), 'ref_distances' [K, K],
    'mean_deviation' [K, K] (mean |d_ij(t) - d_ij(ref)| over frames,
    the gmx `-mean` matrix).
    """
    import jax
    import jax.numpy as jnp

    gsel, pos, boxes, _ = _resident_group_pos(
        system, trajectory, group, batch_size)

    ref = system if reference is None else reference
    rp = np.asarray(ref.positions, np.float32)
    if rp.shape[0] != system.topology.n_atoms:
        raise RMSDError(
            "reference system has a different atom count",
            code="InconsistentGroup")
    rp = rp[gsel]
    k = int(gsel.shape[0])
    n_chunks = -(-k // chunk)
    pad = n_chunks * chunk - k
    if pad:
        rp = np.concatenate([rp, np.zeros((pad, 3), np.float32)])
    rbox = None
    if pbc_aware:
        if ref.simbox is None:
            raise RMSDError("pbc_aware rmsdist needs a reference box",
                            code="InvalidSimBox")
        rbox = (np.asarray(ref.simbox.to_matrix(), np.float32)
                if not ref.simbox.is_orthogonal()
                else np.asarray([ref.simbox.x, ref.simbox.y, ref.simbox.z],
                                np.float32))

    # mask for valid (i, j) pairs, i != j, padded rows dead
    valid = np.ones(k + pad, bool)
    valid[k:] = False
    n_pairs = k * (k - 1)

    @jax.jit
    def _dref(rp):
        def rows(start):
            c = jax.lax.dynamic_slice_in_dim(rp, start, chunk)
            d = c[:, None, :] - rp[None, :k, :]
            if rbox is not None:
                d = (pbc.min_image_triclinic(d, jnp.asarray(rbox))
                     if rbox.ndim == 2
                     else pbc.min_image(d, jnp.asarray(rbox)))
            return jnp.sqrt(jnp.sum(d * d, axis=-1))
        return jax.lax.map(rows, jnp.arange(n_chunks) * chunk)

    dref = _dref(jnp.asarray(rp))                  # [n_chunks, chunk, K]

    @jax.jit
    def _pass(pos, boxes, dref):
        vmask = jnp.asarray(valid)
        posp = jnp.concatenate(
            [pos, jnp.zeros((pos.shape[0], pad, 3), pos.dtype)],
            axis=1) if pad else pos

        # chunks outer (stacked by lax.map), frames inner (scan carry):
        # each chunk owns its own |deviation| accumulator rows, so the
        # [K, K] mean matrix reassembles exactly for any chunk count.
        def one_chunk(args):
            start, dr = args                         # dr [chunk, K]
            rm = jax.lax.dynamic_slice_in_dim(vmask, start, chunk)
            diag = (start + jnp.arange(chunk))[:, None] \
                == jnp.arange(k)[None, :]
            m = (rm[:, None] & ~diag).astype(jnp.float32)

            def frames(sad, fargs):
                pf, box = fargs                      # pf [K+pad, 3]
                c = jax.lax.dynamic_slice_in_dim(pf, start, chunk)
                d = c[:, None, :] - pf[None, :k, :]
                if pbc_aware:
                    d = (pbc.min_image_triclinic(d, box) if box.ndim == 2
                         else pbc.min_image(d, box))
                dist = jnp.sqrt(jnp.sum(d * d, axis=-1))   # [C, K]
                dev = (dist - dr) * m
                return sad + jnp.abs(dev), jnp.sum(dev * dev)

            sad, sse_f = jax.lax.scan(
                frames, jnp.zeros((chunk, k), jnp.float32), (posp, boxes))
            return sad, sse_f                        # [C, K], [F]

        sad, sse = jax.lax.map(
            one_chunk, (jnp.arange(n_chunks) * chunk, dref))
        return jnp.sum(sse, axis=0), sad

    sse, sad = _pass(pos, boxes, dref)
    rms = np.sqrt(np.asarray(sse, np.float64) / n_pairs)
    f = int(pos.shape[0])
    mean_dev = np.asarray(sad, np.float64).reshape(-1, k)[:k] / f
    dref_full = np.asarray(dref, np.float64).reshape(-1, k)[:k]
    return {"rmsdist": rms, "ref_distances": dref_full,
            "mean_deviation": mean_dev}

def chi(system, trajectory, group: str = "@protein", *, max_chi: int = 2,
        batch_size: int = 32, triclinic: bool = False):
    """Side-chain χ dihedrals and χ₁ rotamer occupancies (surpass — the
    `gmx chi` workload; absent from the reference).

    Builds χ₁..χ_`max_chi` (≤ 4) site tables per residue from standard
    atom names (χ₁ = N-CA-CB-{CG|CG1|OG|OG1|SG}, χ₂ =
    CA-CB-{CG|CG1}-{CD|CD1|OD1|ND1|SD}, ...; first present name wins,
    residues lacking an atom are skipped for that χ) and evaluates the
    whole table as batched `add_dihedrals` passes on device.

    Rotamer wells for χ₁ follow the standard convention: gauche+ =
    (0°, 120°), trans = |χ| ≥ 120°, gauche− = (−120°, 0°).

    Returns a dict with, per χ order k present: 'chi{k}' [F, R_k]
    (signed degrees), 'chi{k}_resids' [R_k], 'chi{k}_resnames' [R_k];
    plus 'rotamers': {'g+','t','g-'} → occupancy fraction [R_1] over
    frames (from χ₁).
    """
    if not 1 <= max_chi <= 4:
        raise ParallelError(f"max_chi must be 1..4, got {max_chi}")
    idx = _transient_indices(system, group)
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    topo = system.topology
    names = topo.atomname
    resnum = np.asarray(topo.resnum)
    chains = topo.chain

    residues: dict[tuple, dict] = {}
    order = []
    for a in idx:
        key = (chains.get(a), int(resnum[a]))
        if key not in residues:
            residues[key] = {}
            order.append(key)
        nm = names.get(a)
        if nm not in residues[key]:
            residues[key][nm] = int(a)

    pipe = TrajectoryAnalysis(system, triclinic=triclinic)
    meta = {}
    for k in range(max_chi):
        sites, keys = [], []
        for key in order:
            r = residues[key]
            picked = []
            for alts in _CHI_SITES[k]:
                hit = next((r[nm] for nm in alts if nm in r), None)
                if hit is None:
                    break
                picked.append(hit)
            if len(picked) == 4:
                sites.append(picked)
                keys.append(key)
        if sites:
            nm = f"chi{k + 1}"
            pipe.add_dihedrals(np.asarray(sites), name=nm)
            meta[nm] = keys
    if not meta:
        raise GroupError(
            f"group '{group}' has no residue with χ-angle atoms",
            code="InvalidSelection")

    res = pipe.run(trajectory, batch_size=batch_size)
    out = {}
    for nm, keys in meta.items():
        out[nm] = np.asarray(res[nm])
        out[f"{nm}_resids"] = np.asarray([k[1] for k in keys], np.int64)
        out[f"{nm}_resnames"] = np.asarray(
            [topo.resname.get(next(iter(
                [residues[k][n] for n in ("CA", "CB")
                 if n in residues[k]]))) for k in keys], object)
    if "chi1" in out:
        c1 = out["chi1"]
        out["rotamers"] = {
            "g+": np.mean((c1 > 0) & (c1 < 120), axis=0),
            "t": np.mean(np.abs(c1) >= 120, axis=0),
            "g-": np.mean((c1 > -120) & (c1 < 0), axis=0),
        }
    return out

def morph(system_a, system_b, *, n: int = 30, first: float = 0.0,
          last: float = 1.0, fit: bool = True, group: str = "all",
          output: str | None = None, outfmt: str | None = None):
    """Linear interpolation between two conformations (surpass — the
    `gmx morph` workload; absent from the reference).

    `system_b` (a System or a structure filename loaded against a copy
    of `system_a`'s topology expectations) is optionally least-squares
    fitted onto `system_a` over `group` first (`calc_rmsd_and_fit`,
    rmsd.rs:508 semantics), then `n` frames x(lambda) =
    (1 - lambda) x_A + lambda x_B are generated for lambda in
    [first, last] (gmx morph's -ninterm/-first/-last; values outside
    [0, 1] extrapolate).  The per-frame RMSD to both endpoints is
    evaluated as ONE batched device QCP pass each.  With `output`, the
    interpolated trajectory is written for `group`.

    Returns a dict: 'lambdas' [n], 'frames' [n, K, 3] (group atoms),
    'rmsd_a'/'rmsd_b' [n] nm.
    """
    import jax.numpy as jnp

    from ..system import System as _System
    from ..system.rmsd import _extract, _masses

    if isinstance(system_b, (str, os.PathLike)):
        system_b = _System.from_file(str(system_b))
    if system_b.get_n_atoms() != system_a.get_n_atoms():
        raise RMSDError(
            f"morph endpoints have {system_a.get_n_atoms()} vs "
            f"{system_b.get_n_atoms()} atoms", code="InconsistentGroup")
    if n < 2:
        raise ParallelError(f"morph needs n >= 2 frames, got {n}")

    idx = _transient_indices(system_a, group)
    b = system_b.copy()
    idx_b = _transient_indices(b, group)
    if idx_b.size != idx.size:
        raise RMSDError(
            f"group '{group}' selects {idx.size} atoms in A but "
            f"{idx_b.size} in B", code="InconsistentGroup")
    # the fit group must exist under ONE name in both systems
    gf = "__morph_fit"
    system_a.group_create_from_indices(gf, idx)
    b.group_create_from_indices(gf, idx_b)
    try:
        if fit:
            b.calc_rmsd_and_fit(system_a, gf)
        xb = b.positions[idx_b].astype(np.float64)
        xa = system_a.positions[idx].astype(np.float64)

        lambdas = np.linspace(float(first), float(last), int(n))
        frames = ((1.0 - lambdas)[:, None, None] * xa[None]
                  + lambdas[:, None, None] * xb[None]).astype(np.float32)

        # batched QCP RMSD to each endpoint (PBC-aware centering over
        # the endpoint system's own box, like calc_rmsd)
        w = np.asarray(_masses(system_a, group, idx), np.float32)
        from ..core.simbox import simbox_check

        blen = simbox_check(system_a.get_box()).to_lengths_vec()
        boxes = jnp.broadcast_to(jnp.asarray(blen, jnp.float32), (int(n), 3))

        def series(ref_sys, g):
            ref_coords, ref_center, _ = _extract(ref_sys, g)
            return np.asarray(rmsd_ops.rmsd_frames(
                jnp.asarray(ref_coords), jnp.asarray(ref_center),
                jnp.asarray(frames), boxes, jnp.asarray(w))[1],
                np.float64)

        out = {"lambdas": lambdas, "frames": frames,
               "rmsd_a": series(system_a, gf), "rmsd_b": series(b, gf)}
    finally:
        system_a.group_remove(gf)

    if output is not None:
        wsys = system_a.copy()
        with _named_group(wsys, group, "__morph_w") as gw:
            wsys.group_traj_writer_init(gw, output, fmt=outfmt)
            try:
                for k in range(int(n)):
                    wsys.positions[idx] = frames[k]
                    wsys.traj_write_frame()
            finally:
                wsys.traj_writers_close()
        out["written"] = output
    return out

def subspace_overlap(pca_a, pca_b, *, n: int | None = None):
    """Subspace and covariance overlap between two PCA analyses
    (surpass — the `gmx anaeig -over` workload; absent from the
    reference, which has no PCA at all).

    Both inputs are `models.pca` result dicts (or any dicts carrying
    'eigenvectors' [n, K, 3] and 'eigenvalues' [n]) over the SAME atom
    group and weighting.  Over the first `n` modes of each (default:
    all modes both analyses carry):

    - inner products d_ij = v_i . w_j ([n, n])
    - subspace overlap = (1/n) sum_ij d_ij^2 in [0, 1] — 1 iff the two
      n-dimensional essential subspaces coincide (gmx anaeig's
      "subspace overlap" / RMSIP^2)
    - RMSIP = sqrt(subspace overlap) (root-mean-square inner product)
    - covariance overlap (Hess, Phys Rev E 65 031910, gmx anaeig's
      second number): 1 - sqrt[(sum_i la_i + sum_j lb_j -
      2 sum_ij sqrt(la_i lb_j) d_ij^2) / (sum_i la_i + sum_j lb_j)]
      — also weighs how similar the fluctuation MAGNITUDES along the
      shared directions are.

    All arithmetic is float64 on host (the matrices are [n, 3K] — tiny
    next to the trajectory passes that produced them).

    Returns a dict: 'n', 'inner' [n, n], 'subspace_overlap', 'rmsip',
    'covariance_overlap'.
    """
    va = np.asarray(pca_a["eigenvectors"], np.float64)
    vb = np.asarray(pca_b["eigenvectors"], np.float64)
    if va.ndim != 3 or vb.ndim != 3 or va.shape[1:] != vb.shape[1:]:
        raise ParallelError(
            f"eigenvector shapes do not match: {va.shape} vs {vb.shape} "
            "(both analyses must cover the same atom group)")
    la = np.asarray(pca_a["eigenvalues"], np.float64)
    lb = np.asarray(pca_b["eigenvalues"], np.float64)
    n_max = min(va.shape[0], vb.shape[0], la.shape[0], lb.shape[0])
    n = n_max if n is None else int(n)
    if not 0 < n <= n_max:
        raise ParallelError(
            f"n must be in [1, {n_max}] (modes carried by both analyses), "
            f"got {n}")
    a = va[:n].reshape(n, -1)
    b = vb[:n].reshape(n, -1)
    d = a @ b.T
    ss = d * d
    overlap = float(ss.sum() / n)
    la_n = np.clip(la[:n], 0.0, None)
    lb_n = np.clip(lb[:n], 0.0, None)
    denom = float(la_n.sum() + lb_n.sum())
    if denom > 0:
        cross = float((np.sqrt(np.outer(la_n, lb_n)) * ss).sum())
        cov_overlap = 1.0 - np.sqrt(max(denom - 2.0 * cross, 0.0) / denom)
    else:
        cov_overlap = float("nan")
    return {"n": n, "inner": d, "subspace_overlap": overlap,
            "rmsip": float(np.sqrt(overlap)),
            "covariance_overlap": float(cov_overlap)}

def cosine_content(projections, *, n_modes: int | None = None):
    """Cosine content of principal-component projections (surpass — the
    `gmx analyze -cc` workload; absent from the reference).

    For mode i (1-based), the cosine content of its projection series
    p ([F]) is

      c_i = (2/F) * (sum_j cos(i pi j / (F-1)) p_j)^2 / sum_j p_j^2

    in [0, 1]: values near 1 mean the PC looks like the i-th cosine —
    the signature of random diffusion rather than converged sampling
    (Hess, Phys Rev E 65 031910).  `projections` is `models.pca`'s
    'projections' [F, n] (or any [F] / [F, n] series); float64 on host.

    Returns c [n_modes] (or a scalar for a 1-D input).
    """
    p = np.asarray(projections, np.float64)
    scalar = p.ndim == 1
    if scalar:
        p = p[:, None]
    if p.ndim != 2 or p.shape[0] < 2:
        raise ParallelError(
            f"projections must be [F>=2] or [F>=2, n], got {p.shape}")
    f, n_all = p.shape
    n = n_all if n_modes is None else min(int(n_modes), n_all)
    if n < 1:
        raise ParallelError(f"n_modes must be >= 1, got {n_modes}")
    t = np.arange(f, dtype=np.float64) / (f - 1)
    cc = np.empty(n, np.float64)
    for i in range(n):
        y = p[:, i]
        denom = float(y @ y)
        if denom == 0.0:
            cc[i] = 0.0
            continue
        num = float(np.cos((i + 1) * np.pi * t) @ y)
        cc[i] = 2.0 / f * num * num / denom
    return float(cc[0]) if scalar else cc

def mode_traj(system, pca_result, group: str, *, mode: int = 1,
              amplitude: float | None = None, n: int = 30,
              phases: int = 1, output: str | None = None,
              outfmt: str | None = None):
    """Oscillation trajectory along a principal mode (surpass — the
    `gmx nmtraj` workload over quasi-harmonic modes; absent from the
    reference).

    Generates `n` frames x(t) = mean + A cos(2 pi (phases * t / n))
    * v_mode / sw, where `mean` and `v_mode` come from `pca_result`
    (a `models.pca` dict over `group`) and `sw` undoes its sqrt-mass
    weighting so the output is in plain nm.  `mode` is 1-based.  The
    default amplitude is the quasi-harmonic thermal extreme
    sqrt(2 lambda_mode) in mass-weighted coordinates (RMS fluctuation
    along the mode times sqrt(2) — the turning point of a harmonic
    oscillator carrying that variance); pass `amplitude` (same
    amu^1/2 nm units the projections use) to override, e.g. the
    min/max observed projection for a data-spanning sweep.

    With `output`, the frames are written as a `group` trajectory in
    any writer format (like `gmx nmtraj -o`).

    Returns a dict: 'frames' [n, K, 3] (nm), 'displacement' [n]
    (the cosine coordinate in projection units), 'amplitude'.
    """
    if not 1 <= int(mode) <= pca_result["eigenvectors"].shape[0]:
        raise ParallelError(
            f"mode must be in [1, {pca_result['eigenvectors'].shape[0]}], "
            f"got {mode}")
    if n < 2:
        raise ParallelError(f"mode_traj needs n >= 2 frames, got {n}")
    idx = _transient_indices(system, group)
    mean = np.asarray(pca_result["mean"], np.float64)
    if mean.shape[0] != idx.size:
        raise ParallelError(
            f"pca_result covers {mean.shape[0]} atoms but group "
            f"'{group}' selects {idx.size}")
    ev = np.asarray(pca_result["eigenvectors"][int(mode) - 1], np.float64)
    sw = np.asarray(
        pca_result.get("sqrt_weights",
                       np.sqrt(np.asarray(system.topology.mass,
                                          np.float64)[idx])
                       if pca_result.get("mass_weighted", True)
                       else np.ones(idx.size)), np.float64)
    if amplitude is None:
        lam = float(pca_result["eigenvalues"][int(mode) - 1])
        amplitude = float(np.sqrt(max(2.0 * lam, 0.0)))
    disp = float(amplitude) * np.cos(
        2.0 * np.pi * float(phases) * np.arange(int(n)) / int(n))
    frames = (mean[None] + disp[:, None, None]
              * (ev / sw[:, None])[None]).astype(np.float32)

    out = {"frames": frames, "displacement": disp,
           "amplitude": float(amplitude)}
    if output is not None:
        wsys = system.copy()
        with _named_group(wsys, group, "__modetraj_w") as gw:
            wsys.group_traj_writer_init(gw, output, fmt=outfmt)
            try:
                for k in range(int(n)):
                    wsys.positions[idx] = frames[k]
                    wsys.set_time(float(k))
                    wsys.traj_write_frame()
            finally:
                wsys.traj_writers_close()
        out["written"] = output
    return out
