"""Hydrogen-bond detection (reference: `src/system/hbonds.rs`).

Redesign of the reference's donor->neighbor-acceptor walk
(hbonds.rs:160-298): candidates are pruned with the same acceptor cell grid
(cell size = max_distance, `hbonds.rs:163-170`), but generated for ALL
donors at once with vectorized CSR gathers, then scored as flat arrays.

Scoring reproduces the reference's float32 arithmetic exactly, op for op:

- D-A distance: per-axis loop-subtract minimum image (`vector3d.rs:575-592`)
  then `sqrt(dx*dx + dy*dy + dz*dz)` left-fold (`Vector3D::distance`);
  keep when `!(distance > max_distance)`.
- D-H-A angle: `vector_to` = `floor_mod(b - a + L/2, L) - L/2` with Rust's
  truncated `%` (== `np.fmod`), `acos(dot / (len*len)).to_degrees()`
  WITHOUT clamping, so out-of-range cosines go NaN and take the reference's
  `handle_nan` path (H closer to A than D is to A -> 180, else 0;
  hbonds.rs:302-338); keep when `!(angle < min_angle)`.

Bond order matches the reference: donors in chain order; per donor,
acceptors in cell-grid neighbor order (x,y,z relative offsets in (-1,0,1),
ascending atom index within a cell); per acceptor, the donor's hydrogens in
bonded order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import HBondError, SelectError


@dataclass
class HBondChain:
    """GSL queries selecting a chain's acceptors/donors/hydrogens
    (reference: hbonds.rs:24)."""

    acceptors: str
    donors: str
    hydrogens: str


@dataclass
class HBond:
    """reference: hbonds.rs:52."""

    donor: int
    hydrogen: int
    acceptor: int
    distance: float
    angle: float


class _ChainGroups:
    """Resolved chain: acceptor indices + donor-major hydrogen CSR
    (reference: HBondChainGroups, hbonds.rs:93-144)."""

    def __init__(self, system, chain: HBondChain):
        from ..select import parse_query
        from ..select.compile import evaluate_mask

        try:
            acc = np.nonzero(evaluate_mask(parse_query(chain.acceptors), system))[0]
            don = np.nonzero(evaluate_mask(parse_query(chain.donors), system))[0]
            hyd_mask = evaluate_mask(parse_query(chain.hydrogens), system)
        except SelectError as e:
            raise HBondError(str(e), code="SelectError") from e

        bonded = system.topology.bonded
        donors = []
        h_offsets = [0]
        h_idx = []
        for d in don:
            hs = [int(h) for h in bonded[d] if hyd_mask[h]]
            donors.append(int(d))
            h_idx.extend(hs)
            h_offsets.append(len(h_idx))
        self.acceptors = acc.astype(np.int64)
        self.donors = np.asarray(donors, np.int64)
        self.h_offsets = np.asarray(h_offsets, np.int64)
        self.h_idx = np.asarray(h_idx, np.int64)
        if acc.shape[0] == 0 and self.donors.shape[0] == 0:
            raise HBondError("chain selects no acceptors and no donors", code="EmptyChain")


def _sanity_check_pairs(pairs, n_chains):
    """reference: hbonds.rs sanity_check_pairs."""
    seen = set()
    used = set()
    for c1, c2 in pairs:
        for c in (c1, c2):
            if c >= n_chains or c < 0:
                raise HBondError(f"chain {c} does not exist", code="NonexistentChain")
        key = (min(c1, c2), max(c1, c2))
        if key in seen:
            raise HBondError(
                f"pair ({c1}, {c2}) specified multiple times", code="PairSpecifiedMultipleTimes"
            )
        seen.add(key)
        used.update((c1, c2))
    if len(used) != n_chains:
        raise HBondError("some chain is not used by any pair", code="UnusedChain")


# ------------------------------------------------------------------ exact-f32
# numpy emulations of the reference's scalar PBC math


def _wrap_loop(p, box):
    """`Vector3D::wrap` loop semantics: while x > L: x -= L; while x < 0:
    x += L (vector3d.rs:380-417). All float32."""
    p = p.astype(np.float32).copy()
    box = np.broadcast_to(box.astype(np.float32), p.shape)
    while True:
        m = p > box
        if not m.any():
            break
        p[m] -= box[m]
    while True:
        m = p < 0.0
        if not m.any():
            break
        p[m] += box[m]
    return p


def _min_image_loop(d, box):
    """`Vector3D::min_image` loop semantics (vector3d.rs:575-592), float32."""
    d = d.astype(np.float32).copy()
    box = np.broadcast_to(box.astype(np.float32), d.shape)
    half = box / np.float32(2.0)
    while True:
        m = d > half
        if not m.any():
            break
        d[m] -= box[m]
    while True:
        m = d < -half
        if not m.any():
            break
        d[m] += box[m]
    return d


def _distance_xyz(a, b, box):
    """`Vector3D::distance(.., XYZ, ..)` (vector3d.rs:458-486), float32."""
    d = _min_image_loop(a - b, box)
    return np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])


def _vector_to(a, b, box):
    """`Vector3D::vector_to` (vector3d.rs:561-569): floor_mod(b - a + L/2, L)
    - L/2, floor_mod(x, y) = (x % y + y) % y with truncated %, float32."""
    box = np.broadcast_to(box.astype(np.float32), a.shape).astype(np.float32)
    half = box / np.float32(2.0)
    x = b - a + half
    return np.fmod(np.fmod(x, box) + box, box) - half


def _axis_offsets(n):
    """Relative offsets -1,0,1 deduped modulo n, preserving order
    (reference: CellNeighbors::convert)."""
    out, seen = [], set()
    for d in (-1, 0, 1):
        m = d % n
        if m not in seen:
            seen.add(m)
            out.append(d)
    return out


def _candidate_pairs(positions, box, chain_acc: _ChainGroups,
                     chain_don: _ChainGroups, max_distance):
    """Cell-pruned candidate (donor, acceptor) pairs in reference order
    (the C++ cell walk `gx_hbond_candidates`; the float distance/angle
    criteria are evaluated later — on host by `_detect`, or batched on
    device by `HBondAnalysis.analyze_batch`).

    Returns (d_rank, a_rank) int64 RANKS into `chain_don.donors` /
    `chain_acc.acceptors`, with donor==acceptor self-pairs removed.
    """
    from ..io import native

    if chain_acc.acceptors.shape[0] == 0 or chain_don.donors.shape[0] == 0:
        return (np.zeros(0, np.int64),) * 2
    return native.hbond_candidates(
        np.ascontiguousarray(positions, np.float32),
        np.asarray(box, np.float32),
        chain_acc.acceptors, chain_don.donors, float(max_distance),
    )


def _candidate_pairs_np(positions, box, chain_acc: _ChainGroups,
                        chain_don: _ChainGroups, max_distance):
    """Pure-numpy reference implementation of `_candidate_pairs` (kept
    for order/content parity testing of the C++ walk)."""
    acceptors = chain_acc.acceptors
    donors = chain_don.donors
    empty = (np.zeros(0, np.int64),) * 2
    if acceptors.shape[0] == 0 or donors.shape[0] == 0:
        return empty

    box = box.astype(np.float32)
    pos = positions.astype(np.float32, copy=False)
    max_distance = np.float32(max_distance)

    # --- acceptor cell grid (cell size = max_distance, cellgrid.rs:444,472)
    ncells = np.maximum(np.floor(box / max_distance).astype(np.int64), 1)
    cell_w = (box / ncells.astype(np.float32)).astype(np.float32)
    aw = _wrap_loop(pos[acceptors], box)
    acoord = np.floor(aw / cell_w).astype(np.int64) % ncells
    acid = (acoord[:, 0] * ncells[1] + acoord[:, 1]) * ncells[2] + acoord[:, 2]
    order = np.argsort(acid, kind="stable")  # ascending atom index per cell
    sorted_cells = acid[order]
    total = int(ncells.prod())
    cell_off = np.searchsorted(sorted_cells, np.arange(total + 1))

    dw = _wrap_loop(pos[donors], box)
    dcoord = np.floor(dw / cell_w).astype(np.int64) % ncells

    # --- vectorized candidate generation over the <=27 neighbor offsets
    nd = donors.shape[0]
    d_rank_parts, a_pos_parts, off_rank_parts, within_parts = [], [], [], []
    off_rank = 0
    for dx in _axis_offsets(int(ncells[0])):
        for dy in _axis_offsets(int(ncells[1])):
            for dz in _axis_offsets(int(ncells[2])):
                nb0 = (dcoord[:, 0] + dx) % ncells[0]
                nb1 = (dcoord[:, 1] + dy) % ncells[1]
                nb2 = (dcoord[:, 2] + dz) % ncells[2]
                cid = (nb0 * ncells[1] + nb1) * ncells[2] + nb2
                s = cell_off[cid]
                cnt = cell_off[cid + 1] - s
                nz = np.nonzero(cnt)[0]
                if nz.shape[0] == 0:
                    off_rank += 1
                    continue
                c = cnt[nz]
                rep_d = np.repeat(nz, c)
                grp_start = np.repeat(np.cumsum(c) - c, c)
                within = np.arange(rep_d.shape[0]) - grp_start
                a_pos = np.repeat(s[nz], c) + within
                d_rank_parts.append(rep_d)
                a_pos_parts.append(a_pos)
                within_parts.append(within)
                off_rank_parts.append(np.full(rep_d.shape[0], off_rank, np.int64))
                off_rank += 1

    if not d_rank_parts:
        return empty
    d_rank = np.concatenate(d_rank_parts)
    a_rank = order[np.concatenate(a_pos_parts)]  # index into `acceptors`
    off_ranks = np.concatenate(off_rank_parts)
    withins = np.concatenate(within_parts)

    # exclude the donor itself (hbonds.rs:253)
    keep = donors[d_rank] != acceptors[a_rank]
    d_rank, a_rank = d_rank[keep], a_rank[keep]
    off_ranks, withins = off_ranks[keep], withins[keep]

    # reference order: donor-major, then neighbor-cell order, then in-cell
    srt = np.lexsort((withins, off_ranks, d_rank))
    return d_rank[srt], a_rank[srt]


def _expand_hydrogens(chain_don: _ChainGroups, d_rank, a_rank, acceptors):
    """(donor, acceptor) pairs -> hydrogen-expanded (d_idx, h_idx, a_idx)
    triples in reference order (per acceptor, the donor's hydrogens in
    bonded order)."""
    h_counts = (chain_don.h_offsets[d_rank + 1] - chain_don.h_offsets[d_rank])
    rep = np.repeat(np.arange(d_rank.shape[0]), h_counts)
    grp_start = np.repeat(np.cumsum(h_counts) - h_counts, h_counts)
    h_slot = np.arange(rep.shape[0]) - grp_start
    h_idx = chain_don.h_idx[chain_don.h_offsets[d_rank][rep] + h_slot]
    return chain_don.donors[d_rank][rep], h_idx, acceptors[a_rank][rep]


def _score_triples(pos, box, d_idx, h_idx, a_idx, max_distance, min_angle):
    """Exact reference-f32 scoring of candidate triples on host.

    Returns (keep bool, dist, angle) per triple — the distance criterion
    (`!(distance > max_distance)`, hbonds.rs:256) and the D-H-A angle
    criterion with NaN disambiguation (calc_angle, hbonds.rs:302-338).
    """
    max_distance = np.float32(max_distance)
    min_angle = np.float32(min_angle)
    dist = _distance_xyz(pos[a_idx], pos[d_idx], box)
    keep = ~(dist > max_distance)

    hp = pos[h_idx]
    hd = _vector_to(hp, pos[d_idx], box)
    ha = _vector_to(hp, pos[a_idx], box)
    dot = hd[:, 0] * ha[:, 0] + hd[:, 1] * ha[:, 1] + hd[:, 2] * ha[:, 2]
    len_hd = np.sqrt(hd[:, 0] * hd[:, 0] + hd[:, 1] * hd[:, 1] + hd[:, 2] * hd[:, 2])
    len_ha = np.sqrt(ha[:, 0] * ha[:, 0] + ha[:, 1] * ha[:, 1] + ha[:, 2] * ha[:, 2])
    with np.errstate(invalid="ignore", divide="ignore"):
        cosang = dot / (len_hd * len_ha)
        angle = np.degrees(np.arccos(cosang)).astype(np.float32)
    nan = np.isnan(angle)
    if nan.any():
        # handle_nan: 180 if H is closer to A than D is to A, else 0
        ha_d = _distance_xyz(pos[h_idx[nan]], pos[a_idx[nan]], box)
        da_d = _distance_xyz(pos[d_idx[nan]], pos[a_idx[nan]], box)
        angle[nan] = np.where(ha_d < da_d, np.float32(180.0), np.float32(0.0))
    keep &= ~(angle < min_angle)
    return keep, dist, angle


def _detect(positions, box, chain_acc: _ChainGroups, chain_don: _ChainGroups,
            max_distance, min_angle):
    """Cell-pruned vectorized detection: acceptors of `chain_acc` against
    donors of `chain_don` (reference: analyze_single, hbonds.rs:229-298).
    Returns a list of HBond in reference order."""
    box = box.astype(np.float32)
    pos = positions.astype(np.float32, copy=False)
    d_rank, a_rank = _candidate_pairs(pos, box, chain_acc, chain_don,
                                      max_distance)
    d_idx, h_idx, a_idx = _expand_hydrogens(chain_don, d_rank, a_rank,
                                            chain_acc.acceptors)
    if d_idx.shape[0] == 0:
        return []
    keep, dist, angle = _score_triples(pos, box, d_idx, h_idx, a_idx,
                                       max_distance, min_angle)
    return [
        HBond(donor=int(d), hydrogen=int(h), acceptor=int(a),
              distance=float(di), angle=float(an))
        for d, h, a, di, an in zip(
            d_idx[keep], h_idx[keep], a_idx[keep], dist[keep], angle[keep]
        )
    ]


# ------------------------------------------------------------------ device
# Batched evaluation of candidate triples: ONE masked jitted kernel over a
# [B, n_cand] batch (SURVEY §2.2 hbonds row: "distance+angle criteria ->
# masked pair kernel").  XLA may contract multiply-add chains into FMAs
# and arccos is not correctly rounded, so device values can differ from
# the numpy host path by float ulps.  Any triple whose keep DECISION could
# be affected — distance within ~30 ulps of the cutoff, angle within the
# conditioning-aware error bound of the threshold (arccos error grows as
# 1/sqrt(1-cos^2) near 0/180 deg), or an ambiguous NaN disambiguation —
# is re-scored on host with the exact reference-f32 semantics, so the
# detected bond set is exact at device speed on any backend (CPU, GPU).

_ANGLE_GUARD = np.float32(2e-3)       # flat floor, degrees
_COS_EPS = np.float32(1e-6)           # assumed worst-case cos-chain ulp error
_DIST_GUARD_REL = np.float32(1e-6)
_GUARD_K = 128                        # compact guarded-slot list capacity


def _build_device_score(n_pairs: int):
    """The [B, n_cand] masked pair kernel, jitted per pair-count.

    Inputs are compact PAIR RANKS into static per-analysis tables (donor
    atom index, acceptor atom index, per-donor hydrogen rows), so the
    host->device wire is ~10 bytes per candidate pair instead of shipping
    hydrogen-expanded atom-index triples; hydrogens expand ON DEVICE from
    the `h_tab` CSR rows (slot axis H).
    """
    import jax
    import jax.numpy as jnp

    def _min_image_dev(d, box):
        # `Vector3D::min_image` loop semantics (vector3d.rs:575-592):
        # a fixed unrolled count replaces the data-dependent while (extra
        # passes are no-ops, matching loop exit)
        half = box * jnp.float32(0.5)
        for _ in range(4):
            d = jnp.where(d > half, d - box, d)
        for _ in range(4):
            d = jnp.where(d < -half, d + box, d)
        return d

    def _dist_dev(a, b, box):
        d = _min_image_dev(a - b, box)
        return jnp.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                        + d[..., 2] * d[..., 2])

    def _vector_to_dev(a, b, box):
        # floor_mod(b - a + L/2, L) - L/2 with Rust's truncated `%`
        half = box * jnp.float32(0.5)
        x = b - a + half
        return jnp.fmod(jnp.fmod(x, box) + box, box) - half

    def score(pos, boxes, inv_prec, d_rank, a_rank, seg, valid,
              don_idx, acc_idx, h_tab, h_cnt, max_distance, min_angle):
        """pos [B,N,3] f32 or i16 (q16 wire); boxes [B,3]; inv_prec [B];
        d_rank/a_rank [B,C] ranks; seg [B,C] pair ids; valid [B,C];
        don_idx [ND], acc_idx [NA], h_tab [ND,H], h_cnt [ND].
        -> (counts [B,P] i32, guard_cnt [B] i32,
            keep [B,C,H], dist [B,C], angle [B,C,H], guard [B,C,H])."""
        if pos.dtype == jnp.int16:
            pos = pos.astype(jnp.float32) * inv_prec[:, None, None]
        b, c = d_rank.shape
        hmax = h_tab.shape[1]
        box = boxes[:, None, :]  # [B,1,3]

        d_i = jnp.take(don_idx, d_rank.astype(jnp.int32), mode="clip")
        a_i = jnp.take(acc_idx, a_rank.astype(jnp.int32), mode="clip")
        h_i = jnp.take(h_tab, d_rank.astype(jnp.int32), axis=0,
                       mode="clip")  # [B,C,H]
        n_h = jnp.take(h_cnt, d_rank.astype(jnp.int32), mode="clip")  # [B,C]

        def take(idx):
            flat = idx.reshape(b, -1)
            out = jnp.take_along_axis(pos, flat[..., None], axis=1,
                                      mode="clip")
            return out.reshape(idx.shape + (3,))

        dp, ap = take(d_i), take(a_i)  # [B,C,3]
        dist = _dist_dev(ap, dp, box)  # [B,C]
        keep_d = ~(dist > max_distance)

        hp = take(h_i)  # [B,C,H,3]
        box_h = box[:, :, None, :]
        dp_h = dp[:, :, None, :]
        ap_h = ap[:, :, None, :]
        hd = _vector_to_dev(hp, dp_h, box_h)
        ha = _vector_to_dev(hp, ap_h, box_h)
        dot = (hd[..., 0] * ha[..., 0] + hd[..., 1] * ha[..., 1]
               + hd[..., 2] * ha[..., 2])
        len_hd = jnp.sqrt(hd[..., 0] * hd[..., 0] + hd[..., 1] * hd[..., 1]
                          + hd[..., 2] * hd[..., 2])
        len_ha = jnp.sqrt(ha[..., 0] * ha[..., 0] + ha[..., 1] * ha[..., 1]
                          + ha[..., 2] * ha[..., 2])
        cosang = dot / (len_hd * len_ha)
        angle = jnp.degrees(jnp.arccos(cosang)).astype(jnp.float32)
        nan = jnp.isnan(angle)
        # handle_nan: 180 if H is closer to A than D is to A, else 0
        ha_d = _dist_dev(hp, ap_h, box_h)
        da_d = _dist_dev(dp_h, ap_h, box_h)
        angle = jnp.where(nan, jnp.where(ha_d < da_d, jnp.float32(180.0),
                                         jnp.float32(0.0)), angle)

        h_valid = (jnp.arange(hmax)[None, None, :] < n_h[..., None])
        tri_valid = valid[..., None] & h_valid
        keep = tri_valid & keep_d[..., None] & ~(angle < min_angle)

        # decision-boundary guard: angle error bound = flat floor +
        # arccos conditioning term (blows up near 0/180 deg)
        cond = jnp.float32(57.29578) * _COS_EPS / jnp.sqrt(
            jnp.maximum(1.0 - cosang * cosang, jnp.float32(1e-12)))
        guard = jnp.abs(angle - min_angle) < (_ANGLE_GUARD + cond)
        guard |= (jnp.abs(dist - max_distance)
                  < max_distance * _DIST_GUARD_REL)[..., None]
        # ambiguous NaN disambiguation (ha_d vs da_d within ulps)
        guard |= nan & (jnp.abs(ha_d - da_d)
                        < (ha_d + da_d) * _DIST_GUARD_REL)
        guard &= tri_valid

        counts = jnp.stack(
            [jnp.sum((keep & (seg == p)[..., None]).astype(jnp.int32),
                     axis=(1, 2)) for p in range(n_pairs)],
            axis=-1,
        )
        guard_cnt = jnp.sum(guard.astype(jnp.int32), axis=(1, 2))
        # compact guarded-slot list: the counts path must never pull an
        # O(n_cand) mask back over the wire — only these [B, K] slots
        gflat = guard.reshape(b, -1)
        import functools

        (gidx,) = jax.vmap(functools.partial(
            jnp.nonzero, size=_GUARD_K, fill_value=-1))(gflat)
        keep_at = jnp.take_along_axis(
            keep.reshape(b, -1), jnp.maximum(gidx, 0), axis=1)
        return counts, guard_cnt, gidx.astype(jnp.int32), keep_at, \
            keep, dist, angle, guard

    return jax.jit(score)


_device_score_cache: dict = {}


def _get_device_score(n_pairs: int):
    fn = _device_score_cache.get(n_pairs)
    if fn is None:
        fn = _device_score_cache[n_pairs] = _build_device_score(n_pairs)
    return fn


class _PairTables:
    """Static device tables for one HBondAnalysis: combined donor/acceptor
    atom-index tables and per-donor hydrogen rows across all
    (pair, direction) legs (reference analyze_pair directions,
    hbonds.rs:207-225)."""

    def __init__(self, analysis: "HBondAnalysis"):
        self.legs = []  # (pair_id, acc_chain, don_chain, don_off, acc_off)
        don_parts, acc_parts = [], []
        nd = na = 0
        maxh = 1
        for pair_id, (c1, c2) in enumerate(analysis.pairs):
            directions = ([(c1, c1)] if c1 == c2 else [(c1, c2), (c2, c1)])
            for acc_c, don_c in directions:
                acc_g = analysis.chains[acc_c]
                don_g = analysis.chains[don_c]
                self.legs.append((pair_id, acc_g, don_g, nd, na))
                don_parts.append(don_g.donors)
                acc_parts.append(acc_g.acceptors)
                cnts = don_g.h_offsets[1:] - don_g.h_offsets[:-1]
                if cnts.shape[0]:
                    maxh = max(maxh, int(cnts.max()))
                nd += don_g.donors.shape[0]
                na += acc_g.acceptors.shape[0]
        self.don_idx = (np.concatenate(don_parts) if don_parts
                        else np.zeros(0, np.int64)).astype(np.int32)
        self.acc_idx = (np.concatenate(acc_parts) if acc_parts
                        else np.zeros(0, np.int64)).astype(np.int32)
        self.h_tab = np.zeros((max(nd, 1), maxh), np.int32)
        self.h_cnt = np.zeros(max(nd, 1), np.int32)
        for _, _, don_g, don_off, _ in self.legs:
            for k in range(don_g.donors.shape[0]):
                s, e = don_g.h_offsets[k], don_g.h_offsets[k + 1]
                self.h_cnt[don_off + k] = e - s
                self.h_tab[don_off + k, : e - s] = don_g.h_idx[s:e]
        # compact rank dtype when tables are small (halves the pair wire)
        self.rank_dtype = (np.int16 if max(nd, na) <= 32767 else np.int32)

    def pack_frames(self, positions, boxes, max_distance):
        """Candidate pairs for a [B] frame block -> padded rank arrays.

        Returns (d_rank, a_rank [B,C], seg [B,C] i16 pair ids,
        valid [B,C], segments per frame [(pair_key, start, stop), ...]).
        C rounds up to a power of two (>= 64) so the kernel recompiles
        per bucket, not per batch.
        """
        b = positions.shape[0]
        per_frame = []
        seg_list = []
        for i in range(b):
            ds, as_, ss = [], [], []
            segments = []
            n = 0
            last_pair = None
            for pair_id, acc_g, don_g, don_off, acc_off in self.legs:
                d_r, a_r = _candidate_pairs(positions[i], boxes[i],
                                            acc_g, don_g, max_distance)
                ds.append(d_r + don_off)
                as_.append(a_r + acc_off)
                ss.append(np.full(d_r.shape[0], pair_id, np.int16))
                if last_pair == pair_id:
                    # second direction of a cross-chain pair: extend
                    pk, s0, _ = segments[-1]
                    segments[-1] = (pk, s0, n + d_r.shape[0])
                else:
                    segments.append((pair_id, n, n + d_r.shape[0]))
                last_pair = pair_id
                n += d_r.shape[0]
            per_frame.append((np.concatenate(ds) if ds else np.zeros(0, np.int64),
                              np.concatenate(as_) if as_ else np.zeros(0, np.int64),
                              np.concatenate(ss) if ss else np.zeros(0, np.int16)))
            seg_list.append(segments)

        cmax = max((t[0].shape[0] for t in per_frame), default=0)
        c_pad = 64
        while c_pad < cmax:
            c_pad *= 2
        d = np.zeros((b, c_pad), self.rank_dtype)
        a = np.zeros((b, c_pad), self.rank_dtype)
        seg = np.full((b, c_pad), -1, np.int16)
        valid = np.zeros((b, c_pad), bool)
        for i, (di, ai, si) in enumerate(per_frame):
            n = di.shape[0]
            d[i, :n] = di
            a[i, :n] = ai
            seg[i, :n] = si
            valid[i, :n] = True
        return d, a, seg, valid, seg_list


class HBondAnalysis:
    """Per-frame hydrogen-bond analyzer (reference: hbonds.rs:86)."""

    def __init__(self, system, chains, pairs, max_distance: float, min_angle: float):
        self.chains = [_ChainGroups(system, c) for c in chains]
        _sanity_check_pairs(pairs, len(self.chains))
        self.pairs = list(pairs)
        self.max_distance = float(max_distance)
        self.min_angle = float(min_angle)

    def analyze(self, system) -> dict:
        """-> HBondMap: {(chain1, chain2): [HBond, ...]}."""
        from ..core.simbox import simbox_check

        box = simbox_check(system.get_box()).to_lengths_vec()
        pos = system.positions
        out = {}
        for c1, c2 in self.pairs:
            if c1 == c2:
                bonds = _detect(pos, box, self.chains[c1], self.chains[c1],
                                self.max_distance, self.min_angle)
            else:
                # reference analyze_pair: acceptors(c1) x donors(c2), then
                # acceptors(c2) x donors(c1) (hbonds.rs:207-225)
                bonds = _detect(pos, box, self.chains[c1], self.chains[c2],
                                self.max_distance, self.min_angle)
                bonds += _detect(pos, box, self.chains[c2], self.chains[c1],
                                 self.max_distance, self.min_angle)
            out[(c1, c2)] = bonds
        return out

    # ------------------------------------------------------------- batched
    def _tables(self) -> _PairTables:
        t = getattr(self, "_tables_cache", None)
        if t is None:
            t = self._tables_cache = _PairTables(self)
        return t

    def analyze_batch(self, positions, boxes, counts_only: bool = False,
                      q_positions=None, inv_prec=None):
        """Batched-device analysis of a `[B, N, 3]` frame block.

        Host work is integer-only candidate PAIR generation (CSR cell
        binning); the pairs ship as compact ranks into static device
        tables, hydrogens expand on device, and the float distance/angle
        criteria run as ONE masked jitted kernel over the padded
        `[B, n_cand]` batch.  Returns a list of HBondMap per frame — or,
        with `counts_only`, a dict `{pair: int[B]}` of per-frame bond
        counts computed on device (only `[B, n_pairs]` ints come back to
        host; the fast path for trajectory statistics).

        `q_positions`/`inv_prec`: optionally ship the q16 wire format
        (int16 quantized ints + per-frame dequant factor) instead of f32 —
        halves the position wire; `positions` stays the host f32 copy used
        for binning and the exactness re-score.

        Exactness: see the module device-kernel note — every triple whose
        keep decision could be affected by device/host float-ulp
        differences is re-scored on host, so the detected bond SET equals
        `analyze()` exactly on any backend.  Reported distance/angle
        values may differ from the host path by float ulps (XLA FMA
        contraction; arccos rounding), always well under the guard widths.
        """
        positions = np.asarray(positions, np.float32)
        boxes = np.asarray(boxes, np.float32)
        b = positions.shape[0]
        tables = self._tables()
        d_r, a_r, seg, valid, seg_list = tables.pack_frames(
            positions, boxes, self.max_distance)

        ship = positions if q_positions is None else q_positions
        if inv_prec is None:
            inv_prec = np.ones(b, np.float32)
        (counts_d, guard_cnt_d, gidx_d, keep_at_d,
         keep_d, dist_d, angle_d, guard_d) = (
            _get_device_score(len(self.pairs))(
                ship, boxes, np.asarray(inv_prec, np.float32),
                d_r, a_r, seg, valid,
                tables.don_idx, tables.acc_idx, tables.h_tab, tables.h_cnt,
                np.float32(self.max_distance), np.float32(self.min_angle),
            )
        )
        hmax = tables.h_tab.shape[1]

        def _rescore(i, keep_i, dist_i, angle_i, guard_i):
            """Exact host re-score of frame i's guarded (c, h) slots;
            mutates the given per-frame arrays, returns adjusted."""
            ci, hi = np.nonzero(guard_i)
            if ci.shape[0] == 0:
                return keep_i
            g = d_r[i, ci].astype(np.int64)
            d_idx = tables.don_idx[g].astype(np.int64)
            h_idx = tables.h_tab[g, hi].astype(np.int64)
            a_idx = tables.acc_idx[a_r[i, ci].astype(np.int64)].astype(np.int64)
            k2, dist2, ang2 = _score_triples(
                positions[i], boxes[i], d_idx, h_idx, a_idx,
                self.max_distance, self.min_angle,
            )
            keep_i[ci, hi] = k2
            dist_i[ci] = dist2
            angle_i[ci, hi] = ang2
            return keep_i

        if counts_only:
            counts = np.array(counts_d)
            guard_cnt = np.asarray(guard_cnt_d)
            need = np.nonzero(guard_cnt > 0)[0]
            if need.shape[0]:
                gidx = np.asarray(gidx_d)
                keep_at = np.asarray(keep_at_d)
            for i in need:
                if guard_cnt[i] <= _GUARD_K:
                    # compact path: only the guarded slots, no O(n_cand)
                    # device->host transfer
                    sl = gidx[i][gidx[i] >= 0]
                    ci, hi = sl // hmax, sl % hmax
                    g = d_r[i, ci].astype(np.int64)
                    k2, _, _ = _score_triples(
                        positions[i], boxes[i],
                        tables.don_idx[g].astype(np.int64),
                        tables.h_tab[g, hi].astype(np.int64),
                        tables.acc_idx[a_r[i, ci].astype(np.int64)
                                       ].astype(np.int64),
                        self.max_distance, self.min_angle,
                    )
                    delta = (k2.astype(np.int64)
                             - keep_at[i][: sl.shape[0]].astype(np.int64))
                    segs = seg[i, ci]
                    for p in range(len(self.pairs)):
                        counts[i, p] += int(delta[segs == p].sum())
                else:  # pathological: fall back to the full-frame pull
                    keep_i = np.array(keep_d[i])
                    before = keep_i.copy()
                    keep_i = _rescore(i, keep_i, np.array(dist_d[i]),
                                      np.array(angle_d[i]),
                                      np.asarray(guard_d[i]))
                    delta = keep_i.astype(np.int64) - before.astype(np.int64)
                    for p in range(len(self.pairs)):
                        counts[i, p] += int(delta[seg[i] == p].sum())
            return {tuple(pair): counts[:, p].astype(np.int64)
                    for p, pair in enumerate(self.pairs)}

        keep = np.array(keep_d)
        dist = np.array(dist_d)
        angle = np.array(angle_d)
        guard = np.asarray(guard_d)
        maps = []
        for i in range(b):
            keep[i] = _rescore(i, keep[i], dist[i], angle[i], guard[i])
            hmap = {}
            for pair_id, s, e in seg_list[i]:
                # row-major (pair, h-slot) = reference bond order
                ci, hi = np.nonzero(keep[i, s:e])
                ci = ci + s
                g = d_r[i, ci].astype(np.int64)
                hmap[tuple(self.pairs[pair_id])] = [
                    HBond(donor=int(tables.don_idx[gj]),
                          hydrogen=int(tables.h_tab[gj, hj]),
                          acceptor=int(tables.acc_idx[int(a_r[i, cj])]),
                          distance=float(dist[i, cj]),
                          angle=float(angle[i, cj, hj]))
                    for gj, cj, hj in zip(g, ci, hi)
                ]
            maps.append(hmap)
        return maps


def make_dense_counter(analysis: "HBondAnalysis", tile: int = 64,
                       with_guard: bool = False):
    """Fully in-step hydrogen-bond COUNTER: a jittable
    `fn(positions[B, N, 3] f32, boxes[B, 3]) -> int32 [B, n_pairs]`
    (or `(counts [B, n_pairs], guarded [B])` with `with_guard=True`).

    The dense formulation of SURVEY §2.2's hbonds row: NO cell grid,
    NO host candidate generation, NO extra wire — every (donor, acceptor)
    pair is evaluated dense, tiled over the donor axis with `lax.scan` so
    the [ND, NA] intermediates never exceed `tile x NA x H` (the blockwise
    attention-style tiling of SURVEY §5).  Criteria are the same device
    formulas as the rank kernel (distance, D-H-A angle, NaN
    disambiguation).

    `with_guard` additionally counts decision-boundary triples per frame
    (same conditioning-aware band as the cells kernel: distance within
    ulps of the cutoff, angle within the arccos-error bound of the
    threshold, ambiguous NaN disambiguation).  A frame with `guarded == 0`
    is EXACT by construction on any backend; frames with guards are
    re-scored host-side by the pipeline (hbonds.rs:302-340 boundary
    semantics).
    """
    import jax
    import jax.numpy as jnp

    tables = analysis._tables()
    maxd = np.float32(analysis.max_distance)
    min_ang = np.float32(analysis.min_angle)
    n_pairs = len(analysis.pairs)
    hmax = tables.h_tab.shape[1]

    # static per-leg tables (device constants via closure)
    legs = []
    for pair_id, acc_g, don_g, don_off, acc_off in tables.legs:
        nd = don_g.donors.shape[0]
        na = acc_g.acceptors.shape[0]
        if nd == 0 or na == 0:
            continue
        nd_pad = -(-nd // tile) * tile
        don = np.zeros(nd_pad, np.int32)
        don[:nd] = don_g.donors
        hcnt = np.zeros(nd_pad, np.int32)  # pad donors have 0 hydrogens
        htab = np.zeros((nd_pad, hmax), np.int32)
        hcnt[:nd] = tables.h_cnt[don_off : don_off + nd]
        htab[:nd] = tables.h_tab[don_off : don_off + nd]
        legs.append((pair_id, jnp.asarray(don), jnp.asarray(htab),
                     jnp.asarray(hcnt),
                     jnp.asarray(acc_g.acceptors.astype(np.int32)), nd_pad))

    def _min_image_dev(d, box):
        half = box * jnp.float32(0.5)
        for _ in range(4):
            d = jnp.where(d > half, d - box, d)
        for _ in range(4):
            d = jnp.where(d < -half, d + box, d)
        return d

    def _vector_to_dev(a, b, box):
        half = box * jnp.float32(0.5)
        x = b - a + half
        return jnp.fmod(jnp.fmod(x, box) + box, box) - half

    def count(pos, boxes):
        b = pos.shape[0]
        box = boxes[:, None, None, :]  # [B,1,1,3]
        out = jnp.zeros((b, n_pairs), jnp.int32)
        gout = jnp.zeros((b,), jnp.int32)
        for pair_id, don, htab, hcnt, acc, nd_pad in legs:
            ap = jnp.take(pos, acc, axis=1)  # [B,NA,3]

            def leg_tile(t, _pos=pos, _ap=ap, _don=don, _htab=htab,
                         _hcnt=hcnt):
                dsl = jax.lax.dynamic_slice_in_dim(_don, t * tile, tile)
                hsl = jax.lax.dynamic_slice_in_dim(_htab, t * tile, tile)
                csl = jax.lax.dynamic_slice_in_dim(_hcnt, t * tile, tile)
                dp = jnp.take(_pos, dsl, axis=1)  # [B,T,3]
                hp = jnp.take(
                    _pos, hsl.reshape(-1), axis=1
                ).reshape(b, tile, hmax, 3)
                d = _min_image_dev(dp[:, :, None, :] - _ap[:, None, :, :],
                                   box)
                dist = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2
                                + d[..., 2] ** 2)  # [B,T,NA]
                keep_d = ~(dist > maxd)
                # exclude the donor atom itself (hbonds.rs:253)
                pair_ok = dsl[None, :, None] != acc[None, None, :]
                keep_d &= pair_ok

                hd = _vector_to_dev(hp, dp[:, :, None, :], box)  # [B,T,H,3]
                ha = _vector_to_dev(hp[:, :, :, None, :],
                                    _ap[:, None, None, :, :],
                                    box[:, :, :, None, :])  # [B,T,H,NA,3]
                hdx = hd[:, :, :, None, :]
                # explicit left-fold mul-adds: the reference's exact f32
                # arithmetic (no dot_general, no reduced-precision default)
                dot = (hdx[..., 0] * ha[..., 0] + hdx[..., 1] * ha[..., 1]
                       + hdx[..., 2] * ha[..., 2])
                len_hd = jnp.sqrt(hd[..., 0] ** 2 + hd[..., 1] ** 2
                                  + hd[..., 2] ** 2)  # [B,T,H]
                len_ha = jnp.sqrt(ha[..., 0] ** 2 + ha[..., 1] ** 2
                                  + ha[..., 2] ** 2)  # [B,T,H,NA]
                cosang = dot / (len_hd[..., None] * len_ha)
                angle = jnp.degrees(jnp.arccos(cosang))
                nan = jnp.isnan(angle)
                # vector_to IS a minimum-image displacement, so |vector_to|
                # equals the min-image distance the reference's handle_nan
                # compares (hbonds.rs:321-338)
                ha_d = len_ha
                da_d = dist  # [B,T,NA]
                angle = jnp.where(
                    nan,
                    jnp.where(ha_d < da_d[:, :, None, :],
                              jnp.float32(180.0), jnp.float32(0.0)),
                    angle,
                )
                h_ok = (jnp.arange(hmax)[None, None, :, None]
                        < csl[None, :, None, None])
                keep = (keep_d[:, :, None, :] & h_ok & ~(angle < min_ang))
                cnt = jnp.sum(keep.astype(jnp.int32), axis=(1, 2, 3))
                if not with_guard:
                    return cnt
                # decision-boundary band: same formulas as the cells
                # kernel (_build_device_score) — a zero guard count means
                # no threshold decision was within backend-float reach
                cond = jnp.float32(57.29578) * _COS_EPS / jnp.sqrt(
                    jnp.maximum(1.0 - cosang * cosang, jnp.float32(1e-12)))
                guard = jnp.abs(angle - min_ang) < (_ANGLE_GUARD + cond)
                guard |= (jnp.abs(dist - maxd)
                          < maxd * _DIST_GUARD_REL)[:, :, None, :]
                guard |= nan & (jnp.abs(ha_d - da_d[:, :, None, :])
                                < (ha_d + da_d[:, :, None, :])
                                * _DIST_GUARD_REL)
                guard &= pair_ok[:, :, None, :] & h_ok
                return cnt, jnp.sum(guard.astype(jnp.int32), axis=(1, 2, 3))

            per_tile = jax.lax.map(leg_tile, jnp.arange(nd_pad // tile))
            if with_guard:
                out = out.at[:, pair_id].add(jnp.sum(per_tile[0], axis=0))
                gout = gout + jnp.sum(per_tile[1], axis=0)
            else:
                out = out.at[:, pair_id].add(jnp.sum(per_tile, axis=0))
        if with_guard:
            return out, gout
        return out

    return count


def remap_analysis(analysis: "HBondAnalysis", lut: np.ndarray) -> "HBondAnalysis":
    """Clone an HBondAnalysis with atom indices rewritten through `lut`
    (full-system index -> shipped-layout index), so candidate generation
    and scoring run directly on a gathered coordinate subset (the
    pipeline's ship="auto" fast path)."""
    import copy

    out = copy.copy(analysis)
    out._tables_cache = None  # tables hold atom indices; rebuild remapped
    out.chains = []
    for ch in analysis.chains:
        c2 = copy.copy(ch)
        c2.acceptors = lut[ch.acceptors]
        c2.donors = lut[ch.donors]
        c2.h_idx = lut[ch.h_idx]
        if ((c2.acceptors < 0).any() or (c2.donors < 0).any()
                or (c2.h_idx < 0).any()):
            raise HBondError(
                "shipped atom selection does not cover the hbond chains",
                code="InvalidSelection",
            )
        out.chains.append(c2)
    return out


class HBondsMixin:
    def hbonds_analyze_frame(self, chains, pairs, max_distance: float = 0.35,
                             min_angle: float = 120.0) -> dict:
        """Detect hydrogen bonds in the current frame."""
        analysis = HBondAnalysis(self, chains, pairs, max_distance, min_angle)
        return analysis.analyze(self)

    def hbonds_analyze(self, trajectory, chains, pairs, max_distance: float = 0.35,
                       min_angle: float = 120.0, **traj_kw):
        """Iterate a trajectory yielding (system, HBondMap) per frame
        (reference: HBondTrajRead::hbonds_analyze, hbonds.rs:457)."""
        analysis = HBondAnalysis(self, chains, pairs, max_distance, min_angle)
        from ..io.traj import traj_iter

        for frame in traj_iter(self, trajectory, **traj_kw):
            yield frame, analysis.analyze(frame)

    def hbonds_analyze_batched(self, trajectory, chains, pairs,
                               max_distance: float = 0.35,
                               min_angle: float = 120.0,
                               batch_size: int = 16,
                               counts_only: bool = False, **traj_kw):
        """Trajectory hydrogen-bond pass riding the batched device
        pipeline: frames decode in blocks and the distance/angle criteria
        evaluate as one masked kernel per `[B, n_cand]` batch — results
        equal `hbonds_analyze` exactly (see `HBondAnalysis.analyze_batch`).

        Yields `(time, HBondMap)` per frame — or `(time, {pair: count})`
        with `counts_only=True` (the fast path: no per-bond Python object
        construction).
        """
        analysis = HBondAnalysis(self, chains, pairs, max_distance, min_angle)
        from ..io.traj import traj_iter

        reader = traj_iter(self, trajectory, batch_size=batch_size, **traj_kw)
        for fb in reader.batches():
            pos = fb.positions
            boxes = fb.box_lengths()
            if counts_only:
                counts = analysis.analyze_batch(pos, boxes, counts_only=True)
                for i in range(pos.shape[0]):
                    yield float(fb.times[i]), {k: int(v[i])
                                               for k, v in counts.items()}
            else:
                for i, hmap in enumerate(analysis.analyze_batch(pos, boxes)):
                    yield float(fb.times[i]), hmap
