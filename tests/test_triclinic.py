"""Exact triclinic PBC end-to-end (surpass feature; the reference reads
triclinic boxes but its PBC math is orthogonal-only, src/lib.rs:353-355).

Fixtures: dodecahedron/octahedron/triclinic trajectories from the reference
corpus (test_files/dodecahedron_trajectory.xtc etc., BASELINE config 3).
Verification is against brute-force 125-image float64 math.
"""

import os

import numpy as np
import pytest

# numeric parity holds on the real chip too (backend matrix, SURVEY §4):
# GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity
pytestmark = pytest.mark.device_parity

from groan_rs_tpu.io.traj import open_source
from groan_rs_tpu.ops.pbc import (
    distance_triclinic_frames,
    min_image_triclinic_frames,
    wrap_triclinic_frames,
)
from groan_rs_tpu.ops.center import center_triclinic

FIXTURES = [
    "dodecahedron_trajectory.xtc",
    "octahedron_trajectory.xtc",
    "triclinic_trajectory.xtc",
]

_SHIFTS5 = np.array(
    [[i, j, k] for i in range(-2, 3) for j in range(-2, 3) for k in range(-2, 3)],
    np.float64,
)


def _brute_min_norm2(d, h):
    """Exhaustive 125-image minimum squared displacement (float64), after
    reducing `d` into the primary cell (a fixed +/-2 window around an
    unreduced far-away displacement would miss the global minimum)."""
    s = d @ np.linalg.inv(h)
    d0 = d - np.round(s) @ h
    cand = d0[None, :] + _SHIFTS5 @ h
    return (cand * cand).sum(1).min()


def _load(test_files, name):
    src = open_source(os.path.join(test_files, name))
    fb = src.read_batch(np.arange(src.n_frames()))
    return fb


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_boxes_are_triclinic(test_files, name):
    fb = _load(test_files, name)
    h = fb.box_matrices()
    off = np.abs(h[:, 2, :2]).sum() + np.abs(h[:, 1, 0]).sum()
    assert off > 0.0, "fixture should have non-orthogonal box"


@pytest.mark.parametrize("name", FIXTURES)
def test_min_image_triclinic_vs_bruteforce(test_files, name):
    fb = _load(test_files, name)
    h = fb.box_matrices()
    B = h.shape[0]
    rng = np.random.default_rng(7)
    d = rng.uniform(-9.0, 9.0, size=(B, 24, 3)).astype(np.float32)
    out = np.asarray(min_image_triclinic_frames(d, h))
    for b in range(B):
        h64 = h[b].astype(np.float64)
        for k in range(d.shape[1]):
            ref2 = _brute_min_norm2(d[b, k].astype(np.float64), h64)
            got2 = float((out[b, k].astype(np.float64) ** 2).sum())
            assert got2 == pytest.approx(ref2, rel=2e-4, abs=1e-6)


@pytest.mark.parametrize("name", FIXTURES)
def test_wrap_triclinic_fixture_frames(test_files, name):
    fb = _load(test_files, name)
    h = fb.box_matrices()
    wrapped = np.asarray(wrap_triclinic_frames(fb.positions, h))
    # fractional coordinates of the wrapped points must be in [0, 1)
    for b in range(h.shape[0]):
        s = wrapped[b].astype(np.float64) @ np.linalg.inv(h[b].astype(np.float64))
        assert s.min() >= -1e-5 and s.max() <= 1.0 + 1e-5
    # wrapping must not change minimum-image geometry: the distance between
    # two atoms is invariant
    a = fb.positions
    d0 = np.asarray(distance_triclinic_frames(a[:, 0], a[:, 5], h))
    d1 = np.asarray(distance_triclinic_frames(wrapped[:, 0], wrapped[:, 5], h))
    np.testing.assert_allclose(d0, d1, atol=2e-4)


def test_center_triclinic_recovers_blob_center(test_files):
    """A compact blob scattered across the periodic boundary must still
    yield its true center (modulo the lattice)."""
    fb = _load(test_files, "dodecahedron_trajectory.xtc")
    h = fb.box_matrices()[:4]
    rng = np.random.default_rng(3)
    B, N = h.shape[0], 200
    # true centers: random points inside each cell
    frac = rng.uniform(0, 1, size=(B, 3)).astype(np.float32)
    true_c = np.einsum("bi,bij->bj", frac, h)
    pts = true_c[:, None, :] + rng.normal(size=(B, N, 3)).astype(np.float32) * 0.4
    wrapped = np.asarray(wrap_triclinic_frames(pts, h))
    got = np.asarray(center_triclinic(wrapped, h))
    # exact check: the float64 mean of the ORIGINAL (unwrapped) points must
    # be recovered modulo the lattice
    true_mean = pts.astype(np.float64).mean(axis=1).astype(np.float32)
    resid = np.asarray(min_image_triclinic_frames(got - true_mean, h))
    assert np.abs(resid).max() < 1e-3

    # weighted: doubling one side's weights moves the center predictably
    w = np.ones(N, np.float32)
    got_w = np.asarray(center_triclinic(wrapped, h, weights=w))
    np.testing.assert_allclose(got_w, got, atol=1e-5)


def test_distance_triclinic_two_blobs(test_files):
    fb = _load(test_files, "octahedron_trajectory.xtc")
    h = fb.box_matrices()[:3]
    rng = np.random.default_rng(5)
    B, N = h.shape[0], 64
    f1 = rng.uniform(0, 1, size=(B, 3)).astype(np.float32)
    f2 = rng.uniform(0, 1, size=(B, 3)).astype(np.float32)
    c1 = np.einsum("bi,bij->bj", f1, h)
    c2 = np.einsum("bi,bij->bj", f2, h)
    blob1 = c1[:, None, :] + rng.normal(size=(B, N, 3)).astype(np.float32) * 0.1
    blob2 = c2[:, None, :] + rng.normal(size=(B, N, 3)).astype(np.float32) * 0.1
    w1 = np.asarray(wrap_triclinic_frames(blob1, h))
    w2 = np.asarray(wrap_triclinic_frames(blob2, h))
    g1 = np.asarray(center_triclinic(w1, h))
    g2 = np.asarray(center_triclinic(w2, h))
    got = np.asarray(distance_triclinic_frames(g1, g2, h))
    for b in range(B):
        ref = np.sqrt(
            _brute_min_norm2((c1[b] - c2[b]).astype(np.float64), h[b].astype(np.float64))
        )
        assert got[b] == pytest.approx(ref, abs=5e-2)


def test_pipeline_triclinic_end_to_end(test_files):
    """TrajectoryAnalysis(triclinic=True) over the dodecahedron fixture:
    per-frame center/distance parity vs direct kernel calls."""
    from groan_rs_tpu.models import TrajectoryAnalysis
    from groan_rs_tpu.system import System

    s = System.from_file(os.path.join(test_files, "dodecahedron.gro"))
    s.group_create("FirstHalf", "serial 1 to 25")
    s.group_create("SecondHalf", "serial 26 to 50")
    xtc = os.path.join(test_files, "dodecahedron_trajectory.xtc")

    pipe = (
        TrajectoryAnalysis(s, triclinic=True)
        .add_center("FirstHalf")
        .add_distance("FirstHalf", "SecondHalf")
    )
    out = pipe.run(xtc, batch_size=4)
    nf = out["center_FirstHalf"].shape[0]
    assert nf == out["distance_FirstHalf_SecondHalf"].shape[0] > 0

    # parity vs direct kernels on the raw batch
    fb = _load(test_files, "dodecahedron_trajectory.xtc")
    h = fb.box_matrices()
    i1 = s.group_indices("FirstHalf")
    i2 = s.group_indices("SecondHalf")
    c1 = np.asarray(center_triclinic(fb.positions[:, i1], h))
    c2 = np.asarray(center_triclinic(fb.positions[:, i2], h))
    d = np.asarray(distance_triclinic_frames(c1, c2, h))
    np.testing.assert_allclose(out["center_FirstHalf"], c1, atol=1e-5)
    np.testing.assert_allclose(out["distance_FirstHalf_SecondHalf"], d, atol=1e-5)
    assert np.isfinite(out["center_FirstHalf"]).all()


def test_rmsd_triclinic_self_is_zero(test_files):
    """Self-RMSD through the triclinic path must be ~0 even with the group
    scattered across the periodic boundary."""
    from groan_rs_tpu.ops import rmsd as rmsd_ops

    fb = _load(test_files, "triclinic_trajectory.xtc")
    h = fb.box_matrices()
    p0 = fb.positions[0]
    w = np.ones(p0.shape[0], np.float32)
    ref_prep, ref_centroid = rmsd_ops.prepare_coords_triclinic(p0, h[0], weights=w)
    _, rms = rmsd_ops.rmsd_frames_triclinic(
        np.asarray(ref_prep), np.asarray(ref_centroid),
        fb.positions[:1], h[:1], w,
    )
    assert float(np.asarray(rms)[0]) < 1e-4
    # and across real frames the RMSD is finite and modest
    _, rms_all = rmsd_ops.rmsd_frames_triclinic(
        np.asarray(ref_prep), np.asarray(ref_centroid), fb.positions, h, w
    )
    rms_all = np.asarray(rms_all)
    assert np.isfinite(rms_all).all() and (rms_all < 5.0).all()


def test_system_triclinic_methods(test_files):
    """System-level triclinic analysis on the dodecahedron structure:
    centers/distances verified against the frame-batched kernels."""
    from groan_rs_tpu.system import System

    s = System.from_file(os.path.join(test_files, "dodecahedron.gro"))
    s.group_create("A", "serial 1 to 25")
    s.group_create("B", "serial 26 to 50")
    h = np.asarray(s.get_box().to_matrix(), np.float32)

    ca = s.group_get_center_triclinic("A")
    cb = s.group_get_center_triclinic("B")
    ca_k = np.asarray(center_triclinic(s.positions[s.group_indices("A")], h))
    np.testing.assert_allclose(ca, ca_k, atol=1e-6)

    d = s.group_distance_triclinic("A", "B")
    dk = float(np.asarray(distance_triclinic_frames(
        ca[None, :], cb[None, :], h[None])).reshape(-1)[0])
    assert d == pytest.approx(dk, abs=1e-5)

    d01 = s.atoms_distance_triclinic(0, 5)
    brute = np.sqrt(_brute_min_norm2(
        (s.positions[0] - s.positions[5]).astype(np.float64), h.astype(np.float64)))
    assert d01 == pytest.approx(brute, abs=1e-4)


def test_xtc_magic_2023_decode(test_files, tmp_path):
    """The large-frame magic-2023 variant (64-bit payload size) decodes
    bit-identically to the same data framed as magic 1995
    (changelog.md:8; molly_xtc.rs:95-104)."""
    import struct

    from groan_rs_tpu.io import native

    src = os.path.join(test_files, "short_trajectory.xtc")
    data = open(src, "rb").read()
    out = bytearray()
    off = 0
    while off < len(data):
        natoms = struct.unpack_from(">i", data, off + 4)[0]
        assert natoms > 9
        hdr = bytearray(data[off:off + 56])
        struct.pack_into(">i", hdr, 0, 2023)
        out += hdr
        out += data[off + 56:off + 88]  # precision, minint, maxint, smallidx
        nbytes = struct.unpack_from(">i", data, off + 88)[0]
        out += struct.pack(">q", nbytes)
        padded = (nbytes + 3) & ~3
        out += data[off + 92:off + 92 + padded]
        off += 92 + padded

    p2023 = tmp_path / "traj2023.xtc"
    p2023.write_bytes(bytes(out))

    o1, s1, t1, n1 = native.xtc_scan(src)
    o2, s2, t2, n2 = native.xtc_scan(str(p2023))
    assert n1 == n2 and len(o1) == len(o2)
    np.testing.assert_array_equal(s1, s2)
    c1, *_ = native.xtc_read_frames(src, o1, n1)
    c2, *_ = native.xtc_read_frames(str(p2023), o2, n2)
    np.testing.assert_array_equal(c1, c2)
    # the q16 path handles 2023 too
    q2, *_ = native.xtc_read_frames_q16(str(p2023), o2, n2)
    assert q2.dtype == np.int16
