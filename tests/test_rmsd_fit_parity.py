"""RMSD fit parity (reference: rmsd.rs tests_fit, 901-1075)."""

import os

import numpy as np
import pytest

# numeric parity holds on the real chip too (backend matrix, SURVEY §4):
# GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity
pytestmark = pytest.mark.device_parity

from groan_rs_tpu.system import System


@pytest.fixture(scope="module")
def tpr(test_files):
    s = System.from_file(os.path.join(test_files, "example.tpr"))
    s.group_create("Protein", "@protein")
    return s


def _positions_wrap_equal(s1, s2, atol=1e-3):
    box = np.asarray(s1.box_lengths(), np.float64)
    d = np.abs(s1.positions.astype(np.float64) - s2.positions.astype(np.float64))
    d = np.minimum(d, np.abs(d - box))
    assert d.max() < atol


def test_fit_same_structure(tpr):
    """rmsd.rs:901 — fitting a copy onto itself: RMSD ~0, positions equal."""
    s = tpr.copy()
    ref = tpr.copy()
    rmsd = s.calc_rmsd_and_fit(ref, "Protein")
    assert rmsd == pytest.approx(0.0, abs=1e-4)
    _positions_wrap_equal(s, ref)


def test_fit_shifted_and_rotated_copy(tpr):
    """rmsd.rs:922 — translate + rotate 90deg about z, fit recovers the
    original positions with RMSD ~0."""
    from groan_rs_tpu.ops.vecmath import rotate

    s = tpr.copy()
    ref = tpr.copy()
    s.atoms_translate_nopbc([-1.1, 3.4, 2.7])
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    s.positions = np.asarray(rotate(s.positions, rot), np.float32)
    rmsd = s.calc_rmsd_and_fit(ref, "Protein")
    assert rmsd == pytest.approx(0.0, abs=1e-4)
    _positions_wrap_equal(s, ref)


def test_fit_trajectory_golden(tpr, test_files, tmp_path):
    """rmsd.rs:952 — the RMSD series matches exactly and the fitted
    trajectory matches short_trajectory_fit.xtc coordinates."""
    from groan_rs_tpu.io import native

    s = tpr.copy()
    ref = tpr.copy()
    out = tmp_path / "fit.xtc"
    s.traj_writer_init(str(out), fmt="xtc")
    rmsds = []
    for frame, r in s.xtc_iter(
        os.path.join(test_files, "short_trajectory.xtc")
    ).calc_rmsd_and_fit(ref, "Protein"):
        frame.traj_write_frame()
        rmsds.append(r)
    s.traj_writers_close()

    expected = [
        0.23669721, 0.2634763, 0.26021627, 0.21364464, 0.22166993, 0.19383307,
        0.26422343, 0.27013618, 0.26398134, 0.23475659, 0.24208021,
    ]
    np.testing.assert_allclose(rmsds, expected, atol=5e-5)

    # fitted coordinates vs the reference's golden fit trajectory: raw fit
    # differences are ~1e-5, but the golden is quantized at precision 100
    # (0.01 nm grid), so values within ~5e-3 of a rounding midpoint may flip
    # by exactly one step — require <1% flips and never more than one step
    golden = os.path.join(test_files, "short_trajectory_fit.xtc")
    go, _, _, gn = native.xtc_scan(golden)
    gc, *_ = native.xtc_read_frames(golden, go, gn)
    mo, _, _, mn = native.xtc_scan(str(out))
    mc, *_ = native.xtc_read_frames(str(out), mo, mn)
    assert mn == gn and len(mo) == len(go)
    d = np.abs(mc - gc)
    assert float(d.max()) <= 0.0101
    assert (d > 2e-3).mean() < 0.01


def test_fit_trajectory_broken_at_pbc(tpr, test_files, tmp_path):
    """rmsd.rs:1046 — a reference broken across the boundary still fits
    (the refined Bai-Breen COM keeps the group compact)."""
    s = tpr.copy()
    ref = tpr.copy()
    ref.atoms_translate([3.2, -2.1, -4.6])
    rmsds = []
    for _, r in s.xtc_iter(
        os.path.join(test_files, "short_trajectory.xtc")
    ).calc_rmsd_and_fit(ref, "Protein"):
        rmsds.append(r)
    expected = [
        0.23669721, 0.2634763, 0.26021627, 0.21364464, 0.22166993, 0.19383307,
        0.26422343, 0.27013618, 0.26398134, 0.23475659, 0.24208021,
    ]
    np.testing.assert_allclose(rmsds, expected, atol=1e-4)


def test_calc_rmsd_partial_extracted_reference(tpr):
    """reference: rmsd.rs test_calc_rmsd_partial — the reference system may
    be the extracted group alone."""
    s = tpr.copy()
    ref = s.group_extract("Protein")
    ref.group_create("Protein", "all")
    assert ref.get_n_atoms() == 61
    assert s.calc_rmsd(ref, "Protein") == pytest.approx(0.0, abs=1e-4)


def test_extract_semantics(tpr, test_files):
    """group_extract/atoms_extract build independent sub-systems with
    remapped bonds."""
    s = tpr.copy()
    sub = s.group_extract("Protein")
    assert sub.get_n_atoms() == 61
    assert sub.get_box().x == pytest.approx(s.get_box().x)
    # bonds are remapped into [0, 61)
    for i, b in enumerate(sub.topology.bonded):
        assert all(0 <= j < 61 for j in b)
    # independence
    sub.positions[0] = [0.0, 0.0, 0.0]
    assert not np.allclose(s.positions[s.group_indices("Protein")][0], 0.0)
    # atoms_extract copies everything without custom groups
    full = s.atoms_extract()
    assert full.get_n_atoms() == s.get_n_atoms()
    assert not full.group_exists("Protein")
    np.testing.assert_allclose(full.positions, s.positions)


# =====================================================================
# Kabsch unit parity (rmsd.rs test_kabsch_*): exact rotation/translation/
# rmsd values. Our rotation is the row-vector convention (pc @ r), the
# transpose of the reference's column-vector Matrix3.
# =====================================================================

def test_kabsch_rotation_and_translation_exact():
    """rmsd.rs test_kabsch_rotation_and_translation."""
    from groan_rs_tpu.ops.rmsd import kabsch

    p = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    q = np.array([[1.6666666, 2, 1], [0.6666666, 1, 1], [1.6666666, 1, 2]],
                 np.float32)
    w = np.ones(3, np.float32)
    r, t, rms = kabsch(p, q, w, np.float32([1 / 3] * 3), np.float32([4 / 3] * 3))
    expected_rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(np.asarray(r).T, expected_rot, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t), [1.0, 1.0, 1.0], atol=1e-6)
    assert float(rms) == pytest.approx(0.0, abs=1e-6)


def test_kabsch_nonzero_rmsd_exact():
    """rmsd.rs test_kabsch_nonzero_rmsd — full rotation matrix, translation
    and rmsd 4.471225."""
    from groan_rs_tpu.ops.rmsd import kabsch

    p = np.array([[4.3, 2.1, -5.2], [1.4, 2.1, 3.9], [2.4, -3.3, 1.8]], np.float32)
    q = np.array([[2.2, 0.0, 4.6], [-1.4, 0.2, 0.3], [1.3, 9.9, 11.3]], np.float32)
    w = np.ones(3, np.float32)
    r, t, rms = kabsch(p, q, w, np.float32([2.7, 0.3, 0.16666667]),
                       np.float32([0.7, 3.3666667, 5.4]))
    expected_rot = np.array([
        [0.8842437, -0.10340805, -0.45543456],
        [0.2840647, -0.65496445, 0.70023507],
        [-0.37070346, -0.7485511, -0.5497733],
    ])
    np.testing.assert_allclose(np.asarray(r).T, expected_rot, atol=2e-6)
    np.testing.assert_allclose(np.asarray(t), [-2.0, 3.066666, 5.233333], atol=1e-5)
    assert float(rms) == pytest.approx(4.471225, abs=1e-5)


def test_calc_rmsd_failure_modes(tpr, test_files):
    """rmsd.rs test_calc_rmsd_fail_* — missing/inconsistent/empty groups,
    no box, no mass."""
    from groan_rs_tpu.errors import GroanError

    s = tpr.copy()
    ref = tpr.copy()
    with pytest.raises(GroanError):
        s.calc_rmsd(ref, "Nonexistent")
    ref2 = tpr.copy()
    ref2.group_remove("Protein")
    with pytest.raises(GroanError):
        s.calc_rmsd(ref2, "Protein")
    # inconsistent group sizes
    ref3 = tpr.copy()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref3.group_create("Protein", "serial 1 to 10")
    with pytest.raises(GroanError):
        s.calc_rmsd(ref3, "Protein")
    # empty group
    s4 = tpr.copy()
    ref4 = tpr.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for t in (s4, ref4):
            t.group_create("Protein", "resname NON")
    with pytest.raises(GroanError):
        s4.calc_rmsd(ref4, "Protein")
    # no box
    s5 = tpr.copy()
    s5.set_box(None)
    with pytest.raises(GroanError):
        s5.calc_rmsd(tpr.copy(), "Protein")
