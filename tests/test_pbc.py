"""Parity tests for PBC kernels vs reference doctest values
(src/structures/vector3d.rs doc examples)."""

import numpy as np
import pytest

# numeric parity holds on the real chip too (backend matrix, SURVEY §4):
# GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity
pytestmark = pytest.mark.device_parity

from groan_rs_tpu.core.dimension import Dimension
from groan_rs_tpu.core.simbox import SimBox
from groan_rs_tpu.ops import pbc


def test_wrap_doc_values():
    # vector3d.rs wrap doctest: point (-0.5, 2.0, 4.2) in box 4x4x4
    out = np.asarray(pbc.wrap(np.array([-0.5, 2.0, 4.2], np.float32), np.full(3, 4.0, np.float32)))
    np.testing.assert_allclose(out, [3.5, 2.0, 0.2], atol=1e-5)


def test_wrap_boundary_semantics():
    box = np.full(3, 4.0, np.float32)
    # loop semantics: exactly L stays L; 0 stays 0; 2L -> L; -L -> 0
    pts = np.array([[4.0, 0.0, 8.0], [-4.0, -0.5, 4.5]], np.float32)
    out = np.asarray(pbc.wrap(pts, box))
    np.testing.assert_allclose(out[0], [4.0, 0.0, 4.0], atol=1e-6)
    np.testing.assert_allclose(out[1], [0.0, 3.5, 0.5], atol=1e-6)


def test_min_image_boundaries():
    out = np.asarray(pbc.min_image(np.array([2.0, -2.0, 6.0, -6.0, 1.9, -1.9], np.float32), np.float32(4.0)))
    np.testing.assert_allclose(out, [2.0, -2.0, 2.0, -2.0, 1.9, -1.9], atol=1e-6)


def test_distance_doc_values():
    p1 = np.array([1.0, 2.0, 3.0], np.float32)
    p2 = np.array([3.5, 1.0, 2.0], np.float32)
    box = np.full(3, 4.0, np.float32)
    d_xy = float(pbc.distance(p1, p2, box, Dimension.XY.value))
    assert d_xy == pytest.approx(1.802776, abs=1e-5)
    d_x = float(pbc.distance(p1, p2, box, Dimension.X.value))
    assert d_x == pytest.approx(1.5, abs=1e-5)
    d_x_rev = float(pbc.distance(p2, p1, box, Dimension.X.value))
    assert d_x_rev == pytest.approx(-1.5, abs=1e-5)


def test_distance_naive_doc_values():
    p1 = np.array([1.0, 2.0, 3.0], np.float32)
    p2 = np.array([3.5, 1.0, 2.0], np.float32)
    assert float(pbc.distance_naive(p1, p2, Dimension.XY.value)) == pytest.approx(2.692582, abs=1e-5)
    assert float(pbc.distance_naive(p1, p2, Dimension.X.value)) == pytest.approx(-2.5, abs=1e-5)
    assert float(pbc.distance_naive(p2, p1, Dimension.X.value)) == pytest.approx(2.5, abs=1e-5)


def test_vector_to_doc_values():
    p1 = np.array([1.0, 2.0, 3.0], np.float32)
    p2 = np.array([3.0, 2.0, 1.0], np.float32)
    box = np.array([3.5, 5.0, 5.0], np.float32)
    v = np.asarray(pbc.vector_to(p1, p2, box))
    np.testing.assert_allclose(v, [-1.5, 0.0, -2.0], atol=1e-5)


def test_batched_shapes():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 15, size=(4, 100, 3)).astype(np.float32)
    box = np.array([10.0, 12.0, 9.0], np.float32)
    w = np.asarray(pbc.wrap(pts, box))
    assert w.shape == pts.shape
    assert (w >= 0).all() and (w <= box + 1e-5).all()


def test_triclinic_min_image_matches_ortho_on_ortho_box():
    rng = np.random.default_rng(1)
    d = rng.uniform(-20, 20, size=(50, 3)).astype(np.float32)
    box = np.array([10.0, 12.0, 9.0], np.float32)
    h = np.diag(box)
    ortho = np.asarray(pbc.min_image(d, box))
    tric = np.asarray(pbc.min_image_triclinic(d, h))
    # magnitudes must agree (signs may differ on exact half-box boundaries)
    np.testing.assert_allclose(np.abs(ortho), np.abs(tric), atol=1e-4)


def test_triclinic_min_image_brute_force():
    """Exact triclinic minimum image vs brute force over many images."""
    rng = np.random.default_rng(2)
    sb = SimBox.from_lengths_angles(6.0, 6.0, 6.0, 60.0, 60.0, 90.0)
    h = sb.to_matrix().astype(np.float64)
    d = rng.uniform(-10, 10, size=(40, 3))
    got = np.asarray(pbc.min_image_triclinic(d.astype(np.float32), h.astype(np.float32)))
    shifts = np.array([[i, j, k] for i in range(-3, 4) for j in range(-3, 4) for k in range(-3, 4)])
    imgs = d[:, None, :] + shifts @ h  # [N, S, 3]
    best = np.min(np.linalg.norm(imgs, axis=-1), axis=1)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), best, atol=1e-3)


def test_simbox_lengths_angles_roundtrip():
    sb = SimBox.from_lengths_angles(7.0, 8.0, 9.0, 70.0, 80.0, 95.0)
    np.testing.assert_allclose(sb.lengths(), [7.0, 8.0, 9.0], atol=1e-4)
    np.testing.assert_allclose(sb.angles(), [70.0, 80.0, 95.0], atol=1e-3)
    assert not sb.is_orthogonal()
    sb2 = SimBox.from_lengths(4.0, 4.0, 4.0)
    assert sb2.is_orthogonal() and sb2.is_valid()
