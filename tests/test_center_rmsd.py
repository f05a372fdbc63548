"""Unit tests for Bai-Breen centers and batched Kabsch RMSD."""

import numpy as np
import pytest

# numeric parity holds on the real chip too (backend matrix, SURVEY §4):
# GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity
pytestmark = pytest.mark.device_parity

from groan_rs_tpu.ops import center as center_ops
from groan_rs_tpu.ops import rmsd as rmsd_ops


def _random_cluster(rng, n, spread, offset):
    return (rng.normal(size=(n, 3)) * spread + offset).astype(np.float32)


def test_center_simple_cluster():
    rng = np.random.default_rng(0)
    box = np.array([10.0, 10.0, 10.0], np.float32)
    pts = _random_cluster(rng, 200, 0.5, [5.0, 5.0, 5.0])
    c = np.asarray(center_ops.center(pts, box))
    np.testing.assert_allclose(c, pts.mean(axis=0), atol=1e-4)


def test_center_broken_across_pbc():
    """A cluster straddling the boundary must produce the wrapped center."""
    rng = np.random.default_rng(1)
    box = np.array([10.0, 10.0, 10.0], np.float32)
    # cluster centered at origin corner, wrapped into the box
    raw = _random_cluster(rng, 500, 0.4, [0.0, 5.0, 5.0])
    wrapped = raw - box * np.floor(raw / box)
    c = np.asarray(center_ops.center(wrapped, box))
    # true center is ~ (0 or 10, 5, 5)
    assert min(abs(c[0]), abs(c[0] - 10.0)) < 0.05
    np.testing.assert_allclose(c[1:], [5.0, 5.0], atol=0.05)


def test_center_mass_weighted():
    box = np.array([10.0, 10.0, 10.0], np.float32)
    pts = np.array([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0]], np.float32)
    m = np.array([1.0, 3.0], np.float32)
    c = np.asarray(center_ops.center(pts, box, weights=m))
    np.testing.assert_allclose(c, [2.5, 1.0, 1.0], atol=1e-5)


def test_center_masked():
    box = np.array([10.0, 10.0, 10.0], np.float32)
    pts = np.array([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0], [9.0, 9.0, 9.0]], np.float32)
    mask = np.array([True, True, False])
    c = np.asarray(center_ops.center(pts, box, mask=mask))
    np.testing.assert_allclose(c, [2.0, 1.0, 1.0], atol=1e-5)


def test_estimate_center_empty_is_nan():
    box = np.array([10.0, 10.0, 10.0], np.float32)
    pts = np.zeros((5, 3), np.float32)
    mask = np.zeros(5, bool)
    c = np.asarray(center_ops.estimate_center(pts, box, mask=mask))
    assert np.isnan(c).all()


def test_center_batched_frames():
    rng = np.random.default_rng(2)
    box = np.array([10.0, 10.0, 10.0], np.float32)
    frames = _random_cluster(rng, 50, 0.3, [4.0, 4.0, 4.0]).reshape(1, 50, 3) + \
        np.arange(3, dtype=np.float32).reshape(3, 1, 1) * 0.5
    c = np.asarray(center_ops.center(frames, box))
    assert c.shape == (3, 3)
    for b in range(3):
        np.testing.assert_allclose(c[b], frames[b].mean(axis=0), atol=1e-4)


def _rotation_matrix(axis, angle):
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    a = np.cos(angle / 2)
    b, c, d = -axis * np.sin(angle / 2)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    )


def test_kabsch_recovers_rotation():
    rng = np.random.default_rng(3)
    n = 40
    p = rng.normal(size=(n, 3)).astype(np.float32)
    rot = _rotation_matrix([1.0, 2.0, 0.5], 0.7)
    q = (p @ rot.T).astype(np.float32)
    w = np.ones(n, np.float32)
    r, t, rms = rmsd_ops.kabsch(p, q, w, p.mean(0), q.mean(0))
    assert float(rms) == pytest.approx(0.0, abs=1e-4)


def test_kabsch_known_rmsd():
    # points differing by a fixed displacement after optimal alignment
    p = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    q = p.copy()
    q[0] += np.float32(0.2)  # perturb one point
    w = np.ones(4, np.float32)
    _, _, rms = rmsd_ops.kabsch(p, q, w, p.mean(0), q.mean(0))
    assert 0.0 < float(rms) < 0.2


def test_kabsch_batched():
    rng = np.random.default_rng(4)
    n, b = 30, 5
    p = rng.normal(size=(n, 3)).astype(np.float32)
    qs = []
    for i in range(b):
        rot = _rotation_matrix([0.3, 1.0, 0.2], 0.1 * i)
        qs.append(p @ rot.T + rng.normal(size=(n, 3)) * 0.01)
    q = np.stack(qs).astype(np.float32)
    w = np.ones(n, np.float32)
    r, t, rms = rmsd_ops.kabsch(
        np.broadcast_to(p, (b, n, 3)), q, w,
        np.broadcast_to(p.mean(0), (b, 3)), q.mean(axis=1),
    )
    assert np.asarray(rms).shape == (b,)
    assert (np.asarray(rms) < 0.05).all()


def test_kabsch_reflection_guard():
    """Mirror images must NOT be aligned by an improper rotation."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(20, 3)).astype(np.float32)
    q = p.copy()
    q[:, 0] *= -1  # reflect
    w = np.ones(20, np.float32)
    r, _, rms = rmsd_ops.kabsch(p, q, w, p.mean(0), q.mean(0))
    det = np.linalg.det(np.asarray(r))
    assert det == pytest.approx(1.0, abs=1e-4)
    assert float(rms) > 0.1


def test_center_batched_box_shapes():
    """Regression: box with an atom axis ([B,1,3]) must NOT broadcast a new
    batch axis — center(pos[B,N,3], box[B,1,3]).shape == (B, 3)."""
    from groan_rs_tpu.ops.center import center, estimate_center

    rng = np.random.default_rng(11)
    B, N = 4, 7
    box = np.array([5.0, 6.0, 7.0], np.float32)
    pos = (rng.random((B, N, 3)) * box).astype(np.float32)
    boxes = np.broadcast_to(box, (B, 3)).copy()

    for fn in (center, estimate_center):
        out_b = np.asarray(fn(pos, boxes[:, None, :]))
        assert out_b.shape == (B, 3)
        out_s = np.asarray(fn(pos, box))
        assert out_s.shape == (B, 3)
        np.testing.assert_allclose(out_b, out_s, atol=1e-6)
    # weights + mask combinations keep the shape
    w = rng.random(N).astype(np.float32)
    m = np.ones(N, bool)
    out = np.asarray(center(pos, boxes[:, None, :], mask=m, weights=w))
    assert out.shape == (B, 3)
