"""Pair reductions (`ops.distances.min_distance` / `contact_count`) and
the Bai-Breen centers of `ops.center`, against float64 numpy."""

import numpy as np
import pytest

# numeric parity holds on the GPU too (backend matrix, SURVEY §4):
# GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity
pytestmark = pytest.mark.device_parity

from groan_rs_tpu.ops import distances


def _ref_pairs(a, b, box):
    """Float64 minimum-image distances [..., N, M]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    box = np.asarray(box, np.float64)[..., None, None, :]
    d = a[..., :, None, :] - b[..., None, :, :]
    d -= box * np.round(d / box)
    return np.sqrt((d * d).sum(-1))


def _sets(seed, n, m, frames=None, box=(5.0, 6.0, 7.0)):
    rng = np.random.default_rng(seed)
    box = np.asarray(box, np.float32)
    lead = () if frames is None else (frames,)
    a = (rng.random(lead + (n, 3)) * box).astype(np.float32)
    b = (rng.random(lead + (m, 3)) * box).astype(np.float32)
    return a, b, box


@pytest.mark.parametrize("n,m", [(1, 1), (7, 300), (257, 129), (300, 500)])
def test_min_distance_matches_float64(n, m):
    a, b, box = _sets(0, n, m)
    got = float(distances.min_distance(a, b, box))
    assert got == pytest.approx(_ref_pairs(a, b, box).min(), abs=1e-5)


@pytest.mark.parametrize("cutoff", [0.2, 0.5, 1.0])
def test_contact_count_matches_float64(cutoff):
    """Equal to the float64 count except for pairs within 1e-5 nm of the
    cutoff, where float32 may decide either way."""
    a, b, box = _sets(1, 300, 500)
    d = _ref_pairs(a, b, box)
    got = int(distances.contact_count(a, b, box, cutoff))
    assert int((d < cutoff - 1e-5).sum()) <= got <= int(
        (d < cutoff + 1e-5).sum())


def test_pbc_across_boundary():
    """Pairs split across the periodic boundary are nearest images."""
    box = np.array([5.0, 6.0, 7.0], np.float32)
    a = np.array([[0.05, 0.05, 0.05]], np.float32)
    b = np.array([[4.95, 5.95, 6.95]], np.float32)
    assert float(distances.min_distance(a, b, box)) == pytest.approx(
        np.sqrt(3 * 0.1 ** 2), abs=1e-5)
    assert int(distances.contact_count(a, b, box, 0.2)) == 1
    assert int(distances.contact_count(a, b, box, 0.17)) == 0


@pytest.mark.parametrize("which", ["a", "b", "both"])
def test_masked_calls(which):
    a, b, box = _sets(2, 40, 50)
    ma = np.ones(40, bool)
    mb = np.ones(50, bool)
    if which in ("a", "both"):
        ma[::3] = False
    if which in ("b", "both"):
        mb[1::4] = False
    d = _ref_pairs(a, b, box)
    d[~ma] = np.inf
    d[:, ~mb] = np.inf
    kw = {"mask_a": ma if which != "b" else None,
          "mask_b": mb if which != "a" else None}
    assert float(distances.min_distance(a, b, box, **kw)) == pytest.approx(
        d.min(), abs=1e-5)
    assert int(distances.contact_count(a, b, box, 1.0, **kw)) == int(
        (d < 1.0).sum())


def test_fully_masked_is_inf_and_zero():
    a, b, box = _sets(3, 10, 12)
    none = np.zeros(10, bool)
    assert np.isinf(float(distances.min_distance(a, b, box, mask_a=none)))
    assert int(distances.contact_count(a, b, box, 5.0, mask_a=none)) == 0


@pytest.mark.parametrize("chunk_elems", [1, 64, 1000, 1 << 20])
def test_chunk_boundaries_do_not_change_results(chunk_elems):
    """Row chunks (with a padded last chunk) reduce to the same answer
    as a single chunk."""
    a, b, box = _sets(4, 53, 37, frames=3)
    boxes = np.broadcast_to(box, (3, 3))
    whole_min = np.asarray(distances._pair_reduce(
        a, b, boxes, None, None, None, 1 << 30))
    whole_cnt = np.asarray(distances._pair_reduce(
        a, b, boxes, 1.0, None, None, 1 << 30))
    got_min = np.asarray(distances._pair_reduce(
        a, b, boxes, None, None, None, chunk_elems))
    got_cnt = np.asarray(distances._pair_reduce(
        a, b, boxes, 1.0, None, None, chunk_elems))
    np.testing.assert_array_equal(got_min, whole_min)
    np.testing.assert_array_equal(got_cnt, whole_cnt)
    d = _ref_pairs(a, b, boxes)
    np.testing.assert_allclose(np.sqrt(got_min), d.min(axis=(1, 2)),
                               atol=1e-5)


def test_batched_shapes_and_per_frame_boxes():
    """[B, 1, 3] per-atom broadcast boxes give [B] results, one box per
    frame; an unbatched call gives a scalar."""
    rng = np.random.default_rng(21)
    B, N, M = 2, 321, 517
    box = rng.uniform(4.0, 6.0, size=(B, 3)).astype(np.float32)
    a = rng.uniform(0, 4, (B, N, 3)).astype(np.float32)
    b = rng.uniform(0, 4, (B, M, 3)).astype(np.float32)
    got = np.asarray(distances.min_distance(a, b, box[:, None, :]))
    assert got.shape == (B,)
    np.testing.assert_allclose(got, _ref_pairs(a, b, box).min(axis=(1, 2)),
                               atol=1e-5)
    cnt = np.asarray(distances.contact_count(a, b, box[:, None, :], 0.6))
    assert cnt.shape == (B,) and cnt.dtype == np.int32
    assert np.asarray(distances.min_distance(a[0], b[0], box[0])).shape == ()


def test_pipeline_pair_observables_match_float64():
    """`add_min_distance` / `add_contacts` through the runner equal the
    float64 reference on each frame."""
    import jax.numpy as jnp

    from groan_rs_tpu import synthetic
    from groan_rs_tpu.models import TrajectoryAnalysis

    box = np.full(3, 4.0, np.float32)
    frames = (np.random.default_rng(5).random((3, 240, 3)) * box).astype(
        np.float32)
    system, _ = synthetic.build_system(240, frames[0], box)
    system.group_create_from_ranges("A", [(0, 99)])
    system.group_create_from_ranges("B", [(100, 239)])
    step = (TrajectoryAnalysis(system)
            .add_min_distance("A", "B", name="mind")
            .add_contacts("A", "B", 0.8, name="cont")
            .step_fn())
    boxes = np.broadcast_to(box, (3, 3)).astype(np.float32)
    out = step(jnp.asarray(frames), jnp.asarray(boxes),
               jnp.ones(3, bool))
    d = _ref_pairs(frames[:, :100], frames[:, 100:], boxes)
    np.testing.assert_allclose(np.asarray(out["mind"]), d.min(axis=(1, 2)),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out["cont"]),
                                  (d < 0.8).sum(axis=(1, 2)))


# ------------------------------------------------ Bai-Breen vs float64


def _ref_estimate(p, box, w):
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    theta = np.mod(p, box) * (2 * np.pi / box)
    xi = (w[:, None] * np.cos(theta)).sum(0)
    zeta = (w[:, None] * np.sin(theta)).sum(0)
    return (np.arctan2(-zeta, -xi) + np.pi) * box / (2 * np.pi)


@pytest.fixture(scope="module")
def blob():
    """A compact 300-atom group wrapped across a 5 x 6 x 7 box corner."""
    rng = np.random.default_rng(0)
    box = np.array([5.0, 6.0, 7.0], np.float32)
    p = (rng.normal(size=(300, 3)) * 0.6).astype(np.float32) % box
    return p, box


def test_bai_breen_estimate_masked(blob):
    from groan_rs_tpu.ops.center import estimate_center

    p, box = blob
    w = np.ones(len(p))
    w[::5] = 0.0
    got = np.asarray(estimate_center(p, box, mask=w > 0))
    np.testing.assert_allclose(got, _ref_estimate(p, box, w), atol=1e-4)


def test_bai_breen_estimate_weighted(blob):
    from groan_rs_tpu.ops.center import estimate_center

    p, box = blob
    w = np.random.default_rng(9).uniform(1.0, 16.0, len(p)).astype(
        np.float32)
    got = np.asarray(estimate_center(p, box, weights=w))
    np.testing.assert_allclose(got, _ref_estimate(p, box, w), atol=1e-4)


def test_bai_breen_refined_center(blob):
    """Refined center = geometric estimate, unwrap, weighted mean, with
    masked atoms excluded from both."""
    from groan_rs_tpu.ops.center import center
    from groan_rs_tpu.synthetic import host_refined_center

    p, box = blob
    w = np.random.default_rng(11).uniform(1.0, 16.0, len(p)).astype(
        np.float32)
    keep = np.ones(len(p), bool)
    keep[::9] = False
    got = np.asarray(center(p, box, mask=keep, weights=w))
    want = host_refined_center(p[keep], box, w[keep])
    np.testing.assert_allclose(got, want, atol=2e-4)
