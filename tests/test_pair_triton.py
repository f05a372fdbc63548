"""The Triton pair-reduction kernel (`ops.pair_triton`): in the Pallas
interpreter against the plain reduction and float64 here, compiled for
the card where there is one, and the routing in `ops.distances`."""

import numpy as np
import pytest

from groan_rs_tpu.ops import distances, pair_triton

pytestmark = pytest.mark.device_parity


def _sets(seed, frames, n, m, box=(5.0, 6.0, 7.0)):
    rng = np.random.default_rng(seed)
    box = np.broadcast_to(np.asarray(box, np.float32), (frames, 3)).copy()
    a = (rng.random((frames, n, 3)) * box[:, None]).astype(np.float32)
    b = (rng.random((frames, m, 3)) * box[:, None]).astype(np.float32)
    return a, b, box


def _ref(a, b, box, cut2):
    d = a[:, :, None, :].astype(np.float64) - b[:, None, :, :]
    bx = box[:, None, None, :].astype(np.float64)
    d -= bx * np.round(d / bx)
    d2 = (d * d).sum(-1)
    return d2.min(axis=(1, 2)) if cut2 is None else (d2 < cut2).sum(
        axis=(1, 2))


def _plain(a, b, box, cut2):
    return np.asarray(distances._pair_reduce(a, b, box, cut2, None, None,
                                             distances._PAIR_CHUNK_ELEMS))


CUT2 = float(np.float32(0.8) * np.float32(0.8))


@pytest.mark.parametrize("n,m,tile_n,tile_m", [
    (1, 1, 16, 16), (17, 33, 16, 16), (64, 128, 32, 64), (70, 300, 32, 128)])
@pytest.mark.parametrize("cut2", [None, CUT2], ids=["min", "count"])
def test_interpret_matches_plain_at_odd_sizes(n, m, tile_n, tile_m, cut2):
    """Padded rows and the masked last column block leave the result
    bit-equal to the plain reduction (same arithmetic)."""
    a, b, box = _sets(n * 7 + m, 2, n, m)
    got = np.asarray(pair_triton.pair_reduce(
        a, b, box, cut2, tile_n=tile_n, tile_m=tile_m, interpret=True))
    np.testing.assert_array_equal(got, _plain(a, b, box, cut2))
    if cut2 is None:
        np.testing.assert_allclose(got, _ref(a, b, box, None), atol=1e-5)


def test_interpret_per_frame_boxes_and_boundary():
    """Each frame uses its own box; pairs across the boundary are nearest
    images."""
    box = np.array([[5.0, 6.0, 7.0], [3.0, 3.0, 3.0]], np.float32)
    a = np.array([[[0.05, 0.05, 0.05]], [[0.05, 0.05, 0.05]]], np.float32)
    b = np.array([[[4.95, 5.95, 6.95]], [[2.95, 2.95, 2.95]]], np.float32)
    got = np.asarray(pair_triton.pair_reduce(a, b, box, None, tile_n=16,
                                             tile_m=16, interpret=True))
    np.testing.assert_allclose(np.sqrt(got), [np.sqrt(0.03)] * 2, atol=1e-5)


def test_routing_matches_plain_and_skips_kernel_when_masked(monkeypatch):
    """An unmasked reduction equals the plain one (the kernel on a GPU,
    the plain branch elsewhere); with masks, or with an explicit row
    chunking, the kernel is never traced."""
    a, b, box = _sets(3, 2, 40, 50)
    want = _plain(a, b, box, None)
    got = np.asarray(distances.min_distance(a, b, box[:, None, :]))
    np.testing.assert_allclose(got, np.sqrt(want), rtol=1e-6)

    def boom(*args, **kw):
        raise AssertionError("kernel traced")

    monkeypatch.setattr(pair_triton, "pair_reduce", boom)
    distances.min_distance(a, b, box[:, None, :],
                           mask_a=np.ones(40, bool))
    distances.contact_count(a, b, box[:, None, :], 0.8,
                            mask_b=np.ones(50, bool))
    distances._pair_reduce(a, b, box, CUT2, None, None, 1 << 10)


@pytest.mark.gpu
@pytest.mark.parametrize("cut2", [None, CUT2], ids=["min", "count"])
def test_compiled_kernel_matches_plain_on_gpu(cut2):
    """The kernel as compiled for the card equals the plain reduction."""
    a, b, box = _sets(11, 3, 3001, 5003)
    got = np.asarray(pair_triton.pair_reduce(a, b, box, cut2))
    want = _plain(a, b, box, cut2)
    if cut2 is None:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=max(2, 1e-6 * want.max()))


@pytest.mark.gpu
def test_product_route_uses_kernel_on_gpu():
    """On a GPU, an unmasked `min_distance` lowers the kernel."""
    import jax

    a, b, box = _sets(12, 2, 300, 400)
    hlo = jax.jit(lambda a, b, box: distances.min_distance(
        a, b, box[:, None, :])).lower(a, b, box).as_text()
    assert "pair_reduce_triton" in hlo or "triton" in hlo
