"""Vector math parity vs the reference's Vector3D test values
(src/structures/vector3d.rs inline tests, ~70 cases)."""

import math

import numpy as np
import pytest

# numeric parity holds on the real chip too (backend matrix, SURVEY §4):
# GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity
pytestmark = pytest.mark.device_parity

from groan_rs_tpu.core.dimension import Dimension
from groan_rs_tpu.ops import pbc
from groan_rs_tpu.ops import vecmath
from groan_rs_tpu.ops.vecmath import (
    angle,
    cross,
    dot,
    length,
    rotate,
    rotation_about_axis,
    shift,
    to_unit,
)

F = np.float32
PI = math.pi


def v(*args):
    return np.array(args, F)


# ------------------------------------------------------------- len / unit

def test_len():
    assert float(length(v(4.3, 5.6, 1.2))) == pytest.approx(7.161704)
    assert float(length(v(0, 0, 0))) == 0.0


def test_to_unit():
    u = np.asarray(to_unit(v(4.3, 5.6, 1.2)))
    np.testing.assert_allclose(u, [0.6004158, 0.7819368, 0.16755791], atol=1e-6)
    assert float(length(u)) == pytest.approx(1.0)
    assert np.isnan(np.asarray(to_unit(v(0, 0, 0)))).all()
    np.testing.assert_allclose(np.asarray(to_unit(v(0.13, 0, 0))), [1, 0, 0], atol=1e-6)


def test_len_batched():
    arr = np.stack([v(4.3, 5.6, 1.2), v(0, 0, 0), v(3, 4, 0)])
    np.testing.assert_allclose(np.asarray(length(arr)), [7.161704, 0.0, 5.0], atol=1e-5)


# ------------------------------------------------------------- dot / cross

@pytest.mark.parametrize("a,b,expected", [
    ((1, 0, 0), (0, 1, 1), 0.0),
    ((2, 3, 4), (1, 2, 3), 20.0),
    ((-2, 0, 5), (3, 1, -4), -26.0),
    ((-2, 0, 5), (-3, 1, -4), -14.0),
    ((-2.5, 0.3, 5.1), (-3.9, 1.1, -4.2), -11.34),
])
def test_dot(a, b, expected):
    assert float(dot(v(*a), v(*b))) == pytest.approx(expected, abs=1e-5)


@pytest.mark.parametrize("a,b,expected", [
    ((1, 0, 0), (0, 1, 1), (0, -1, 1)),
    ((2, 3, 4), (1, 2, 3), (1, -2, 1)),
    ((-2, 0, 5), (3, 1, -4), (-5, 7, -2)),
    ((-2, 0, 5), (-3, 1, -4), (-5, -23, -2)),
    ((-2.5, 0.3, 5.1), (-3.9, 1.1, -4.2), (-6.87, -30.39, -1.58)),
])
def test_cross(a, b, expected):
    np.testing.assert_allclose(np.asarray(cross(v(*a), v(*b))), expected, atol=2e-5)


# ------------------------------------------------------------- angle

@pytest.mark.parametrize("a,b,expected", [
    ((2, 0, 0), (0, 2, 0), PI / 2),
    ((2, 0, 0), (0, -2, 0), PI / 2),
    ((1, 0, 0), (0, 0, 7), PI / 2),
    ((1, 0, 0), (3, 0, 3), PI / 4),
    ((1, 0, 0), (4, 0, 0), 0.0),
    ((1, 0, 0), (-4, 0, 0), PI),
    ((1, -1, 3.5), (1.2, 2.4, -0.7), 1.9269546),
    ((1, 2, 3), (3, 2, 1), 0.77519345),  # doc example, vector3d.rs:260-272
])
def test_angle(a, b, expected):
    assert float(angle(v(*a), v(*b))) == pytest.approx(expected, abs=1e-5)


# ------------------------------------------------------------- shift

def test_shift_x():
    out = np.asarray(shift(v(-2.5, 0.3, 5.1), v(1, 0, 0), 1.5))
    np.testing.assert_allclose(out, [-1.0, 0.3, 5.1], atol=1e-6)


def test_shift_xyz():
    out = np.asarray(shift(v(-2.5, 0.3, 5.1), v(1, 1, 1), 3.5))
    np.testing.assert_allclose(out, [-0.479274, 2.320726, 7.120726], atol=1e-5)
    assert float(pbc.distance_naive(out, v(-2.5, 0.3, 5.1))) == pytest.approx(3.5, abs=1e-5)


def test_shift_arbitrary():
    out = np.asarray(shift(v(-2.5, 0.3, 5.1), v(1, 0.5, 2), 4.2))
    np.testing.assert_allclose(out, [-0.66697, 1.216515, 8.76606], atol=1e-5)
    out = np.asarray(shift(v(-2.5, 0.3, 5.1), v(1, 0.5, 2), -4.2))
    np.testing.assert_allclose(out, [-4.33303, -0.616515, 1.43394], atol=1e-5)


# ------------------------------------------------------------- rotate

def test_rotate_doc_example():
    """+90 degrees counterclockwise around z (vector3d.rs:318-332)."""
    r = rotation_about_axis(v(0, 0, 1), PI / 2)
    out = np.asarray(rotate(v(1, 2, 3), r))
    np.testing.assert_allclose(out, [-2.0, 1.0, 3.0], atol=1e-6)


def test_rotate_batched_inverse():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(16, 3)).astype(F)
    r = rotation_about_axis(v(0.3, 1.0, 0.2), 0.7)
    back = rotation_about_axis(v(0.3, 1.0, 0.2), -0.7)
    out = np.asarray(rotate(rotate(pts, r), back))
    np.testing.assert_allclose(out, pts, atol=1e-5)


# ------------------------------------------------------------- wrap

def test_wrap_values():
    box = v(2, 2, 2)
    np.testing.assert_allclose(np.asarray(pbc.wrap(v(-1.0, 1.5, 3.0), box)),
                               [1.0, 1.5, 1.0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(pbc.wrap(v(2.0, 2.2, -0.3), box)),
                               [2.0, 0.2, 1.7], atol=1e-5)
    np.testing.assert_allclose(np.asarray(pbc.wrap(v(-54.2, 77.8, 124.5), box)),
                               [1.8, 1.8, 0.5], atol=1e-4)
    # doc example: wrap into [4,4,4]
    np.testing.assert_allclose(np.asarray(pbc.wrap(v(-0.5, 2.0, 4.2), v(4, 4, 4))),
                               [3.5, 2.0, 0.2], atol=1e-5)


# ------------------------------------------------------------- PBC distance

P1 = (1.0, 3.9, 2.6)
P2 = (3.5, 0.1, 0.4)
BOX4 = (4.0, 4.0, 4.0)


@pytest.mark.parametrize("dim,d12,d21", [
    (Dimension.X, 1.5, -1.5),
    (Dimension.Y, -0.2, 0.2),
    (Dimension.Z, -1.8, 1.8),
    (Dimension.XY, 1.51327, 1.51327),
    (Dimension.XZ, 2.34307, 2.34307),
    (Dimension.YZ, 1.81108, 1.81108),
    (Dimension.XYZ, 2.351595, 2.351595),
    (Dimension.NONE, 0.0, 0.0),
])
def test_distance_dims(dim, d12, d21):
    assert float(pbc.distance(v(*P1), v(*P2), v(*BOX4), dim.value)) == pytest.approx(d12, abs=1e-5)
    assert float(pbc.distance(v(*P2), v(*P1), v(*BOX4), dim.value)) == pytest.approx(d21, abs=1e-5)


def test_distance_out_of_box():
    a, b = v(-1.0, 4.5, 2.3), v(3.5, -0.5, 4.2)
    assert float(pbc.distance(a, b, v(*BOX4), Dimension.X.value)) == pytest.approx(-0.5, abs=1e-5)
    assert float(pbc.distance(a, b, v(*BOX4), Dimension.Y.value)) == pytest.approx(1.0, abs=1e-5)
    assert float(pbc.distance(a, b, v(*BOX4), Dimension.Z.value)) == pytest.approx(-1.9, abs=1e-5)


@pytest.mark.parametrize("dim,d12,d21", [
    (Dimension.X, -2.5, 2.5),
    (Dimension.Y, 3.8, -3.8),
    (Dimension.Z, 2.2, -2.2),
    (Dimension.XY, 4.548626, 4.548626),
    (Dimension.XZ, 3.330165, 3.330165),
    (Dimension.YZ, 4.3909, 4.3909),
    (Dimension.XYZ, 5.052722, 5.052722),
    (Dimension.NONE, 0.0, 0.0),
])
def test_distance_naive_dims(dim, d12, d21):
    assert float(pbc.distance_naive(v(*P1), v(*P2), dim.value)) == pytest.approx(d12, abs=1e-5)
    assert float(pbc.distance_naive(v(*P2), v(*P1), dim.value)) == pytest.approx(d21, abs=1e-5)


# ------------------------------------------------------------- vector_to

@pytest.mark.parametrize("p1,p2,expected", [
    ((4, 4, 5), (5, 5, 3), (1, 1, -2)),
    ((3, 0, 7), (1, 2, 1), (-2, 2, 4)),
    ((1, 2, 5), (9, 8, 6), (-2, -4, 1)),
    ((8, 9, 2), (1, 3, 9), (3, 4, -3)),
    ((0, 3, 10), (10, 3, 0), (0, 0, 0)),
])
def test_vector_to(p1, p2, expected):
    out = np.asarray(pbc.vector_to(v(*p1), v(*p2), v(10, 10, 10)))
    np.testing.assert_allclose(out, expected, atol=1e-5)


def test_vector_to_equidistant():
    out = np.asarray(pbc.vector_to(v(7, 4, 3), v(2, 5, 2), v(10, 10, 10)))
    assert abs(float(out[0])) == pytest.approx(5.0, abs=1e-5)
    assert float(out[1]) == pytest.approx(1.0, abs=1e-5)
    assert float(out[2]) == pytest.approx(-1.0, abs=1e-5)


def test_vector_to_doc_example():
    """vector3d.rs vector_to doc: [4,2.5,1] -> [1,4,3] in box [4,4,4] is
    [-1.5, -2.0(or 1.5?), ...] — use the loop-form displacement check."""
    out = np.asarray(pbc.vector_to(v(4.0, 4.0, 5.0), v(5.0, 5.0, 3.0), v(10, 10, 10)))
    np.testing.assert_allclose(out, [1.0, 1.0, -2.0], atol=1e-5)


# ------------------------------------------------------------- dimension filter

@pytest.mark.parametrize("dim,expected", [
    (Dimension.X, (4.3, 0, 0)),
    (Dimension.Y, (0, 1.8, 0)),
    (Dimension.Z, (0, 0, 2.7)),
    (Dimension.XY, (4.3, 1.8, 0)),
    (Dimension.XZ, (4.3, 0, 2.7)),
    (Dimension.YZ, (0, 1.8, 2.7)),
    (Dimension.XYZ, (4.3, 1.8, 2.7)),
    (Dimension.NONE, (0, 0, 0)),
])
def test_dimension_filter(dim, expected):
    mask = np.asarray(dim.value, bool)
    out = np.where(mask, v(4.3, 1.8, 2.7), 0.0)
    np.testing.assert_allclose(out, expected, atol=1e-6)


def test_to_unit_null_is_nan():
    """vector3d.rs to_unit_null — normalizing the zero vector gives NaN."""
    u = np.asarray(vecmath.to_unit(np.zeros(3, np.float32)))
    assert np.isnan(u).all()


def test_to_unit_small():
    u = np.asarray(vecmath.to_unit(np.array([0.13, 0.0, 0.0], np.float32)))
    np.testing.assert_allclose(u, [1.0, 0.0, 0.0], atol=1e-6)
    assert float(vecmath.length(u)) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("v1,v2,expected", [
    ([2, 0, 0], [0, 2, 0], np.pi / 2),
    ([2, 0, 0], [0, -2, 0], np.pi / 2),
    ([1, 0, 0], [0, 0, 7], np.pi / 2),
    ([1, 0, 0], [3, 0, 3], np.pi / 4),
    ([1, 0, 0], [4, 0, 0], 0.0),
    ([1, 0, 0], [-4, 0, 0], np.pi),
    ([1, -1, 3.5], [1.2, 2.4, -0.7], 1.9269546),
])
def test_angle_all_reference_cases(v1, v2, expected):
    """vector3d.rs angle_1..7 exact values."""
    a = float(vecmath.angle(np.asarray(v1, np.float32), np.asarray(v2, np.float32)))
    assert a == pytest.approx(expected, abs=1e-5)


def test_dimension_to_unit_vector():
    """dimension.rs From<Dimension> for Vector3D exact components."""
    from groan_rs_tpu.core.dimension import Dimension

    r2, r3 = 1.0 / np.sqrt(2.0), 1.0 / np.sqrt(3.0)
    cases = {
        Dimension.NONE: [0, 0, 0],
        Dimension.X: [1, 0, 0],
        Dimension.Y: [0, 1, 0],
        Dimension.Z: [0, 0, 1],
        Dimension.XY: [r2, r2, 0],
        Dimension.XZ: [r2, 0, r2],
        Dimension.YZ: [0, r2, r2],
        Dimension.XYZ: [r3, r3, r3],
    }
    for dim, want in cases.items():
        got = dim.to_unit_vector()
        np.testing.assert_allclose(got, want, atol=1e-7)
        if dim is not Dimension.NONE:
            assert float(np.linalg.norm(got)) == pytest.approx(1.0, abs=1e-6)


class TestVector3DClass:
    """The Vector3D type itself (vector3d.rs doc-test values); it IS a
    (3,) float32 ndarray, so array code interoperates."""

    def test_fields_len_unit_invert(self):
        from groan_rs_tpu.core.vector3d import Vector3D

        v = Vector3D(1.0, 2.0, 3.0)
        assert (v.x, v.y, v.z) == (1.0, 2.0, 3.0)
        assert v.len() == pytest.approx(3.741657, abs=1e-6)
        u = v.to_unit()
        np.testing.assert_allclose(
            np.asarray(u), [0.2672612, 0.5345225, 0.8017837], atol=1e-6)
        assert u.len() == pytest.approx(1.0, abs=1e-6)
        assert Vector3D(0, 0, 0).to_unit().is_zero()
        np.testing.assert_array_equal(
            np.asarray(Vector3D(1.0, -2.0, 3.0).invert()), [-1.0, 2.0, -3.0])

    def test_angle_wrap_vector_to(self):
        from groan_rs_tpu.core.simbox import SimBox
        from groan_rs_tpu.core.vector3d import Vector3D

        a = Vector3D(1.0, 2.0, 3.0)
        b = Vector3D(3.0, 2.0, 1.0)
        assert a.angle(b) == pytest.approx(0.7751933, abs=1e-5)

        p = Vector3D(-0.5, 2.0, 4.2)
        p.wrap(SimBox.from_lengths(4.0, 4.0, 4.0))
        np.testing.assert_allclose(np.asarray(p), [3.5, 2.0, 0.2], atol=1e-5)

        v = Vector3D(1.0, 2.0, 3.0).vector_to(
            Vector3D(3.0, 2.0, 1.0), SimBox.from_lengths(3.5, 5.0, 5.0))
        np.testing.assert_allclose(np.asarray(v), [-1.5, 0.0, -2.0],
                                   atol=1e-6)

    def test_shift_filter_average_distance(self):
        from groan_rs_tpu.core.dimension import Dimension
        from groan_rs_tpu.core.simbox import SimBox
        from groan_rs_tpu.core.vector3d import Vector3D

        s = Vector3D(1.0, 1.0, 1.0).shift(Vector3D(0.0, 3.0, 0.0), 2.0)
        np.testing.assert_allclose(np.asarray(s), [1.0, 3.0, 1.0], atol=1e-6)

        f = Vector3D(1.0, 2.0, 3.0).filter(Dimension.XZ)
        np.testing.assert_array_equal(np.asarray(f), [1.0, 0.0, 3.0])

        avg = Vector3D.average([Vector3D(1.0, 2.0, 4.0),
                                Vector3D(3.0, 2.0, -2.0)])
        np.testing.assert_allclose(np.asarray(avg), [2.0, 2.0, 1.0])
        avg2 = Vector3D.average([Vector3D(-3.0, 0.0, 2.0),
                                 Vector3D(-2.0, 1.0, 7.0),
                                 Vector3D(1.0, -2.0, 2.0)])
        np.testing.assert_allclose(
            np.asarray(avg2), [-1.333333, -0.333333, 3.6666666], atol=1e-4)

        sb = SimBox.from_lengths(3.5, 5.0, 5.0)
        d = Vector3D(1.0, 2.0, 3.0).distance(Vector3D(3.0, 2.0, 1.0),
                                             Dimension.XYZ, sb)
        assert d == pytest.approx(2.5, abs=1e-6)
        dn = Vector3D(1.0, 0.0, 0.0).distance_naive(Vector3D(3.0, 0.0, 0.0),
                                                    Dimension.X)
        assert dn == pytest.approx(-2.0, abs=1e-6)

    def test_ndarray_interop(self):
        from groan_rs_tpu.core.vector3d import Vector3D

        v = Vector3D(1.0, 2.0, 3.0)
        assert isinstance(np.asarray(v), np.ndarray)
        assert (v + np.float32(1.0)).tolist() == [2.0, 3.0, 4.0]
        w = Vector3D.from_array(np.array([4, 5, 6]))
        assert w.dot(v) == pytest.approx(32.0)
        np.testing.assert_array_equal(np.asarray(v.cross(w)),
                                      np.cross([1, 2, 3], [4, 5, 6]))
