"""Geometric shapes for selection filtering.

Batched re-design of the reference `Shape` trait
(`src/structures/shape.rs:71`): instead of a per-atom `inside(point)` call,
every shape evaluates `inside(points[..., 3], box) -> bool[...]` as one
vectorized predicate (jnp or numpy transparently via jnp ops).  The
`inside_naive` variants (`shape.rs:464+`) ignore PBC.

Semantics match the reference exactly, including the asymmetries:
Sphere uses strict `<`, Rectangular spans [position, position + lengths]
with inclusive edges, Cylinder is position-anchored along its orientation
axis with height inclusive-exclusive mix per reference.
"""

from __future__ import annotations

import numpy as np

from ..ops import pbc
from .dimension import Dimension

__all__ = ["Shape", "Sphere", "Rectangular", "Cylinder", "TriangularPrism"]

_AXIS = {Dimension.X: 0, Dimension.Y: 1, Dimension.Z: 2}
_PLANE = {Dimension.X: Dimension.YZ, Dimension.Y: Dimension.XZ, Dimension.Z: Dimension.XY}


def _oriented_axis_distance(points, position, axis: int, box):
    """1-D oriented PBC distance point->shape, folded to [0, L)."""
    d = np.asarray(
        pbc.min_image(
            np.asarray(points, np.float32)[..., axis] - np.float32(position[axis]),
            np.float32(box[axis]),
        )
    )
    return np.where(d < 0.0, d + box[axis], d)


def _plane_distance(points, position, plane: Dimension, box):
    return np.asarray(
        pbc.distance(
            np.asarray(points, np.float32), np.asarray(position, np.float32),
            np.asarray(box, np.float32), plane.value,
        )
    )


class Shape:
    def inside(self, points, box):
        raise NotImplementedError

    def inside_naive(self, points):
        raise NotImplementedError


class Sphere(Shape):
    """reference: shape.rs:14,114"""

    def __init__(self, position, radius: float):
        self.position = np.asarray(position, np.float32)
        self.radius = float(radius)

    def get_position(self):
        """reference: shape.rs get_position."""
        from .vector3d import Vector3D

        return Vector3D.from_array(self.position.copy())

    def get_radius(self) -> float:
        return self.radius

    def inside(self, points, box):
        d = _plane_distance(points, self.position, Dimension.XYZ, box)
        return d < self.radius

    def inside_naive(self, points):
        d = np.asarray(pbc.distance_naive(np.asarray(points, np.float32), self.position))
        return d < self.radius


class Rectangular(Shape):
    """reference: shape.rs:25,169 — spans [position, position + (x,y,z)]."""

    def __init__(self, position, x: float, y: float, z: float):
        self.position = np.asarray(position, np.float32)
        self.x, self.y, self.z = float(x), float(y), float(z)

    def get_position(self):
        from .vector3d import Vector3D

        return Vector3D.from_array(self.position.copy())

    def get_x(self) -> float:
        return self.x

    def get_y(self) -> float:
        return self.y

    def get_z(self) -> float:
        return self.z

    def inside(self, points, box):
        dx = _oriented_axis_distance(points, self.position, 0, box)
        dy = _oriented_axis_distance(points, self.position, 1, box)
        dz = _oriented_axis_distance(points, self.position, 2, box)
        return (dx <= self.x) & (dy <= self.y) & (dz <= self.z)

    def inside_naive(self, points):
        p = np.asarray(points, np.float32)
        d = p - self.position
        return (
            (d[..., 0] >= 0) & (d[..., 0] <= self.x)
            & (d[..., 1] >= 0) & (d[..., 1] <= self.y)
            & (d[..., 2] >= 0) & (d[..., 2] <= self.z)
        )


class Cylinder(Shape):
    """reference: shape.rs:40,256 — anchored at `position`, extending
    `height` along `orientation`, radius in the perpendicular plane."""

    def __init__(self, position, radius: float, height: float, orientation: Dimension):
        if orientation not in _AXIS:
            from ..errors import ShapeError

            raise ShapeError(f"unsupported cylinder orientation '{orientation}'")
        self.position = np.asarray(position, np.float32)
        self.radius = float(radius)
        self.height = float(height)
        self.orientation = orientation
        self.plane = _PLANE[orientation]

    def get_position(self):
        from .vector3d import Vector3D

        return Vector3D.from_array(self.position.copy())

    def get_radius(self) -> float:
        return self.radius

    def get_height(self) -> float:
        return self.height

    def get_orientation(self) -> Dimension:
        return self.orientation

    def get_plane(self) -> Dimension:
        return self.plane

    def inside(self, points, box):
        axis = _AXIS[self.orientation]
        d_axis = _oriented_axis_distance(points, self.position, axis, box)
        d_plane = _plane_distance(points, self.position, self.plane, box)
        return (d_axis <= self.height) & (d_plane <= self.radius)

    def inside_naive(self, points):
        axis = _AXIS[self.orientation]
        p = np.asarray(points, np.float32)
        d_axis = p[..., axis] - self.position[axis]
        d_plane = np.asarray(pbc.distance_naive(p, self.position, self.plane.value))
        return (d_axis >= 0.0) & (d_axis < self.height) & (d_plane < self.radius)


class TriangularPrism(Shape):
    """reference: shape.rs:57,435 — base triangle in an axis-aligned plane."""

    def __init__(self, base1, base2, base3, height: float):
        from ..errors import ShapeError

        self.base1 = np.asarray(base1, np.float32)
        self.base2 = np.asarray(base2, np.float32)
        self.base3 = np.asarray(base3, np.float32)
        self.height = float(height)

        orientation = None
        for axis, (ori, plane) in enumerate(
            [(Dimension.X, Dimension.YZ), (Dimension.Y, Dimension.XZ), (Dimension.Z, Dimension.XY)]
        ):
            if self.base1[axis] == self.base2[axis] == self.base3[axis]:
                if orientation is not None:
                    raise ShapeError("prism base cannot be constructed")
                orientation = ori
                self.plane = plane
        if orientation is None:
            raise ShapeError("prism base does not lie in the xy, xz, or yz plane")
        self.orientation = orientation

    def get_base1(self):
        from .vector3d import Vector3D

        return Vector3D.from_array(self.base1.copy())

    def get_base2(self):
        from .vector3d import Vector3D

        return Vector3D.from_array(self.base2.copy())

    def get_base3(self):
        from .vector3d import Vector3D

        return Vector3D.from_array(self.base3.copy())

    def get_height(self) -> float:
        return self.height

    def get_orientation(self) -> Dimension:
        return self.orientation

    @staticmethod
    def _sign(p, a, b, plane: Dimension):
        if plane is Dimension.XY:
            i, j = 0, 1
        elif plane is Dimension.XZ:
            i, j = 0, 2
        else:
            i, j = 1, 2
        return (p[..., i] - b[i]) * (a[j] - b[j]) - (a[i] - b[i]) * (p[..., j] - b[j])

    def inside(self, points, box):
        p = np.asarray(points, np.float32)
        axis = _AXIS[self.orientation]
        d_base = _oriented_axis_distance(p, self.base1, axis, box)
        within_height = d_base < self.height

        d1 = self._sign(p, self.base1, self.base2, self.plane)
        d2 = self._sign(p, self.base2, self.base3, self.plane)
        d3 = self._sign(p, self.base3, self.base1, self.plane)
        has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
        has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
        return within_height & ~(has_neg & has_pos)


# API parity: the reference's `NaiveShape` trait (shape.rs:464) is the
# no-PBC view of a shape; here every Shape carries `inside_naive` directly.
NaiveShape = Shape
