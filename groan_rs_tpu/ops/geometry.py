"""Bond-angle and dihedral kernels, batched over frames (surpass).

The reference exposes per-pair geometry only (`Vector3D::angle`,
`src/structures/vector3d.rs:276`, non-PBC, evaluated one pair at a time);
it has no per-frame angle/dihedral trajectory analysis.  These kernels
cover the `gmx angle` / `gmx chi` workload the batched way: a `[B, K, 3]`
batch of frames x angle-sites evaluates in one fused elementwise pass —
no per-angle host loop, no trig on the host.

Conventions
- displacement vectors use the orthorhombic minimum image (or the exact
  triclinic minimum image with `triclinic=True`, a surpass capability —
  the reference's PBC math is orthogonal-only, `src/lib.rs:353-355`);
- `angles` returns degrees in [0, 180], computed with atan2(|v x w|, v.w)
  (numerically exact near 0/180 where acos of a clamped dot is not);
- `dihedrals` returns SIGNED degrees in (-180, 180], IUPAC sign
  convention (looking along b-c, clockwise rotation of the far bond is
  positive), trans = 180.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "angles",
    "dihedrals",
    "angles_host_f64",
    "dihedrals_host_f64",
]


def _min_image_disp(a, b, boxes, triclinic):
    """Minimum-image displacement a - b for `[B, K, 3]` point sets with
    per-frame boxes (`[B, 3]` lengths, or `[B, 3, 3]` matrices when
    triclinic)."""
    from .pbc import min_image, min_image_triclinic_frames

    d = a - b
    if triclinic:
        return min_image_triclinic_frames(d, boxes)
    return min_image(d, boxes[:, None, :])


def angles(a, b, c, boxes, *, triclinic: bool = False):
    """Angle a-b-c per frame and site -> `[B, K]` degrees.

    a, b, c: `[B, K, 3]` coordinates (b is the vertex); boxes as in
    `_min_image_disp`.
    """
    import jax.numpy as jnp

    va = _min_image_disp(a, b, boxes, triclinic)
    vc = _min_image_disp(c, b, boxes, triclinic)
    cross = jnp.cross(va, vc)
    sin = jnp.sqrt(jnp.sum(cross * cross, axis=-1))
    cos = jnp.sum(va * vc, axis=-1)
    return jnp.degrees(jnp.arctan2(sin, cos))


def dihedrals(a, b, c, d, boxes, *, triclinic: bool = False):
    """Dihedral angle over the chain a-b-c-d per frame and site ->
    `[B, K]` signed degrees.

    Uses the atan2 formulation: with bond vectors b1 = b-a, b2 = c-b,
    b3 = d-c (each minimum-image), phi = atan2((b1 x b2) x (b2 x b3) .
    b2/|b2|, (b1 x b2).(b2 x b3)).
    """
    import jax.numpy as jnp

    b1 = _min_image_disp(b, a, boxes, triclinic)
    b2 = _min_image_disp(c, b, boxes, triclinic)
    b3 = _min_image_disp(d, c, boxes, triclinic)
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    b2n = b2 / jnp.linalg.norm(b2, axis=-1, keepdims=True)
    y = jnp.sum(jnp.cross(n1, n2) * b2n, axis=-1)
    x = jnp.sum(n1 * n2, axis=-1)
    return jnp.degrees(jnp.arctan2(y, x))


def inside_shape(shape, pos, boxes):
    """Jit-traceable batched membership for `core.shapes` shapes.

    pos: `[B, N, 3]`; boxes: `[B, 3]` orthorhombic lengths.  Returns
    `[B, N]` bool with EXACTLY `Shape.inside`'s PBC semantics
    (shape.rs:114/256 asymmetries included: Sphere strict `<`,
    Rectangular/Cylinder inclusive `<=`, oriented axis distances folded
    to [0, L)).  The host `Shape.inside` materializes numpy; this is the
    device-side twin used by per-frame shape observables.
    """
    import jax.numpy as jnp

    from ..core.shapes import Cylinder, Rectangular, Sphere, _AXIS
    from .pbc import min_image

    pos = jnp.asarray(pos, jnp.float32)
    boxes = jnp.asarray(boxes, jnp.float32)

    def axis_dist(ax, anchor):
        d = min_image(pos[..., ax] - jnp.float32(anchor),
                      boxes[:, None, ax])
        return jnp.where(d < 0, d + boxes[:, None, ax], d)

    def plane_dist2(center, dims):
        d = min_image(pos - jnp.asarray(center, jnp.float32),
                      boxes[:, None, :])
        m = jnp.asarray([ax in dims for ax in range(3)], bool)
        d = jnp.where(m, d, 0.0)
        return jnp.sum(d * d, axis=-1)

    if isinstance(shape, Sphere):
        return plane_dist2(shape.position, (0, 1, 2)) \
            < jnp.float32(shape.radius) ** 2
    if isinstance(shape, Rectangular):
        return (axis_dist(0, shape.position[0]) <= jnp.float32(shape.x)) \
            & (axis_dist(1, shape.position[1]) <= jnp.float32(shape.y)) \
            & (axis_dist(2, shape.position[2]) <= jnp.float32(shape.z))
    if isinstance(shape, Cylinder):
        ax = _AXIS[shape.orientation]
        dims = tuple(i for i in range(3) if i != ax)
        return (axis_dist(ax, shape.position[ax])
                <= jnp.float32(shape.height)) \
            & (plane_dist2(shape.position, dims)
               <= jnp.float32(shape.radius) ** 2)
    from ..errors import ShapeError

    raise ShapeError(
        f"shape {type(shape).__name__} has no device formulation "
        "(Sphere/Rectangular/Cylinder supported)")


# ----------------------------------------------------------------- oracles


def _min_image_host(d, box):
    return d - box * np.round(d / box)


def angles_host_f64(a, b, c, boxes):
    """Float64 host oracle for `angles` (orthorhombic)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    box = np.asarray(boxes, np.float64)[:, None, :]
    va = _min_image_host(a - b, box)
    vc = _min_image_host(c - b, box)
    cross = np.cross(va, vc)
    sin = np.sqrt(np.sum(cross * cross, axis=-1))
    cos = np.sum(va * vc, axis=-1)
    return np.degrees(np.arctan2(sin, cos))


def dihedrals_host_f64(a, b, c, d, boxes):
    """Float64 host oracle for `dihedrals` (orthorhombic)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    d = np.asarray(d, np.float64)
    box = np.asarray(boxes, np.float64)[:, None, :]
    b1 = _min_image_host(b - a, box)
    b2 = _min_image_host(c - b, box)
    b3 = _min_image_host(d - c, box)
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2n = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    y = np.sum(np.cross(n1, n2) * b2n, axis=-1)
    x = np.sum(n1 * n2, axis=-1)
    return np.degrees(np.arctan2(y, x))
