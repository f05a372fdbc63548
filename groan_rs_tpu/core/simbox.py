"""Simulation box.

Array-based equivalent of the reference `SimBox`
(`src/structures/simbox.rs:13-26`): a 9-component triclinic box following the
Gromacs convention (v1y = v1z = v2z = 0).  The GRO box-line component order is
``v1x v2y v3z v1y v1z v2x v2z v3x v3y``.

Device kernels never see this object — they receive either the `(3,)` vector
of orthogonal box lengths or the `(3, 3)` row-major box matrix (rows are box
vectors), both as f32 arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..errors import SimBoxError


@dataclass
class SimBox:
    # Gromacs component names; x == v1x, y == v2y, z == v3z.
    v1x: float = 0.0
    v2y: float = 0.0
    v3z: float = 0.0
    v1y: float = 0.0
    v1z: float = 0.0
    v2x: float = 0.0
    v2z: float = 0.0
    v3x: float = 0.0
    v3y: float = 0.0

    # ------------------------------------------------------------- constructors
    @classmethod
    def from_lengths(cls, x: float, y: float, z: float) -> "SimBox":
        return cls(float(x), float(y), float(z))

    @classmethod
    def from_gro_line(cls, values) -> "SimBox":
        """Build from the 3 or 9 floats of a GRO box line."""
        vals = [float(v) for v in values]
        if len(vals) == 3:
            return cls(*vals)
        if len(vals) == 9:
            return cls(*vals)
        raise SimBoxError(f"a box requires 3 or 9 components, got {len(vals)}")

    @classmethod
    def from_lengths_angles(
        cls, a: float, b: float, c: float, alpha: float, beta: float, gamma: float
    ) -> "SimBox":
        """From lengths (nm) + angles (degrees), Gromacs convention
        (reference: simbox.rs:96)."""
        ar, br, cr = math.radians(alpha), math.radians(beta), math.radians(gamma)
        v1 = (a, 0.0, 0.0)
        v2 = (b * math.cos(cr), b * math.sin(cr), 0.0)
        v3x = c * math.cos(br)
        v3y = c * (math.cos(ar) - math.cos(br) * math.cos(cr)) / math.sin(cr)
        v3z = math.sqrt(max(c * c - v3x * v3x - v3y * v3y, 0.0))
        # snap tiny numerical noise (e.g. 90-degree angles) to exact zero
        def snap(v: float) -> float:
            return 0.0 if abs(v) < 1e-6 else v

        return cls(
            snap(v1[0]), snap(v2[1]), snap(v3z),
            0.0, 0.0, snap(v2[0]), 0.0, snap(v3x), snap(v3y),
        )

    # ------------------------------------------------------------- properties
    @property
    def x(self) -> float:
        return self.v1x

    @property
    def y(self) -> float:
        return self.v2y

    @property
    def z(self) -> float:
        return self.v3z

    def lengths(self) -> np.ndarray:
        """Box-vector lengths |v1|, |v2|, |v3| (reference: simbox.rs:150)."""
        m = self.to_matrix()
        return np.linalg.norm(m, axis=1).astype(np.float32)

    def angles(self) -> np.ndarray:
        """Angles alpha (v2,v3), beta (v1,v3), gamma (v1,v2) in degrees."""
        m = self.to_matrix().astype(np.float64)
        v1, v2, v3 = m

        def ang(u, w):
            c = float(np.dot(u, w) / (np.linalg.norm(u) * np.linalg.norm(w)))
            return math.degrees(math.acos(max(-1.0, min(1.0, c))))

        return np.array([ang(v2, v3), ang(v1, v3), ang(v1, v2)], dtype=np.float32)

    def to_lengths_angles(self):
        """(lengths, angles) tuple — the inverse of `from_lengths_angles`
        (reference: simbox.rs to_lengths_angles)."""
        return self.lengths(), self.angles()

    def is_orthogonal(self) -> bool:
        """reference: simbox.rs:185"""
        return (
            self.v1y == 0.0
            and self.v1z == 0.0
            and self.v2x == 0.0
            and self.v2z == 0.0
            and self.v3x == 0.0
            and self.v3y == 0.0
        )

    def is_zero(self) -> bool:
        return all(
            v == 0.0
            for v in (
                self.v1x, self.v2y, self.v3z, self.v1y, self.v1z,
                self.v2x, self.v2z, self.v3x, self.v3y,
            )
        )

    def is_valid(self) -> bool:
        """Positive diagonal and not degenerate."""
        return self.v1x > 0.0 and self.v2y > 0.0 and self.v3z > 0.0

    # ------------------------------------------------------------- conversions
    def to_matrix(self) -> np.ndarray:
        """Row-major `(3,3)` matrix; rows are the box vectors v1, v2, v3."""
        return np.array(
            [
                [self.v1x, self.v1y, self.v1z],
                [self.v2x, self.v2y, self.v2z],
                [self.v3x, self.v3y, self.v3z],
            ],
            dtype=np.float32,
        )

    @classmethod
    def from_matrix(cls, m) -> "SimBox":
        m = np.asarray(m, dtype=np.float64)
        return cls(
            float(m[0, 0]), float(m[1, 1]), float(m[2, 2]),
            float(m[0, 1]), float(m[0, 2]),
            float(m[1, 0]), float(m[1, 2]),
            float(m[2, 0]), float(m[2, 1]),
        )

    def to_lengths_vec(self) -> np.ndarray:
        """`(3,)` orthogonal box lengths for device kernels."""
        return np.array([self.v1x, self.v2y, self.v3z], dtype=np.float32)

    def to_gro_line(self) -> list:
        vals = [
            self.v1x, self.v2y, self.v3z,
            self.v1y, self.v1z, self.v2x,
            self.v2z, self.v3x, self.v3y,
        ]
        if self.is_orthogonal():
            return vals[:3]
        return vals

    def __iter__(self):
        return iter(
            (
                self.v1x, self.v2y, self.v3z,
                self.v1y, self.v1z, self.v2x,
                self.v2z, self.v3x, self.v3y,
            )
        )


def simbox_check(simbox) -> SimBox:
    """Validate a box for orthogonal-PBC math (reference: simbox.rs:230)."""
    if simbox is None:
        raise SimBoxError("system has no simulation box", code="DoesNotExist")
    if not simbox.is_orthogonal():
        raise SimBoxError(
            "simulation box is not orthogonal", code="NotOrthogonal"
        )
    if not simbox.is_valid():
        raise SimBoxError("simulation box is not valid", code="Invalid")
    return simbox
