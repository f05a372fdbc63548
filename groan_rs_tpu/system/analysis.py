"""Analysis methods: centers, COM, distances (reference: `src/system/analysis.rs`).

Host-facing wrappers around the jitted kernels in `ops/`: selections become
gather indices once, then the math runs through `ops.interactive` — the same
jnp kernels jit-compiled on the local CPU backend (pow2-padded shape cache),
like the reference's CPU methods (set ``GROAN_INTERACTIVE_DEVICE=default`` to
dispatch to the accelerator instead).  The heavy trajectory path bypasses
these and uses the batched ops directly (see `parallel/` and `models/`).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..core.dimension import Dimension
from ..core.simbox import simbox_check
from ..errors import (GroupError, MassError, PerformanceWarning,
                      PositionError, SimBoxError)
from ..ops import interactive

# Per-call analysis methods run host-side (ops.interactive), but a per-frame
# Python loop over them still forfeits batching: the batched pipeline fuses
# the whole pass into one jitted device computation.  After this many calls
# we point the user at it once.  Tune/disable with GROAN_DISPATCH_WARN_AT
# (0 = off).
_DISPATCH_WARN_AT = int(os.environ.get("GROAN_DISPATCH_WARN_AT", "256"))
_dispatch_state = {"count": 0, "warned": False}


def _tick_dispatch():
    st = _dispatch_state
    st["count"] += 1
    if (not st["warned"] and _DISPATCH_WARN_AT > 0
            and st["count"] >= _DISPATCH_WARN_AT):
        st["warned"] = True
        warnings.warn(
            f"{st['count']} per-call System analysis dispatches so far. "
            "For per-frame trajectory analysis use "
            "models.TrajectoryAnalysis (one jitted batched pass), or "
            "ops.* batched kernels directly.",
            PerformanceWarning, stacklevel=3)


def _reset_dispatch_guard(warn_at: int | None = None):
    """Testing hook: reset the counter (and optionally the threshold)."""
    global _DISPATCH_WARN_AT
    _dispatch_state["count"] = 0
    _dispatch_state["warned"] = False
    if warn_at is not None:
        _DISPATCH_WARN_AT = warn_at


class AnalysisMixin:
    # ------------------------------------------------------------- helpers
    def _group_positions(self, name: str) -> np.ndarray:
        idx = self.group_indices(name)
        if not self.has_position[idx].all():
            bad = int(idx[~self.has_position[idx]][0])
            raise GroupError(
                f"atom {bad} has no position", code="InvalidPosition"
            )
        return self.positions[idx]

    def _group_masses(self, name: str) -> np.ndarray:
        idx = self.group_indices(name)
        if not self.topology.has_mass[idx].all():
            bad = int(idx[~self.topology.has_mass[idx]][0])
            raise GroupError(f"atom {bad} has no mass", code="InvalidMass")
        return self.topology.mass[idx]

    def _check_box(self):
        try:
            return simbox_check(self.simbox).to_lengths_vec()
        except SimBoxError as e:
            raise GroupError(str(e), code="InvalidSimBox") from e

    # ------------------------------------------------------------- centers
    def group_estimate_center(self, name: str) -> np.ndarray:
        """Bai-Breen estimate (reference: analysis.rs:52)."""
        _tick_dispatch()
        box = self._check_box()
        pos = self._group_positions(name)
        return interactive.estimate_center(pos, box)

    def group_get_center(self, name: str) -> np.ndarray:
        """Refined center of geometry (reference: analysis.rs:105)."""
        _tick_dispatch()
        box = self._check_box()
        pos = self._group_positions(name)
        return interactive.center(pos, box)

    def group_get_center_naive(self, name: str) -> np.ndarray:
        """Plain mean, no PBC (reference: analysis.rs:150)."""
        pos = self._group_positions(name)
        return interactive.center_naive(pos)

    def group_estimate_com(self, name: str) -> np.ndarray:
        """reference: analysis.rs:203."""
        _tick_dispatch()
        box = self._check_box()
        pos = self._group_positions(name)
        m = self._group_masses(name)
        return interactive.estimate_center(pos, box, weights=m)

    def group_get_com(self, name: str) -> np.ndarray:
        """Refined center of mass (reference: analysis.rs:258)."""
        _tick_dispatch()
        box = self._check_box()
        pos = self._group_positions(name)
        m = self._group_masses(name)
        return interactive.center(pos, box, weights=m)

    def group_get_com_naive(self, name: str) -> np.ndarray:
        """reference: analysis.rs:305."""
        pos = self._group_positions(name)
        m = self._group_masses(name)
        return interactive.center_naive(pos, weights=m)

    # ------------------------------------------------------------- distances
    def group_distance(self, group1: str, group2: str, dim: Dimension) -> float:
        """Distance between group centers (reference: analysis.rs:348)."""
        _tick_dispatch()
        box = self._check_box()
        c1 = self.group_get_center(group1)
        c2 = self.group_get_center(group2)
        return float(interactive.distance(c1, c2, box, dim.value))

    def group_all_distances(self, group1: str, group2: str, dim: Dimension) -> np.ndarray:
        """N x M pair distance matrix (reference: analysis.rs:401)."""
        _tick_dispatch()
        box = self._check_box()
        a = self._group_positions(group1)
        b = self._group_positions(group2)
        return interactive.distance_matrix(a, b, box, dim.value)

    def atoms_distance(self, index1: int, index2: int, dim: Dimension) -> float:
        """Distance between two atoms (reference: analysis.rs:459)."""
        _tick_dispatch()
        from ..errors import AtomError

        n = self.get_n_atoms()
        if not (0 <= index1 < n) or not (0 <= index2 < n):
            raise AtomError(
                f"atom index out of range ({index1}, {index2})", code="OutOfRange"
            )
        box = simbox_check(self.simbox).to_lengths_vec()
        for i in (index1, index2):
            if not self.has_position[i]:
                raise PositionError(f"atom {i} has no position")
        return float(
            interactive.distance(
                self.positions[index1], self.positions[index2], box, dim.value
            )
        )


class TriclinicAnalysisMixin:
    """Exact triclinic analysis (surpass feature: the reference reads
    triclinic boxes but its PBC math is orthogonal-only,
    src/lib.rs:353-355).  These methods accept ANY Gromacs-legal box."""

    def _box_matrix(self) -> np.ndarray:
        sb = self.get_box()
        if sb is None:
            raise SimBoxError("system has no simulation box", code="DoesNotExist")
        return np.asarray(sb.to_matrix(), np.float32)

    def group_get_center_triclinic(self, name: str) -> np.ndarray:
        """Refined Bai-Breen center of geometry under the exact triclinic
        minimum image (fractional-space trig)."""
        _tick_dispatch()
        pos = self._group_positions(name)
        return interactive.center_triclinic(pos, self._box_matrix())

    def group_get_com_triclinic(self, name: str) -> np.ndarray:
        _tick_dispatch()
        pos = self._group_positions(name)
        w = self._group_masses(name)
        return interactive.center_triclinic(pos, self._box_matrix(), weights=w)

    def group_distance_triclinic(self, name1: str, name2: str) -> float:
        """Exact triclinic minimum-image distance between group centers."""
        _tick_dispatch()
        c1 = self.group_get_center_triclinic(name1)
        c2 = self.group_get_center_triclinic(name2)
        return float(interactive.distance_triclinic(c1, c2, self._box_matrix()))

    def atoms_distance_triclinic(self, i: int, j: int) -> float:
        """Exact triclinic minimum-image distance between two atoms."""
        _tick_dispatch()
        from ..errors import AtomError

        n = self.get_n_atoms()
        for k in (i, j):
            if not (0 <= k < n):
                raise AtomError(f"atom {k} out of range", code="OutOfRange")
        return float(
            interactive.distance_triclinic(
                self.positions[i], self.positions[j], self._box_matrix()
            )
        )
