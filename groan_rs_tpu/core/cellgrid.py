"""Cell lists for O(N) neighbor search (host-side, numpy CSR layout).

reference: `src/structures/cellgrid.rs:148` — orthogonal boxes only; cells
at least `cell_size` wide (box_len / floor(box_len / cell_size)); atoms
binned by wrapped position; neighbor queries visit a relative cell range
(default ±1 per axis) with modular wrap-around, never visiting a cell
twice.

Unlike the reference's `Array3<Vec<usize>>`, atoms are stored as one CSR
(sorted-by-cell index array + per-cell offsets), so whole neighbor-cell
candidate lists come back as numpy slices ready for vectorized distance
filtering.  The device-side pair reductions (minimum distance, contacts)
live in `ops/distances.py`; hbonds/guess use vectorized 27-offset CSR
gathers over this grid.
"""

from __future__ import annotations

import numpy as np

from ..errors import CellGridError
from ..ops import pbc


class CellGrid:
    def __init__(self, system, group: str, cell_size: float):
        from ..core.simbox import simbox_check
        from ..errors import GroupError, SimBoxError

        try:
            sb = simbox_check(system.get_box())
        except SimBoxError as e:
            raise CellGridError(str(e), code="InvalidSimBox") from e
        if cell_size <= 0:
            raise CellGridError("cell size must be positive", code="InvalidCellSize")
        try:
            idx = system.group_indices(group)
        except GroupError as e:
            raise CellGridError(str(e), code="GroupError") from e
        if not system.has_position[idx].all():
            bad = int(np.asarray(idx)[~system.has_position[idx]][0])
            raise CellGridError(f"atom {bad} has no position", code="InvalidPosition")

        box = sb.to_lengths_vec()
        ncells = np.maximum(np.floor(box / cell_size).astype(np.int64), 1)
        self.box = box
        self.ncells = ncells
        self.cell_size = box / ncells
        self.system = system

        pos = np.asarray(pbc.wrap(system.positions[idx], box))
        coords = np.minimum(
            (pos / self.cell_size).astype(np.int64), ncells - 1
        )
        cell_ids = (coords[:, 0] * ncells[1] + coords[:, 1]) * ncells[2] + coords[:, 2]
        order = np.argsort(cell_ids, kind="stable")
        self.sorted_atoms = np.asarray(idx)[order]
        sorted_cells = cell_ids[order]
        total = int(ncells.prod())
        self.offsets = np.searchsorted(sorted_cells, np.arange(total + 1))

    # ------------------------------------------------------------- queries
    def cell_of(self, point) -> np.ndarray:
        p = np.asarray(pbc.wrap(np.asarray(point, np.float32), self.box))
        return np.minimum((p / self.cell_size).astype(np.int64), self.ncells - 1)

    def cell_atoms(self, cx: int, cy: int, cz: int) -> np.ndarray:
        cid = (cx * self.ncells[1] + cy) * self.ncells[2] + cz
        return self.sorted_atoms[self.offsets[cid] : self.offsets[cid + 1]]

    def _axis_offsets(self, rng, ncells: int):
        if rng is None:
            lo, hi = -1, 2  # reference default: Exclusive(-1..2)
        else:
            lo, hi = rng
        # never visit a cell twice (reference: CellNeighbors::convert)
        seen = []
        mods = set()
        for d in range(lo, hi):
            m = d % ncells
            if m not in mods:
                mods.add(m)
                seen.append(d)
        return seen

    def neighbors(self, point, x_range=None, y_range=None, z_range=None) -> np.ndarray:
        """All atom indices in the neighbor cells of `point`
        (reference: neighbors_iter, cellgrid.rs:383)."""
        c = self.cell_of(point)
        nx, ny, nz = (int(v) for v in self.ncells)
        parts = []
        for dx in self._axis_offsets(x_range, nx):
            for dy in self._axis_offsets(y_range, ny):
                for dz in self._axis_offsets(z_range, nz):
                    parts.append(
                        self.cell_atoms(
                            (int(c[0]) + dx) % nx, (int(c[1]) + dy) % ny, (int(c[2]) + dz) % nz
                        )
                    )
        if not parts:
            return np.empty(0, np.int64)
        return np.concatenate(parts)

    def neighbors_iter(self, point, x_range=None, y_range=None,
                       z_range=None):
        """Chainable Atom iterator over `neighbors(point, ...)`
        (reference: cellgrid.rs:383 — visit order is undefined there;
        here atoms come in System order, each at most once)."""
        from ..system.iterating import AtomIterator

        return AtomIterator(
            self.system,
            np.sort(self.neighbors(point, x_range, y_range, z_range)))

    def neighbor_cell_pairs(self):
        """Yield (cell_atoms, neighbor_atoms) for every non-empty cell with
        its half-shell of neighbor cells (each unordered cell pair visited
        once) — the vectorized bulk path for pair searches."""
        nx, ny, nz = (int(v) for v in self.ncells)
        # half-shell of relative offsets: self + 13 neighbors
        half = [(0, 0, 0)]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if (dx, dy, dz) > (0, 0, 0):
                        half.append((dx, dy, dz))
        seen_pairs = set()
        for cx in range(nx):
            for cy in range(ny):
                for cz in range(nz):
                    a = self.cell_atoms(cx, cy, cz)
                    if a.shape[0] == 0:
                        continue
                    cid = (cx * ny + cy) * nz + cz
                    for dx, dy, dz in half:
                        ox, oy, oz = (cx + dx) % nx, (cy + dy) % ny, (cz + dz) % nz
                        oid = (ox * ny + oy) * nz + oz
                        key = (min(cid, oid), max(cid, oid), dx == dy == dz == 0)
                        if (dx, dy, dz) != (0, 0, 0):
                            if key in seen_pairs:
                                continue
                            seen_pairs.add(key)
                        b = self.cell_atoms(ox, oy, oz)
                        if b.shape[0] == 0:
                            continue
                        yield a, b, (dx, dy, dz) == (0, 0, 0)
