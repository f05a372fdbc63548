"""Element / property / bond guessing (reference: `src/system/guess.rs`).

Batched re-design: each element's GSL query compiles to one vectorized
`bool[N]` mask (instead of the reference's per-atom, per-element AST walk,
guess.rs:131-195), and bond guessing runs a vectorized cell-pair sweep over
the CSR cell grid instead of a per-atom neighbor iterator (guess.rs:362+).

Non-fatal issues (atoms with no matching element, multiple candidates,
over/under-bonded atoms) surface as `GuessWarning` Python warnings carrying
the same info the reference packs into its *Warning error variants; the
system IS modified, matching reference behaviour.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.elements import Elements
from ..errors import ElementError, GuessWarning, SelectError

DEFAULT_RADIUS_FACTOR = 0.55  # reference: guess.rs:19


class GuessMixin:
    # ------------------------------------------------------------- elements
    def guess_elements(self, elements: Elements | None = None):
        """Assign elements to all atoms (reference: guess.rs:114)."""
        self._guess_elements_partial(elements or Elements.default(), for_all=True)

    def guess_elements_unknown(self, elements: Elements | None = None):
        """Assign elements only to atoms without one (reference: guess.rs:125)."""
        self._guess_elements_partial(elements or Elements.default(), for_all=False)

    def _element_masks(self, elements: Elements) -> list[tuple[str, np.ndarray]]:
        from ..select.compile import evaluate_mask

        masks = []
        for name, elem in elements.elements.items():
            if elem.select is None:
                continue
            try:
                masks.append((name, evaluate_mask(elem.select, self)))
            except SelectError as e:
                raise ElementError(
                    f"invalid query of element '{name}': {e}", code="InvalidQuery"
                ) from e
        return masks

    def _guess_elements_partial(self, elements: Elements, for_all: bool):
        n = self.get_n_atoms()
        masks = self._element_masks(elements)

        eligible = np.ones(n, dtype=bool)
        if not for_all:
            has_el = (self.topology.element_name.values() != "") | (
                self.topology.element_symbol.values() != ""
            )
            eligible = ~has_el

        if masks:
            stack = np.stack([m for _, m in masks])  # [E, N]
            match_count = stack.sum(axis=0)
            first = np.argmax(stack, axis=0)  # first matching element index
            any_match = stack.any(axis=0)
        else:
            match_count = np.zeros(n, np.int64)
            first = np.zeros(n, np.int64)
            any_match = np.zeros(n, bool)

        no_elements = []
        multiple: dict[tuple, list[int]] = {}
        names = [name for name, _ in masks]
        for a in np.nonzero(eligible)[0]:
            if not any_match[a]:
                no_elements.append(int(a) + 1)
                continue
            ename = names[first[a]]
            self._set_atom_element_properties(int(a), elements.elements[ename])
            if match_count[a] > 1:
                key = tuple(names[e] for e in np.nonzero(stack[:, a])[0])
                multiple.setdefault(key, []).append(int(a) + 1)

        if no_elements or multiple:
            warnings.warn(
                GuessWarning(
                    f"element guessing: {len(no_elements)} atom(s) matched no element; "
                    f"{sum(len(v) for v in multiple.values())} atom(s) matched multiple "
                    f"elements {sorted(set(k for k in multiple))}"
                ),
                stacklevel=3,
            )

    def _set_atom_element_properties(self, index: int, elem):
        """reference: set_atom_properties (guess.rs:520)."""
        topo = self.topology
        topo.element_name.set(index, elem.name)
        if elem.symbol is not None:
            topo.element_symbol.set(index, elem.symbol)
        if elem.mass is not None:
            topo.mass[index] = elem.mass
            topo.has_mass[index] = True
        if elem.vdw is not None:
            topo.vdw[index] = elem.vdw
            topo.has_vdw[index] = True
        if elem.expected_max_bonds is not None:
            topo.expected_max_bonds[index] = elem.expected_max_bonds
            topo.has_expected_max_bonds[index] = True
        if elem.expected_min_bonds is not None:
            topo.expected_min_bonds[index] = elem.expected_min_bonds
            topo.has_expected_min_bonds[index] = True

    # ------------------------------------------------------------- properties
    def guess_properties(self, elements: Elements | None = None):
        """Assign mass/vdw/bond expectations from already-assigned element
        names (reference: guess.rs:255)."""
        elements = elements or Elements.default()
        topo = self.topology
        info = {"no_element": [], "not_recognized": [], "no_mass": [], "no_vdw": [],
                "no_max_bonds": [], "no_min_bonds": []}
        for a in range(self.get_n_atoms()):
            elname = topo.element_name.get(a)
            if not elname:
                info["no_element"].append(a + 1)
                continue
            elem = elements.get(elname)
            if elem is None:
                info["not_recognized"].append(a + 1)
                continue
            if elem.mass is None:
                info["no_mass"].append(a + 1)
            else:
                topo.mass[a] = elem.mass
                topo.has_mass[a] = True
            if elem.vdw is None:
                info["no_vdw"].append(a + 1)
            else:
                topo.vdw[a] = elem.vdw
                topo.has_vdw[a] = True
            if elem.expected_max_bonds is None:
                info["no_max_bonds"].append(a + 1)
            else:
                topo.expected_max_bonds[a] = elem.expected_max_bonds
                topo.has_expected_max_bonds[a] = True
            if elem.expected_min_bonds is None:
                info["no_min_bonds"].append(a + 1)
            else:
                topo.expected_min_bonds[a] = elem.expected_min_bonds
                topo.has_expected_min_bonds[a] = True
        if any(info.values()):
            warnings.warn(
                GuessWarning("property guessing incomplete: " +
                             ", ".join(f"{k}={len(v)}" for k, v in info.items() if v)),
                stacklevel=2,
            )

    # ------------------------------------------------------------- bonds
    def guess_bonds(self, radius_factor: float | None = None):
        """Guess bonds from vdw radii (reference: guess.rs:362):
        bond if distance < radius_factor * (vdw_i + vdw_j)."""
        from ..core.cellgrid import CellGrid
        from ..errors import CellGridError
        from ..ops import pbc

        n = self.get_n_atoms()
        if n == 0:
            return
        factor = radius_factor if radius_factor is not None else DEFAULT_RADIUS_FACTOR
        topo = self.topology

        has_vdw = topo.has_vdw
        no_vdw = (np.nonzero(~has_vdw)[0] + 1).tolist()
        max_vdw = float(topo.vdw[has_vdw].max()) if has_vdw.any() else 0.0
        cell = 2.0 * factor * max_vdw
        if cell <= 0.0:
            raise ElementError("no van der Waals radii available", code="BondGuessError")

        try:
            grid = CellGrid(self, "all", cell)
        except CellGridError as e:
            raise ElementError(str(e), code="BondGuessError") from e

        box = self.box_lengths().astype(np.float32)
        pos = self.positions.astype(np.float32, copy=False)
        vdw = topo.vdw

        # vectorized candidate generation over the 27-neighborhood (one CSR
        # gather per relative offset, like the h-bond kernel) instead of a
        # Python loop over cell pairs
        ncells = grid.ncells
        sorted_atoms = grid.sorted_atoms
        cell_off = grid.offsets
        wrapped = np.asarray(pbc.wrap(pos, box))
        coords = np.minimum(
            (wrapped / grid.cell_size).astype(np.int64), ncells - 1
        )

        def axis_offsets(nc):
            out, seen = [], set()
            for d in (-1, 0, 1):
                m = d % nc
                if m not in seen:
                    seen.add(m)
                    out.append(d)
            return out

        pair_i, pair_j = [], []
        for dx in axis_offsets(int(ncells[0])):
            for dy in axis_offsets(int(ncells[1])):
                for dz in axis_offsets(int(ncells[2])):
                    nb0 = (coords[:, 0] + dx) % ncells[0]
                    nb1 = (coords[:, 1] + dy) % ncells[1]
                    nb2 = (coords[:, 2] + dz) % ncells[2]
                    cid = (nb0 * ncells[1] + nb1) * ncells[2] + nb2
                    s = cell_off[cid]
                    cnt = cell_off[cid + 1] - s
                    nz = np.nonzero(cnt)[0]
                    if nz.shape[0] == 0:
                        continue
                    c = cnt[nz]
                    rep_i = np.repeat(nz, c)
                    grp = np.repeat(np.cumsum(c) - c, c)
                    within = np.arange(rep_i.shape[0]) - grp
                    rep_j = sorted_atoms[np.repeat(s[nz], c) + within]
                    keep = rep_i < rep_j  # dedupe unordered pairs + no self
                    pair_i.append(rep_i[keep])
                    pair_j.append(rep_j[keep])

        pairs = set()
        if pair_i:
            pi = np.concatenate(pair_i)
            pj = np.concatenate(pair_j)
            ok = has_vdw[pi] & has_vdw[pj]
            pi, pj = pi[ok], pj[ok]
            d = np.asarray(pbc.min_image(pos[pi] - pos[pj], box))
            dist = np.sqrt(np.einsum("ij,ij->i", d, d))
            limit = (factor * (vdw[pi] + vdw[pj])).astype(np.float32)
            hit = dist < limit
            pairs = set(zip(pi[hit].tolist(), pj[hit].tolist()))

        topo.set_bonds_from_pairs(pairs)

        # over/under-bonded warnings (reference: check_unexpected_bonds)
        n_bonded = np.array([len(b) for b in topo.bonded])
        too_many = np.nonzero(topo.has_expected_max_bonds & (n_bonded > topo.expected_max_bonds))[0]
        too_few = np.nonzero(topo.has_expected_min_bonds & (n_bonded < topo.expected_min_bonds))[0]
        if no_vdw or len(too_many) or len(too_few):
            warnings.warn(
                GuessWarning(
                    f"bond guessing: {len(no_vdw)} atom(s) without vdw, "
                    f"{len(too_many)} over-bonded, {len(too_few)} under-bonded"
                ),
                stacklevel=2,
            )
