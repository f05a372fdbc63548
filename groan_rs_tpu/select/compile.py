"""GSL mask compiler: Select AST -> boolean mask over all atoms.

Vectorized replacement of the reference's per-atom AST interpreter
(`Group::matches_select`, `src/structures/group.rs:186-290`): each AST node
evaluates to one vectorized `bool[N]` mask over the SoA topology, string
predicates are evaluated once per *unique* interned name and gathered via
codes, and `mol with` becomes an `isin` over precomputed molecule ids
instead of a BFS per atom (`src/system/iterating.rs:399`).
"""

from __future__ import annotations

import numpy as np

from ..errors import SelectError
from . import ast

__all__ = ["evaluate_mask", "select_to_mask"]


def _names_mask(col, names) -> np.ndarray:
    """OR of name matches over an interned StrColumn."""
    mask = np.zeros(len(col), dtype=bool)
    for name in names:
        if name.is_regex:
            mask |= col.mask_predicate(name.matches)
        else:
            mask |= col.mask_equal(name.raw)
    return mask


def _ranges_mask(values: np.ndarray, ranges) -> np.ndarray:
    mask = np.zeros(values.shape[0], dtype=bool)
    for start, end in ranges:
        mask |= (values >= start) & (values <= end)
    return mask


def evaluate_mask(select: ast.Select, system) -> np.ndarray:
    """Evaluate a Select tree to a `bool[N]` mask against `system`."""
    topo = system.topology
    n = topo.n_atoms

    if isinstance(select, ast.ResidueName):
        return _names_mask(topo.resname, select.names)

    if isinstance(select, ast.AtomName):
        return _names_mask(topo.atomname, select.names)

    if isinstance(select, ast.ResidueNumber):
        return _ranges_mask(topo.resnum, select.ranges)

    if isinstance(select, ast.GmxAtomNumber):
        # serial = index + 1 (reference: group.rs:210-213)
        serials = np.arange(1, n + 1, dtype=np.int64)
        return _ranges_mask(serials, select.ranges)

    if isinstance(select, ast.AtomNumber):
        return _ranges_mask(topo.atomnum, select.ranges)

    if isinstance(select, ast.Chain):
        mask = np.zeros(n, dtype=bool)
        for c in select.identifiers:
            mask |= topo.chain.mask_equal(c)
        return mask

    if isinstance(select, ast.GroupName):
        # reference semantics (select/mod.rs:156-190): a single regex may
        # match nothing as long as the WHOLE expanded name vector is
        # non-empty; a plain name that does not exist errors immediately
        mask = np.zeros(n, dtype=bool)
        any_expanded = False
        for name in select.names:
            if name.is_regex:
                for g in system.groups:
                    if name.matches(g):
                        any_expanded = True
                        mask |= system.groups[g].atoms.mask(n)
            else:
                if name.raw not in system.groups:
                    raise SelectError(
                        f"group '{name.raw}' does not exist",
                        code=SelectError.GROUP_NOT_FOUND,
                    )
                any_expanded = True
                mask |= system.groups[name.raw].atoms.mask(n)
        if not any_expanded and select.names:
            raise SelectError(
                f"no group matches regular expression '{select.names[0].raw}'",
                code=SelectError.GROUP_NOT_FOUND,
            )
        return mask

    if isinstance(select, ast.LabeledAtom):
        # same whole-vector expansion semantics as GroupName above
        mask = np.zeros(n, dtype=bool)
        any_expanded = False
        for name in select.names:
            if name.is_regex:
                for lbl in system.labeled_atoms:
                    if name.matches(lbl):
                        any_expanded = True
                        mask[system.labeled_atoms[lbl]] = True
            else:
                if name.raw not in system.labeled_atoms:
                    raise SelectError(
                        f"label '{name.raw}' does not exist",
                        code=SelectError.LABEL_NOT_FOUND,
                    )
                any_expanded = True
                mask[system.labeled_atoms[name.raw]] = True
        if not any_expanded and select.names:
            raise SelectError(
                f"no label matches regular expression '{select.names[0].raw}'",
                code=SelectError.LABEL_NOT_FOUND,
            )
        return mask

    if isinstance(select, ast.ElementName):
        mask = _names_mask(topo.element_name, select.names)
        # '' encodes "no element" and never matches (reference: group.rs:252-257)
        mask &= topo.element_name.codes != topo.element_name._lookup.get("", -1)
        return mask

    if isinstance(select, ast.ElementSymbol):
        mask = _names_mask(topo.element_symbol, select.names)
        mask &= topo.element_symbol.codes != topo.element_symbol._lookup.get("", -1)
        return mask

    if isinstance(select, ast.Molecule):
        inner = evaluate_mask(select.operand, system)
        mol_ids = topo.molecule_ids()
        matched_mols = np.unique(mol_ids[inner])
        return np.isin(mol_ids, matched_mols)

    if isinstance(select, ast.And):
        return evaluate_mask(select.left, system) & evaluate_mask(select.right, system)

    if isinstance(select, ast.Or):
        return evaluate_mask(select.left, system) | evaluate_mask(select.right, system)

    if isinstance(select, ast.Not):
        return ~evaluate_mask(select.operand, system)

    raise SelectError(f"unknown Select node {type(select).__name__}", code=SelectError.UNKNOWN)


def select_to_mask(query: str, system) -> np.ndarray:
    """Parse + evaluate a GSL query to a `bool[N]` mask."""
    from .parser import parse_query

    return evaluate_mask(parse_query(query), system)
