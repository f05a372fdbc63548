"""Topology: structure-of-arrays static atom metadata.

Batched re-design of the reference's AoS `Atom` struct
(`src/structures/atom.rs:23-71`): the 17 per-atom fields become columnar
numpy arrays with string fields interned (`StrColumn`: unique categories +
int32 codes), so the GSL selection compiler evaluates name predicates over
the few unique categories and gathers masks with one `table[codes]` lookup
instead of the reference's per-atom AST interpreter
(`src/structures/group.rs:186-290`).

Bonds are kept as per-atom sorted adjacency (mutable) with a lazily built
CSR + molecule-id cache used by `mol with` selections, make-whole, and
molecule iteration (the reference walks a BFS per query,
`src/system/iterating.rs:399`; here connected components are computed once
and invalidated on bond edits).
"""

from __future__ import annotations

import numpy as np

__all__ = ["StrColumn", "Topology"]


class StrColumn:
    """Interned string column: `categories` list + int32 `codes`."""

    __slots__ = ("categories", "codes", "_lookup")

    def __init__(self, values=None, categories=None, codes=None):
        if values is not None:
            values = np.asarray(values)
            if values.dtype.kind not in ("S", "U"):
                values = values.astype(object)
            # unique on the native S/U dtype: byte-level comparison is
            # several times faster than object-array sorting at 1M atoms
            cats, codes = np.unique(values, return_inverse=True)
            self.categories = [
                c.decode() if isinstance(c, bytes) else str(c) for c in cats
            ]
            self.codes = codes.astype(np.int32)
        else:
            self.categories = list(categories or [])
            self.codes = (
                np.empty(0, dtype=np.int32) if codes is None else np.asarray(codes, dtype=np.int32)
            )
        self._lookup = {c: i for i, c in enumerate(self.categories)}

    def __len__(self):
        return self.codes.shape[0]

    def __getitem__(self, i) -> str:
        return self.categories[self.codes[i]]

    def get(self, i) -> str:
        return self.categories[self.codes[i]]

    def set(self, i, value: str):
        code = self._lookup.get(value)
        if code is None:
            code = len(self.categories)
            self.categories.append(value)
            self._lookup[value] = code
        self.codes[i] = code

    def values(self) -> np.ndarray:
        cats = np.asarray(self.categories, dtype=object)
        if not len(cats):
            return np.empty(0, dtype=object)
        return cats[self.codes]

    # ------------------------------------------------------------ vectorized matching
    def mask_equal(self, name: str) -> np.ndarray:
        code = self._lookup.get(name)
        if code is None:
            return np.zeros(len(self), dtype=bool)
        return self.codes == code

    def mask_predicate(self, pred) -> np.ndarray:
        """Evaluate `pred(category) -> bool` per unique category, gather."""
        table = np.fromiter((bool(pred(c)) for c in self.categories), dtype=bool,
                            count=len(self.categories))
        if table.size == 0:
            return np.zeros(len(self), dtype=bool)
        return table[self.codes]

    def copy(self) -> "StrColumn":
        return StrColumn(categories=list(self.categories), codes=self.codes.copy())

    def take(self, idx) -> "StrColumn":
        return StrColumn(categories=list(self.categories), codes=self.codes[idx])


def _opt_float(n):
    return np.full(n, np.nan, dtype=np.float32), np.zeros(n, dtype=bool)


class Topology:
    """Columnar static atom metadata + bond graph."""

    def __init__(self, n_atoms: int = 0):
        n = int(n_atoms)
        self.n_atoms = n
        self.resnum = np.zeros(n, dtype=np.int64)
        self.resname = StrColumn(categories=[], codes=np.zeros(n, dtype=np.int32))
        self.atomname = StrColumn(categories=[], codes=np.zeros(n, dtype=np.int32))
        self.atomnum = np.zeros(n, dtype=np.int64)
        # '' encodes "no chain"
        self.chain = StrColumn(categories=[""], codes=np.zeros(n, dtype=np.int32))
        self.charge, self.has_charge = _opt_float(n)
        self.mass, self.has_mass = _opt_float(n)
        self.vdw, self.has_vdw = _opt_float(n)
        self.expected_min_bonds = np.zeros(n, dtype=np.int32)
        self.has_expected_min_bonds = np.zeros(n, dtype=bool)
        self.expected_max_bonds = np.zeros(n, dtype=np.int32)
        self.has_expected_max_bonds = np.zeros(n, dtype=bool)
        # '' encodes "no element"
        self.element_name = StrColumn(categories=[""], codes=np.zeros(n, dtype=np.int32))
        self.element_symbol = StrColumn(categories=[""], codes=np.zeros(n, dtype=np.int32))
        # mutable adjacency: list of sorted lists, built lazily (1M empty
        # lists cost ~1 s; bond-less structure reads never need them)
        self._bonded_list: list | None = None
        self._invalidate_bonds()

    # ------------------------------------------------------------ construction
    @classmethod
    def from_columns(cls, resnum, resname, atomname, atomnum, **optional) -> "Topology":
        resnum = np.asarray(resnum, dtype=np.int64)
        topo = cls(resnum.shape[0])
        topo.resnum = resnum
        topo.resname = StrColumn(values=resname)
        topo.atomname = StrColumn(values=atomname)
        topo.atomnum = np.asarray(atomnum, dtype=np.int64)
        if "chain" in optional and optional["chain"] is not None:
            topo.chain = StrColumn(values=optional["chain"])
        for field in ("charge", "mass", "vdw"):
            if field in optional and optional[field] is not None:
                vals = np.asarray(optional[field], dtype=np.float32)
                setattr(topo, field, vals)
                present = optional.get("has_" + field)
                if present is None:
                    present = ~np.isnan(vals)
                setattr(topo, "has_" + field, np.asarray(present, dtype=bool))
        return topo

    # ------------------------------------------------------------ bonds
    def _invalidate_bonds(self):
        self._csr = None
        self._molecule_id = None
        self._mol_references = None
        self._n_molecules = None

    @property
    def bonded(self) -> list:
        if self._bonded_list is None:
            self._bonded_list = [[] for _ in range(self.n_atoms)]
        return self._bonded_list

    @bonded.setter
    def bonded(self, value):
        self._bonded_list = value

    def has_bonds(self) -> bool:
        if self._bonded_list is None:
            return False
        return any(len(b) for b in self._bonded_list)

    def add_bond(self, i: int, j: int):
        """reference: System::add_bond (modifying.rs:235)."""
        from ..errors import AtomError

        n = self.n_atoms
        if i == j:
            raise AtomError(f"atom cannot bond to itself (index {i})", code="SelfBonding")
        if not (0 <= i < n) or not (0 <= j < n):
            raise AtomError(f"bond index out of range: {i}-{j}", code="OutOfRange")
        if j not in self.bonded[i]:
            self.bonded[i].append(j)
            self.bonded[i].sort()
        if i not in self.bonded[j]:
            self.bonded[j].append(i)
            self.bonded[j].sort()
        self._invalidate_bonds()

    def clear_bonds(self):
        self._bonded_list = None
        self._invalidate_bonds()

    def set_bonds_from_pairs(self, pairs):
        """Bulk bond assignment from an iterable/array of (i, j) pairs."""
        adj = [[] for _ in range(self.n_atoms)]
        pairs = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
        for i, j in pairs:
            adj[i].append(int(j))
            adj[j].append(int(i))
        self.bonded = [sorted(set(b)) for b in adj]
        self._invalidate_bonds()

    def bonds_csr(self):
        """CSR adjacency (offsets int64[N+1], neighbours int64[nnz])."""
        if self._csr is None:
            if self._bonded_list is None:  # bond-less: empty CSR, no lists
                offsets = np.zeros(self.n_atoms + 1, dtype=np.int64)
                self._csr = (offsets, np.empty(0, dtype=np.int64))
                return self._csr
            counts = np.fromiter((len(b) for b in self.bonded), dtype=np.int64,
                                 count=self.n_atoms)
            offsets = np.zeros(self.n_atoms + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            flat = np.fromiter(
                (j for b in self.bonded for j in b), dtype=np.int64, count=int(offsets[-1])
            )
            self._csr = (offsets, flat)
        return self._csr

    def molecule_ids(self) -> np.ndarray:
        """Connected-component id per atom (bond graph).

        Replaces the reference's per-query BFS (`iterating.rs:399`) with a
        one-time union-find style labelling; `mol with` selections become a
        vectorized `isin` over molecule ids.
        """
        if self._molecule_id is None:
            offsets, flat = self.bonds_csr()
            n = self.n_atoms
            mol = np.full(n, -1, dtype=np.int64)
            refs = []
            next_id = 0
            # iterative BFS over all atoms in index order => molecule ids are
            # ordered by their first atom (matches reference mol_references,
            # system/mod.rs:65-69)
            for start in range(n):
                if mol[start] != -1:
                    continue
                refs.append(start)
                stack = [start]
                mol[start] = next_id
                while stack:
                    a = stack.pop()
                    for k in range(offsets[a], offsets[a + 1]):
                        b = flat[k]
                        if mol[b] == -1:
                            mol[b] = next_id
                            stack.append(b)
                next_id += 1
            self._molecule_id = mol
            self._mol_references = np.asarray(refs, dtype=np.int64)
            self._n_molecules = next_id
        return self._molecule_id

    def mol_references(self) -> np.ndarray:
        """First atom index of each molecule (reference: system/mod.rs:65-69)."""
        self.molecule_ids()
        return self._mol_references

    def n_molecules(self) -> int:
        self.molecule_ids()
        return self._n_molecules

    def molecule_indices(self, atom_index: int) -> np.ndarray:
        """All atoms in the same molecule as `atom_index`, sorted."""
        mol = self.molecule_ids()
        return np.nonzero(mol == mol[atom_index])[0].astype(np.int64)

    # ------------------------------------------------------------ copy
    def copy(self) -> "Topology":
        t = Topology.__new__(Topology)
        t.n_atoms = self.n_atoms
        t.resnum = self.resnum.copy()
        t.resname = self.resname.copy()
        t.atomname = self.atomname.copy()
        t.atomnum = self.atomnum.copy()
        t.chain = self.chain.copy()
        for f in ("charge", "mass", "vdw"):
            setattr(t, f, getattr(self, f).copy())
            setattr(t, "has_" + f, getattr(self, "has_" + f).copy())
        for f in ("expected_min_bonds", "expected_max_bonds"):
            setattr(t, f, getattr(self, f).copy())
            setattr(t, "has_" + f, getattr(self, "has_" + f).copy())
        t.element_name = self.element_name.copy()
        t.element_symbol = self.element_symbol.copy()
        t._bonded_list = (None if self._bonded_list is None
                          else [list(b) for b in self._bonded_list])
        t._invalidate_bonds()
        return t

    @classmethod
    def concat(cls, topos) -> "Topology":
        """New topology concatenating `topos` in order (bond graphs
        offset; atom numbers renumbered 1..N).  Used by system-
        preparation tools (insert-molecules / solvate / genion —
        surpass; the reference has no topology assembly)."""
        topos = list(topos)
        if not topos:
            return cls(0)
        t = cls.__new__(cls)
        t.n_atoms = sum(x.n_atoms for x in topos)
        t.atomnum = np.arange(1, t.n_atoms + 1, dtype=np.int64)
        t.resnum = np.concatenate([x.resnum for x in topos])
        for f in ("resname", "atomname", "chain", "element_name",
                  "element_symbol"):
            t_col = StrColumn(values=np.concatenate(
                [getattr(x, f).values() for x in topos])) \
                if t.n_atoms else StrColumn(categories=[""],
                                            codes=np.zeros(0, np.int32))
            setattr(t, f, t_col)
        for f in ("charge", "mass", "vdw", "expected_min_bonds",
                  "expected_max_bonds"):
            setattr(t, f, np.concatenate(
                [getattr(x, f) for x in topos]))
            setattr(t, "has_" + f, np.concatenate(
                [getattr(x, "has_" + f) for x in topos]))
        bonded = []
        off = 0
        for x in topos:
            bonded.extend([j + off for j in row] for row in x.bonded)
            off += x.n_atoms
        t.bonded = bonded
        t._invalidate_bonds()
        return t

    def subset(self, indices) -> "Topology":
        """New topology of the selected atoms (bond graph restricted to the
        subset and remapped; reference analogue: `Vec<Atom>` extraction,
        system/mod.rs:453,479)."""
        idx = np.asarray(indices, np.int64)
        t = Topology.__new__(Topology)
        t.n_atoms = int(idx.shape[0])
        t.resnum = self.resnum[idx].copy()
        t.resname = self.resname.take(idx)
        t.atomname = self.atomname.take(idx)
        t.atomnum = self.atomnum[idx].copy()
        t.chain = self.chain.take(idx)
        for f in ("charge", "mass", "vdw"):
            setattr(t, f, getattr(self, f)[idx].copy())
            setattr(t, "has_" + f, getattr(self, "has_" + f)[idx].copy())
        for f in ("expected_min_bonds", "expected_max_bonds"):
            setattr(t, f, getattr(self, f)[idx].copy())
            setattr(t, "has_" + f, getattr(self, "has_" + f)[idx].copy())
        t.element_name = self.element_name.take(idx)
        t.element_symbol = self.element_symbol.take(idx)
        remap = {int(old): new for new, old in enumerate(idx)}
        t.bonded = [
            sorted(remap[j] for j in self.bonded[int(old)] if int(j) in remap)
            for old in idx
        ]
        t._invalidate_bonds()
        return t
