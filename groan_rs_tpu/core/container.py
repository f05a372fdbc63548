"""AtomContainer: run-length encoded sorted index sets.

Array-based equivalent of the reference `AtomContainer`
(`src/structures/container.rs:13-31`): groups and bond lists are stored as
sorted inclusive `[start, end]` blocks.  Unlike the reference (which walks
blocks atom-by-atom), this implementation is numpy-backed: block algebra for
union/intersection, vectorized expansion to index arrays, and direct
conversion to boolean masks / gather indices for device kernels.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AtomContainer"]


def _blocks_from_sorted_unique(idx: np.ndarray) -> np.ndarray:
    """Compress a sorted unique int array into inclusive [start, end] blocks."""
    if idx.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [idx.size - 1]))
    return np.stack([idx[starts], idx[ends]], axis=1)


class AtomContainer:
    """Sorted set of atom indices stored as inclusive blocks."""

    __slots__ = ("blocks", "_indices_cache")

    def __init__(self, blocks: np.ndarray | None = None):
        self.blocks = (
            np.empty((0, 2), dtype=np.int64)
            if blocks is None
            else np.asarray(blocks, dtype=np.int64).reshape(-1, 2)
        )
        self._indices_cache = None

    # ------------------------------------------------------------ constructors
    @classmethod
    def empty(cls) -> "AtomContainer":
        return cls()

    @classmethod
    def from_indices(cls, indices, n_atoms: int | None = None) -> "AtomContainer":
        """From an arbitrary iterable of indices; deduplicates and sorts.
        Indices >= n_atoms are dropped (reference behaviour, container.rs)."""
        idx = np.unique(np.asarray(list(indices) if not isinstance(indices, np.ndarray) else indices, dtype=np.int64))
        if n_atoms is not None:
            idx = idx[(idx >= 0) & (idx < n_atoms)]
        return cls(_blocks_from_sorted_unique(idx))

    @classmethod
    def from_ranges(cls, ranges, n_atoms: int | None = None) -> "AtomContainer":
        """From inclusive (start, end) ranges; overlapping ranges are merged."""
        norm = []
        for start, end in ranges:
            if n_atoms is not None:
                end = min(end, n_atoms - 1)
            if end < start or end < 0:
                continue
            norm.append((max(0, int(start)), int(end)))
        if not norm:
            return cls()
        norm.sort()
        merged = [list(norm[0])]
        for s, e in norm[1:]:
            if s <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return cls(np.asarray(merged, dtype=np.int64))

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "AtomContainer":
        idx = np.nonzero(np.asarray(mask))[0].astype(np.int64)
        return cls(_blocks_from_sorted_unique(idx))

    # ------------------------------------------------------------ conversions
    def indices(self) -> np.ndarray:
        """Expanded sorted index array (cached)."""
        if self._indices_cache is None:
            if self.blocks.shape[0] == 0:
                self._indices_cache = np.empty(0, dtype=np.int64)
            else:
                parts = [np.arange(s, e + 1, dtype=np.int64) for s, e in self.blocks]
                self._indices_cache = np.concatenate(parts)
        return self._indices_cache

    def mask(self, n_atoms: int) -> np.ndarray:
        out = np.zeros(n_atoms, dtype=bool)
        for s, e in self.blocks:
            out[s : e + 1] = True
        return out

    # ------------------------------------------------------------ queries
    def get_n_atoms(self) -> int:
        if self.blocks.shape[0] == 0:
            return 0
        return int(np.sum(self.blocks[:, 1] - self.blocks[:, 0] + 1))

    def __len__(self) -> int:
        return self.get_n_atoms()

    def is_empty(self) -> bool:
        return self.blocks.shape[0] == 0

    def isin(self, index: int) -> bool:
        """Binary search over blocks (reference: container.rs:254)."""
        if self.blocks.shape[0] == 0:
            return False
        pos = int(np.searchsorted(self.blocks[:, 0], index, side="right")) - 1
        return pos >= 0 and index <= self.blocks[pos, 1]

    def first(self) -> int | None:
        return int(self.blocks[0, 0]) if self.blocks.shape[0] else None

    def last(self) -> int | None:
        return int(self.blocks[-1, 1]) if self.blocks.shape[0] else None

    def __iter__(self):
        for s, e in self.blocks:
            yield from range(int(s), int(e) + 1)

    def iter(self):
        """reference: container.rs iter (alias of Python iteration)."""
        return self.__iter__()

    def __eq__(self, other) -> bool:
        return isinstance(other, AtomContainer) and np.array_equal(self.blocks, other.blocks)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AtomContainer({self.get_n_atoms()} atoms, {self.blocks.shape[0]} blocks)"

    # ------------------------------------------------------------ set algebra
    def union(self, other: "AtomContainer") -> "AtomContainer":
        """reference: container.rs:272"""
        if self.is_empty():
            return AtomContainer(other.blocks.copy())
        if other.is_empty():
            return AtomContainer(self.blocks.copy())
        allb = np.concatenate([self.blocks, other.blocks])
        order = np.argsort(allb[:, 0], kind="stable")
        allb = allb[order]
        merged = [allb[0].tolist()]
        for s, e in allb[1:]:
            if s <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return AtomContainer(np.asarray(merged, dtype=np.int64))

    def intersection(self, other: "AtomContainer") -> "AtomContainer":
        """reference: container.rs:283"""
        out = []
        i = j = 0
        a, b = self.blocks, other.blocks
        while i < len(a) and j < len(b):
            s = max(a[i, 0], b[j, 0])
            e = min(a[i, 1], b[j, 1])
            if s <= e:
                out.append([s, e])
            if a[i, 1] < b[j, 1]:
                i += 1
            else:
                j += 1
        return AtomContainer(np.asarray(out, dtype=np.int64).reshape(-1, 2))

    def difference(self, other: "AtomContainer") -> "AtomContainer":
        if self.is_empty() or other.is_empty():
            return AtomContainer(self.blocks.copy())
        mine = self.indices()
        keep = mine[~np.isin(mine, other.indices())]
        return AtomContainer(_blocks_from_sorted_unique(keep))

    def add(self, index: int) -> "AtomContainer":
        """Return a new container with `index` inserted."""
        return self.union(AtomContainer.from_indices([index]))
