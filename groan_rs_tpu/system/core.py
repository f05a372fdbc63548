"""System: the central façade.

Batched re-design of the reference `System` (`src/system/mod.rs:38-73`).
The reference's `Vec<Atom>` (AoS) becomes:

- `topology`  — static SoA metadata (`core.topology.Topology`)
- `positions / velocities / forces` — `[N, 3]` float32 numpy arrays with
  per-atom presence masks (the reference's per-atom `Option<Vector3D>`)
- `groups`    — name -> `Group` (run-length `AtomContainer` + ndx flag)

Device kernels consume `frame_state()` (a pytree of jnp arrays) or batched
`[B, N, 3]` frame stacks produced by the trajectory readers; this class is
the host-side mutable view for API parity with the ~150 reference methods
(spread across the sibling mixin modules).
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.atom import Atom
from ..core.container import AtomContainer
from ..core.simbox import SimBox, simbox_check
from ..core.topology import Topology
from ..errors import GroupError

#: characters forbidden in group/label names (reference: auxiliary.rs:37)
FORBIDDEN_NAME_CHARS = "'\"&|!@()<>="


def name_is_valid(name: str) -> bool:
    if not name or not name.strip():
        return False
    return not any(c in FORBIDDEN_NAME_CHARS for c in name)


class GroupOverwriteWarning(UserWarning):
    """reference: GroupError::AlreadyExistsWarning (non-fatal overwrite)."""


class Group:
    """A named selection (reference: `src/structures/group.rs:23`)."""

    __slots__ = ("atoms", "print_ndx")

    def __init__(self, atoms: AtomContainer, print_ndx: bool = True):
        self.atoms = atoms
        self.print_ndx = print_ndx

    def get_atoms(self) -> AtomContainer:
        """reference: group.rs:30."""
        return self.atoms

    def get_n_atoms(self) -> int:
        return self.atoms.get_n_atoms()

    def copy(self) -> "Group":
        return Group(AtomContainer(self.atoms.blocks.copy()), self.print_ndx)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_indices(cls, indices, n_atoms: int) -> "Group":
        """reference: group.rs:86 (out-of-range indices are dropped)."""
        return cls(AtomContainer.from_indices(indices, n_atoms))

    @classmethod
    def from_ranges(cls, ranges, n_atoms: int) -> "Group":
        """reference: group.rs:74."""
        return cls(AtomContainer.from_ranges(ranges, n_atoms))

    @staticmethod
    def _query_mask(query: str, system):
        """Parse + evaluate with the same error wrapping every other
        query entry point uses (GroupError, code InvalidQuery)."""
        from ..errors import GroupError, SelectError
        from ..select import evaluate_mask, parse_query

        try:
            return evaluate_mask(parse_query(query), system)
        except SelectError as e:
            raise GroupError(f"invalid query '{query}': {e}",
                             code="InvalidQuery") from e

    @classmethod
    def from_query(cls, query: str, system) -> "Group":
        """reference: group.rs:35 — GSL query evaluated against `system`."""
        return cls(AtomContainer.from_mask(cls._query_mask(query, system)))

    @classmethod
    def from_query_and_geometry(cls, query: str, geometry, system) -> "Group":
        """reference: group.rs:43 — query AND inside(shape)."""
        return cls.from_query_and_geometries(query, [geometry], system)

    @classmethod
    def from_query_and_geometries(cls, query: str, geometries,
                                  system) -> "Group":
        """reference: group.rs:58."""
        import numpy as np

        from ..errors import GroupError

        if not system.has_box():
            raise GroupError("system has no simulation box",
                             code="InvalidSimBox")
        if not system.simbox.is_orthogonal():
            raise GroupError("simulation box is not orthogonal",
                             code="InvalidSimBox")
        mask = cls._query_mask(query, system)
        box = system.simbox.to_lengths_vec()
        mask = mask & system.has_position
        for geom in geometries:
            mask = mask & np.asarray(geom.inside(system.positions, box))
        return cls(AtomContainer.from_mask(mask))

    # ------------------------------------------------------------ algebra
    @staticmethod
    def union(group1: "Group", group2: "Group") -> "Group":
        """reference: group.rs:318."""
        return Group(group1.atoms.union(group2.atoms))

    @staticmethod
    def intersection(group1: "Group", group2: "Group") -> "Group":
        """reference: group.rs:328."""
        return Group(group1.atoms.intersection(group2.atoms))

    def write_ndx(self, stream, name: str):
        """Write this group as one ndx section (reference: group.rs:298)."""
        from ..io.ndx import write_ndx_group

        write_ndx_group(stream, name, self)


class SystemCore:
    """Construction, state, groups registry primitives."""

    def __init__(self, name: str, topology: Topology, simbox: SimBox | None = None,
                 positions: np.ndarray | None = None,
                 velocities: np.ndarray | None = None,
                 forces: np.ndarray | None = None,
                 has_position: np.ndarray | None = None,
                 has_velocity: np.ndarray | None = None,
                 has_force: np.ndarray | None = None):
        n = topology.n_atoms
        self.name = name
        self.topology = topology
        self.simbox = simbox

        def init_vec(arr, present_default):
            if arr is None:
                return (np.zeros((n, 3), dtype=np.float32), np.zeros(n, dtype=bool))
            arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float32).reshape(n, 3))
            present = (
                np.ones(n, dtype=bool) if present_default is None
                else np.asarray(present_default, dtype=bool).reshape(n)
            )
            return arr, present

        self.positions, self.has_position = init_vec(positions, has_position)
        self.velocities, self.has_velocity = init_vec(velocities, has_velocity)
        self.forces, self.has_force = init_vec(forces, has_force)

        self.step: int = 0
        self.time: float = 0.0
        self.precision: int = 100
        self.lambda_: float = 0.0

        self.groups: dict[str, Group] = {}
        self.labeled_atoms: dict[str, int] = {}
        self._traj_writers: dict = {}

        # reserved groups 'all' / 'All' (reference: system/mod.rs:156)
        everything = AtomContainer.from_ranges([(0, n - 1)]) if n else AtomContainer()
        self.groups["all"] = Group(everything, print_ndx=False)
        self.groups["All"] = Group(AtomContainer(everything.blocks.copy()), print_ndx=False)

    # ------------------------------------------------------------- basic getters
    def get_name(self) -> str:
        return self.name

    def get_n_atoms(self) -> int:
        return self.topology.n_atoms

    def get_box(self) -> SimBox | None:
        return self.simbox

    def get_box_copy(self) -> SimBox | None:
        return None if self.simbox is None else SimBox(*iter(self.simbox))

    def set_box(self, simbox: SimBox | None):
        self.simbox = simbox

    def has_box(self) -> bool:
        return self.simbox is not None and not self.simbox.is_zero()

    def get_box_center(self) -> np.ndarray:
        sb = simbox_check(self.simbox)
        return np.array([sb.x / 2.0, sb.y / 2.0, sb.z / 2.0], dtype=np.float32)

    def get_step(self) -> int:
        return self.step

    def set_step(self, v: int):
        self.step = int(v)

    def get_time(self) -> float:
        return self.time

    def set_time(self, v: float):
        self.time = float(v)

    def get_precision(self) -> int:
        return self.precision

    def set_precision(self, v: int):
        self.precision = int(v)

    def get_lambda(self) -> float:
        return self.lambda_

    def set_lambda(self, v: float):
        self.lambda_ = float(v)

    def get_mol_references(self) -> np.ndarray:
        return self.topology.mol_references()

    # ------------------------------------------------------------- atoms access
    def get_atom(self, index: int) -> Atom:
        from ..errors import AtomError

        if not (0 <= index < self.topology.n_atoms):
            raise AtomError(f"atom index {index} out of range", code="OutOfRange")
        return Atom(self, index)

    def get_atom_copy(self, index: int) -> Atom:
        return self.get_atom(index)

    def atoms_iter(self):
        """All atoms as a chainable AtomIterator (reference:
        iterating.rs atoms_iter; adaptors per iterators.rs:842,1053)."""
        from .iterating import AtomIterator

        return AtomIterator(self, np.arange(self.topology.n_atoms))

    atoms_iter_mut = atoms_iter  # Python atoms views are always writable

    # ------------------------------------------------------------- group primitives
    def get_groups(self):
        return self.groups

    def get_n_groups(self) -> int:
        return len(self.groups)

    def group_exists(self, name: str) -> bool:
        return name in self.groups

    def group_names(self) -> list[str]:
        return list(self.groups.keys())

    def group_get_n_atoms(self, name: str) -> int:
        return self._get_group(name).get_n_atoms()

    def group_isempty(self, name: str) -> bool:
        """True if the group exists and contains no atoms
        (reference: groups.rs:772 System::group_isempty)."""
        return self._get_group(name).get_n_atoms() == 0

    def group_isin(self, name: str, index: int) -> bool:
        return self._get_group(name).atoms.isin(index)

    def group_is_empty(self, name: str) -> bool:
        return self._get_group(name).get_n_atoms() == 0

    def _get_group(self, name: str) -> Group:
        try:
            return self.groups[name]
        except KeyError:
            raise GroupError(f"group '{name}' does not exist", code="NotFound") from None

    def _add_group(self, name: str, group: Group):
        if not name_is_valid(name):
            raise GroupError(f"invalid group name '{name}'", code="InvalidName")
        if name in self.groups:
            warnings.warn(
                f"group '{name}' already existed and was overwritten",
                GroupOverwriteWarning,
                stacklevel=3,
            )
        self.groups[name] = group

    def group_indices(self, name: str) -> np.ndarray:
        """Sorted atom indices of a group (gather array for device kernels)."""
        return self._get_group(name).atoms.indices()

    def group_mask(self, name: str) -> np.ndarray:
        """Boolean mask of a group over all atoms."""
        return self._get_group(name).atoms.mask(self.topology.n_atoms)

    # ------------------------------------------------------------- labels access
    def get_labeled_atoms(self) -> dict:
        return self.labeled_atoms

    # ------------------------------------------------------------- copying
    def copy(self) -> "SystemCore":
        new = object.__new__(type(self))
        new.name = self.name
        new.topology = self.topology.copy()
        new.simbox = self.get_box_copy()
        new.positions = self.positions.copy()
        new.has_position = self.has_position.copy()
        new.velocities = self.velocities.copy()
        new.has_velocity = self.has_velocity.copy()
        new.forces = self.forces.copy()
        new.has_force = self.has_force.copy()
        new.step = self.step
        new.time = self.time
        new.precision = self.precision
        new.lambda_ = self.lambda_
        new.groups = {k: v.copy() for k, v in self.groups.items()}
        new.labeled_atoms = dict(self.labeled_atoms)
        new._traj_writers = {}
        return new

    # ------------------------------------------------------------- device views
    def frame_state(self):
        """Current frame as a pytree of device-ready arrays."""
        import jax.numpy as jnp

        box = (
            jnp.asarray(self.simbox.to_lengths_vec())
            if self.simbox is not None
            else jnp.zeros(3, jnp.float32)
        )
        return {
            "positions": jnp.asarray(self.positions),
            "box": box,
            "step": jnp.asarray(self.step, jnp.int64 if False else jnp.int32),
            "time": jnp.asarray(self.time, jnp.float32),
        }

    def box_lengths(self) -> np.ndarray:
        sb = simbox_check(self.simbox)
        return sb.to_lengths_vec()


def _extract_system(system, indices, name: str):
    """Build a new System holding only `indices` (reference analogue:
    System::new(name, system.group_extract(g), box), mod.rs:453,479)."""
    from . import System

    new = System(name, system.topology.subset(indices), system.get_box_copy())
    idx = np.asarray(indices, np.int64)
    new.positions = system.positions[idx].copy()
    new.has_position = system.has_position[idx].copy()
    new.velocities = system.velocities[idx].copy()
    new.has_velocity = system.has_velocity[idx].copy()
    new.forces = system.forces[idx].copy()
    new.has_force = system.has_force[idx].copy()
    new.set_step(system.get_step())
    new.set_time(system.get_time())
    return new


class SystemExtrasMixin:
    """Reference-named convenience methods (API-parity aliases and small
    predicates from system/mod.rs)."""

    # ------------------------------------------------------------- atoms
    def get_atoms(self) -> list:
        """All atoms as views (reference: System::get_atoms)."""
        return [self.get_atom(i) for i in range(self.get_n_atoms())]

    def get_atoms_copy(self) -> list:
        """reference: System::get_atoms_copy (views over a copied System)."""
        return self.copy().get_atoms()

    def get_atom_mut(self, index: int):
        """Views are always writable; alias of get_atom (mod.rs)."""
        return self.get_atom(index)

    def has_positions(self) -> bool:
        return bool(self.has_position.all()) and self.get_n_atoms() > 0

    def has_velocities(self) -> bool:
        return bool(self.has_velocity.all()) and self.get_n_atoms() > 0

    def has_forces(self) -> bool:
        return bool(self.has_force.all()) and self.get_n_atoms() > 0

    def has_duplicate_atom_numbers(self) -> bool:
        return len(np.unique(self.topology.atomnum)) != self.get_n_atoms()

    # ------------------------------------------------------------- box
    def get_box_mut(self):
        return self.get_box()

    def reset_box(self):
        """reference: System::reset_box."""
        self.set_box(None)

    def reset_mol_references(self):
        """Invalidate the cached molecule decomposition (recomputed on next
        use; reference: System::reset_mol_references)."""
        self.topology._invalidate_bonds()


# extra reference-named aliases attached to the extras mixin
def _get_groups_copy(self):
    """reference: System::get_groups_copy."""
    return {name: g.copy() for name, g in self.groups.items()}


SystemExtrasMixin.get_groups_copy = _get_groups_copy
SystemExtrasMixin.group_isempty = lambda self, name: self.group_is_empty(name)
