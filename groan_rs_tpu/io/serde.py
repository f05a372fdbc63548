"""System <-> YAML serialization.

reference: the `serde` feature (`system/mod.rs:36`, fixture
`test_files/serde_system.yaml`).  The YAML schema mirrors the reference's
serde output: a list of per-atom records (null for absent optionals),
`simulation_box` with the 9 Gromacs components, groups as run-length
`atom_blocks`, labeled atoms, and the frame scalars.
"""

from __future__ import annotations

import numpy as np

from ..core.container import AtomContainer
from ..core.simbox import SimBox
from ..core.topology import Topology
from ..errors import GroanError


def _opt(flag, value):
    return value if flag else None


def atom_to_dict(system, i: int) -> dict:
    topo = system.topology
    d = {
        "residue_number": int(topo.resnum[i]),
        "residue_name": topo.resname.get(i),
        "atom_number": int(topo.atomnum[i]),
        "atom_name": topo.atomname.get(i),
        "chain": topo.chain.get(i) or None,
        "charge": _opt(topo.has_charge[i], float(topo.charge[i])),
        "mass": _opt(topo.has_mass[i], float(topo.mass[i])),
        "vdw": _opt(topo.has_vdw[i], float(topo.vdw[i])),
        "expected_max_bonds": _opt(
            topo.has_expected_max_bonds[i], int(topo.expected_max_bonds[i])
        ),
        "expected_min_bonds": _opt(
            topo.has_expected_min_bonds[i], int(topo.expected_min_bonds[i])
        ),
        "element_name": topo.element_name.get(i) or None,
        "element_symbol": topo.element_symbol.get(i) or None,
        "position": [float(v) for v in system.positions[i]] if system.has_position[i] else None,
        "velocity": [float(v) for v in system.velocities[i]] if system.has_velocity[i] else None,
        "force": [float(v) for v in system.forces[i]] if system.has_force[i] else None,
        "bonded": {
            "atom_blocks": [
                {"start": int(s), "end": int(e)}
                for s, e in AtomContainer.from_indices(topo.bonded[i]).blocks
            ]
        },
    }
    return d


def system_to_dict(system) -> dict:
    sb = system.get_box()
    return {
        "name": system.get_name(),
        "atoms": [atom_to_dict(system, i) for i in range(system.get_n_atoms())],
        "simulation_box": (
            None
            if sb is None
            else {
                "v1x": float(sb.v1x), "v2y": float(sb.v2y), "v3z": float(sb.v3z),
                "v1y": float(sb.v1y), "v1z": float(sb.v1z), "v2x": float(sb.v2x),
                "v2z": float(sb.v2z), "v3x": float(sb.v3x), "v3y": float(sb.v3y),
            }
        ),
        "groups": {
            name: {
                "atoms": {
                    "atom_blocks": [
                        {"start": int(s), "end": int(e)} for s, e in g.atoms.blocks
                    ]
                },
                "print_ndx": bool(g.print_ndx),
            }
            for name, g in system.groups.items()
        },
        "labeled_atoms": dict(system.labeled_atoms),
        "simulation_step": int(system.get_step()),
        "simulation_time": float(system.get_time()),
        "precision": int(system.get_precision()),
        "lambda": float(system.get_lambda()),
        "mol_references": None,
    }


def system_from_dict(data: dict):
    from ..system import System
    from ..system.core import Group

    atoms = data.get("atoms", [])
    n = len(atoms)
    topo = Topology.from_columns(
        np.array([a["residue_number"] for a in atoms], np.int64),
        np.array([a["residue_name"] for a in atoms], object),
        np.array([a["atom_name"] for a in atoms], object),
        np.array([a["atom_number"] for a in atoms], np.int64),
        chain=np.array([a.get("chain") or "" for a in atoms], object),
    )
    for field in ("charge", "mass", "vdw"):
        vals = [a.get(field) for a in atoms]
        present = np.array([v is not None for v in vals])
        arr = np.array([v if v is not None else np.nan for v in vals], np.float32)
        setattr(topo, field, arr)
        setattr(topo, "has_" + field, present)
    for field in ("expected_max_bonds", "expected_min_bonds"):
        vals = [a.get(field) for a in atoms]
        setattr(topo, "has_" + field, np.array([v is not None for v in vals]))
        setattr(topo, field, np.array([v or 0 for v in vals], np.int32))
    from ..core.topology import StrColumn

    topo.element_name = StrColumn(values=np.array([a.get("element_name") or "" for a in atoms], object))
    topo.element_symbol = StrColumn(values=np.array([a.get("element_symbol") or "" for a in atoms], object))

    pairs = []
    for i, a in enumerate(atoms):
        for blk in (a.get("bonded") or {}).get("atom_blocks", []):
            for j in range(blk["start"], blk["end"] + 1):
                pairs.append((i, j))
    topo.set_bonds_from_pairs(pairs)

    def vecs(key):
        out = np.zeros((n, 3), np.float32)
        present = np.zeros(n, bool)
        for i, a in enumerate(atoms):
            v = a.get(key)
            if v is not None:
                out[i] = v
                present[i] = True
        return out, present

    pos, has_pos = vecs("position")
    vel, has_vel = vecs("velocity")
    frc, has_frc = vecs("force")

    sb_data = data.get("simulation_box")
    simbox = None
    if sb_data:
        simbox = SimBox(
            sb_data.get("v1x", 0.0), sb_data.get("v2y", 0.0), sb_data.get("v3z", 0.0),
            sb_data.get("v1y", 0.0), sb_data.get("v1z", 0.0), sb_data.get("v2x", 0.0),
            sb_data.get("v2z", 0.0), sb_data.get("v3x", 0.0), sb_data.get("v3y", 0.0),
        )

    system = System(
        name=data.get("name", "Unknown"),
        topology=topo,
        simbox=simbox,
        positions=pos, has_position=has_pos,
        velocities=vel, has_velocity=has_vel,
        forces=frc, has_force=has_frc,
    )
    for gname, g in (data.get("groups") or {}).items():
        blocks = [
            (blk["start"], blk["end"]) for blk in g["atoms"]["atom_blocks"]
        ]
        system.groups[gname] = Group(
            AtomContainer.from_ranges(blocks, n), bool(g.get("print_ndx", True))
        )
    system.labeled_atoms = dict(data.get("labeled_atoms") or {})
    system.set_step(data.get("simulation_step", 0))
    system.set_time(data.get("simulation_time", 0.0))
    system.set_precision(data.get("precision", 100))
    system.set_lambda(data.get("lambda", 0.0))
    return system


def _yaml():
    """PyYAML, imported only when a System is (de)serialized."""
    try:
        import yaml
    except ImportError:
        raise GroanError("System YAML serialization needs PyYAML "
                         "(pip install pyyaml)") from None
    return yaml


def system_to_yaml(system, filename=None) -> str:
    yaml = _yaml()
    # libyaml emitter: the pure-Python one takes ~50 s on a 17k-atom system
    text = yaml.dump(system_to_dict(system), Dumper=yaml.CSafeDumper,
                     sort_keys=False, default_flow_style=False)
    if filename is not None:
        with open(filename, "w") as fh:
            fh.write(text)
    return text


def system_from_yaml(source):
    """Load a System from a YAML string or file path."""
    import os

    yaml = _yaml()
    if isinstance(source, str) and "\n" not in source and os.path.exists(source):
        with open(source) as fh:
            data = yaml.load(fh, Loader=yaml.CSafeLoader)
    else:
        data = yaml.load(source, Loader=yaml.CSafeLoader)
    if not isinstance(data, dict):
        raise GroanError("invalid serialized System")
    return system_from_dict(data)
