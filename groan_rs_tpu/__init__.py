"""groan_rs_tpu — a JAX molecular-dynamics trajectory analysis engine.

A from-scratch JAX/XLA framework with the capabilities of the groan_rs Rust
library (structure/trajectory I/O, the Groan Selection Language, PBC-aware
geometry, Bai-Breen centers, Kabsch RMSD, hydrogen bonds, grid maps,
frame-parallel map-reduce) — re-designed for accelerators: trajectories become
batched `[frames, atoms, 3]` device arrays fed by a native C++ XTC/TRR
codec, selections compile to static masks/gather indices, and per-frame
analyses run as jitted, mesh-sharded steps.

The `prelude` mirrors the reference's `groan_rs::prelude` (lib.rs:377-426).
"""

from . import errors
from .core.atom import Atom
from .core.cellgrid import CellGrid
from .core.dimension import Dimension
from .core.elements import Element, Elements
from .core.gridmap import GridMap
from .core.shapes import (
    Cylinder,
    NaiveShape,
    Rectangular,
    Shape,
    Sphere,
    TriangularPrism,
)
from .core.simbox import SimBox
from .core.vector3d import Vector3D
from .core.container import AtomContainer
from .files import FileType
from .io.traj import TrajReader, TrajWriter
from .models import (
    FitConverter,
    FrameAnalyze,
    FrameConvert,
    TrajectoryAnalysis,
    TranslateConverter,
    WrapConverter,
    analyze_iter,
    convert_iter,
)
from .parallel import traj_iter_map_reduce
from .parallel.engine import DeviceTrajectory, FrameEngine, make_mesh
from .progress import ProgressPrinter, ProgressStatus
from .system import Group, System
from .system.hbonds import HBond, HBondAnalysis, HBondChain

__version__ = "0.2.0"

__all__ = [
    "System",
    "Group",
    "Atom",
    "AtomContainer",
    "CellGrid",
    "SimBox",
    "Vector3D",
    "Dimension",
    "Shape",
    "NaiveShape",
    "Sphere",
    "Rectangular",
    "Cylinder",
    "TriangularPrism",
    "Elements",
    "Element",
    "GridMap",
    "HBond",
    "HBondChain",
    "HBondAnalysis",
    "FileType",
    "ProgressPrinter",
    "ProgressStatus",
    "TrajReader",
    "TrajWriter",
    "TrajectoryAnalysis",
    "FrameConvert",
    "FrameAnalyze",
    "TranslateConverter",
    "WrapConverter",
    "FitConverter",
    "convert_iter",
    "analyze_iter",
    "traj_iter_map_reduce",
    "DeviceTrajectory",
    "FrameEngine",
    "make_mesh",
    "errors",
    "__version__",
]


# convenience namespace matching the reference's prelude idiom
class prelude:
    System = System
    Group = Group
    Atom = Atom
    AtomContainer = AtomContainer
    CellGrid = CellGrid
    SimBox = SimBox
    Vector3D = Vector3D
    Dimension = Dimension
    Shape = Shape
    NaiveShape = NaiveShape
    Sphere = Sphere
    Rectangular = Rectangular
    Cylinder = Cylinder
    TriangularPrism = TriangularPrism
    Elements = Elements
    GridMap = GridMap
    HBond = HBond
    HBondChain = HBondChain
    HBondAnalysis = HBondAnalysis
    FileType = FileType
    ProgressPrinter = ProgressPrinter
    ProgressStatus = ProgressStatus
    TrajReader = TrajReader
    TrajWriter = TrajWriter
    TrajectoryAnalysis = TrajectoryAnalysis
