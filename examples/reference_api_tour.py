"""Port of EVERY front-page example from the reference's documentation
(`/root/reference/src/lib.rs:155-350`) to groan_rs_tpu — a runnable
line-by-line parity check of the documented user-facing API.

Run:  python examples/reference_api_tour.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

from groan_rs_tpu import Cylinder, Dimension, ProgressPrinter, System

TF = os.environ.get("GROAN_TEST_FILES", "/root/reference/test_files")
tmp = tempfile.mkdtemp(prefix="groan_tour_")


# ------------------------------------------------- analyzing structure files
# (lib.rs "Analyzing structure files")
system = System.from_file(os.path.join(TF, "example.gro"))
system.read_ndx(os.path.join(TF, "index.ndx"))
center = system.group_get_center("Protein")
print("protein center:", np.round(np.asarray(center), 4))

# ------------------------------------------------- selecting atoms
# (lib.rs "Selecting atoms")
n = sum(1 for _ in system.selection_iter("serial 1-23 or (resname POPC and name P)"))
print("selection_iter atoms:", n)
iterator = system.selection_iter("@protein")  # macro autodetection
print("@protein atoms:", sum(1 for _ in iterator))

# ------------------------------------------------- creating + mutating groups
# (lib.rs "Creating groups")
system.group_create("Selected", "resname POPC and name P")
system.group_create("Some Atoms", "Selected || resid 87 to 124")
for atom in system.group_iter("Some Atoms"):
    atom.set_residue_name("RES")
assert system.group_exists("all") and system.group_exists("All")
print("Some Atoms:", system.group_get_n_atoms("Some Atoms"), "renamed to RES")

# ------------------------------------------------- writing structure files
# (lib.rs "Writing output structure files")
system.write_pdb(os.path.join(tmp, "system.pdb"))
pep = System.from_file(os.path.join(TF, "protein_with_dna.pdb"))
pep.group_create("DNA", "@dna")
pep.group_write_gro("DNA", os.path.join(tmp, "dna.gro"))
print("wrote system.pdb + dna.gro (", pep.group_get_n_atoms("DNA"), "DNA atoms)")

# ------------------------------------------------- geometry filtering
# (lib.rs "Geometry filtering of atoms": TPR gives masses + bonds)
tpr = System.from_file(os.path.join(TF, "example.tpr"))
tpr.read_ndx(os.path.join(TF, "index.ndx"))
protein_com = tpr.group_get_com("Protein")
cylinder = Cylinder(np.asarray(protein_com), 2.0, 4.0, Dimension.Z)
inside = tpr.group_filter_geometry("W", cylinder)
print("water atoms inside protein cylinder:", len(inside))

# the chainable iterator form (iterators.rs AtomIterable adaptors)
wcenter = tpr.group_iter("W").filter_geometry(cylinder).get_center()
print("  ... their center:", np.round(np.asarray(wcenter), 4))

# ------------------------------------------------- Vector3D
# (vector3d.rs — positions behave like the reference's Vector3D)
from groan_rs_tpu import SimBox, Vector3D

v = Vector3D(1.0, 2.0, 3.0)
w = v.vector_to(Vector3D(3.0, 2.0, 1.0), SimBox.from_lengths(3.5, 5.0, 5.0))
print("Vector3D len/unit/vector_to:", round(v.len(), 4),
      np.round(np.asarray(v.to_unit()), 4), np.asarray(w))

# ------------------------------------------------- analyzing trajectories
# (lib.rs "Analyzing trajectory files")
for frame in system.xtc_iter(os.path.join(TF, "short_trajectory.xtc")):
    distance = frame.group_distance("Protein", "Membrane", Dimension.XYZ)
print("last-frame protein-membrane distance:", round(float(distance), 4))

# range + step + concatenation + progress over split files
split = [os.path.join(TF, "split", f"traj{i}.xtc") for i in (1, 2, 3, 4, 5, 6)]
frames = 0
for frame in (system.xtc_cat_iter(split)
              .with_range(200.0, 800.0)
              .with_step(3)
              .print_progress(ProgressPrinter().with_print_freq(2)
                              .with_output(open(os.devnull, "w")))):
    frames += 1
print("cat+range+step frames:", frames)

# ------------------------------------------------- RMSD
# (lib.rs "Calculating RMSD")
system2 = System.from_file(os.path.join(TF, "example.tpr"))
system2.group_create("Protein", "@protein")
sys_t = System.from_file(os.path.join(TF, "example.tpr"))
sys_t.group_create("Protein", "@protein")
rmsd = sys_t.calc_rmsd(system2, "Protein")
print("structure RMSD:", round(float(rmsd), 6))
rmsds = [r for _, r in sys_t.xtc_iter(
    os.path.join(TF, "short_trajectory.xtc")).calc_rmsd_and_fit(system2, "Protein")]
print("trajectory RMSD head:", [round(r, 4) for r in rmsds[:3]])

# ------------------------------------------------- writing trajectories
# (lib.rs "Writing trajectory files": read TRR, write XTC)
out_xtc = os.path.join(tmp, "converted.xtc")
conv = System.from_file(os.path.join(TF, "example.gro"))
conv.traj_writer_init(out_xtc, fmt="xtc")
for frame in conv.trr_iter(os.path.join(TF, "short_trajectory.trr")):
    frame.traj_write_frame()
conv.traj_writers_close()
print("trr->xtc:", os.path.getsize(out_xtc), "bytes")

print("\nreference_api_tour: ALL lib.rs examples ported and ran OK")
