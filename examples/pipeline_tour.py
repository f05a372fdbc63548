#!/usr/bin/env python
"""Feature tour: the composed analysis pipeline end to end.

Runs against the reference fixture corpus (read-only) on any backend —
CPU jax is fine; on a GPU the same code runs compiled for the card.

Covers:
- the full observable suite in ONE jitted step (COM, COG distance,
  Kabsch RMSD, min distance, contacts, RDF, 2D density, hydrogen-bond
  counts with exact reference semantics)
- the automatic wire ladder (6-bit deltas -> int8 deltas -> q16 -> f32)
- reusable compiled runners + concatenated file lists
- the multi-chip (frames x atoms) mesh runner
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FIX = os.environ.get("GROAN_FIXTURES", "/root/reference/test_files")


def main():
    from groan_rs_tpu import HBondChain, System, TrajectoryAnalysis, make_mesh

    system = System.from_file(os.path.join(FIX, "aa_membrane_peptide.tpr"))
    system.group_create("Protein", "@protein")
    system.group_create("Membrane", "@membrane")
    system.group_create("W", "resname SOL and name OW")

    water = [HBondChain("resname SOL and name OW", "resname SOL and name OW",
                        "resname SOL and name HW1 HW2")]

    pipe = (
        TrajectoryAnalysis(system)
        .add_com("Protein")
        .add_distance("Protein", "Membrane", com=(True, False))
        .add_rmsd("Protein", reference=system)
        .add_min_distance("Protein", "W")
        .add_contacts("Protein", "Membrane", cutoff=0.6)
        .add_rdf("W", "W", r_max=1.2, n_bins=60)
        .add_density_map("Membrane", plane="xy", tile=0.4)
        .add_hbonds(water, [(0, 0)], 0.3, 150.0, name="ww", method="cells")
    )

    xtc = os.path.join(FIX, "aa_membrane_peptide.xtc")
    runner = pipe.runner()  # compiles once; ship=used, wire=auto
    out = runner.run(xtc, batch_size=8, end_time=70200.0)

    f = out["times"].shape[0]
    print(f"{f} frames analyzed")
    print("  COM(Protein)[0]      :", np.round(out["com_Protein"][0], 3))
    print("  dist(Prot, Mem)      :", np.round(out["distance_Protein_Membrane"], 3))
    print("  RMSD(Protein)        :", np.round(out["rmsd_Protein"], 4))
    print("  min dist(Prot, W)    :", np.round(out["mindist_Protein_W"], 3))
    print("  contacts(Prot, Mem)  :", out["contacts_Protein_Membrane"])
    print("  water-water hbonds   :", list(out["ww_0_0"]))
    gr = out["rdf_W_W"].mean(axis=0)
    peak = float(gr.max())
    print(f"  water g(r) peak      : {peak:.2f} at r = "
          f"{(np.argmax(gr) + 0.5) * 1.2 / 60:.3f} nm")
    print("  density map shape    :", out["density_Membrane_xy"].shape)

    # device-resident re-analysis: decode + ship ONCE into HBM, then
    # every further pass is pure device compute (the sweep workflow).
    # (host-assisted 'cells' hbonds need the streamed pass, so this demo
    # uses a pipe without them)
    pipe_r = (TrajectoryAnalysis(system)
              .add_com("Protein")
              .add_rmsd("Protein", reference=system))
    runner_r = pipe_r.runner()
    streamed = runner_r.run(xtc, batch_size=8, end_time=70200.0)
    dt = runner_r.load_device(xtc, batch_size=8, end_time=70200.0)
    out_res = runner_r.run(dt, batch_size=8)
    same = np.array_equal(np.asarray(streamed["rmsd_Protein"]),
                          np.asarray(out_res["rmsd_Protein"]))
    print(f"device-resident ({dt.n_frames} frames, {dt.nbytes/1e3:.0f} KB "
          f"HBM, kind={dt.kind}) bit-equal to streamed:", same)

    # sweep MANY analyses over the resident trajectory with ONE packed
    # result fetch (M passes ~ M async dispatches + 1 transfer)
    from groan_rs_tpu.models import run_many

    dt_all = pipe_r.runner(ship="all").load_device(
        xtc, batch_size=8, end_time=70200.0)
    sweep = run_many(
        [TrajectoryAnalysis(system).add_com("Protein"),
         TrajectoryAnalysis(system).add_center("Protein"),
         TrajectoryAnalysis(system).add_rmsd("Protein", reference=system)],
        dt_all)
    print("run_many sweep        :",
          [sorted(k for k in o if k not in ("times", "steps"))
           for o in sweep])

    # multi-chip: the SAME suite as one shard_map step over a mesh
    # (on CPU this needs the virtual 8-device mesh: run tests/conftest-style
    # with XLA_FLAGS=--xla_force_host_platform_device_count=8)
    import jax

    if len(jax.devices()) >= 2:
        pipe2 = (TrajectoryAnalysis(system)
                 .add_com("Protein")
                 .add_distance("Protein", "Membrane", com=(True, False))
                 .add_rmsd("Protein", reference=system))
        pipe2.mesh = make_mesh(len(jax.devices()) // 2, 2)
        out2 = pipe2.runner(ship="all").run(xtc, batch_size=8,
                                            end_time=70200.0)
        agree = np.allclose(out2["rmsd_Protein"], out["rmsd_Protein"],
                            atol=5e-5)
        print(f"mesh runner ({pipe2.mesh.shape}) agrees with single-device:",
              agree)
    else:
        print("single device: skipping the mesh-runner demo")


if __name__ == "__main__":
    main()
