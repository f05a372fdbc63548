#!/usr/bin/env python
"""Micro-benchmarks mirroring the reference's criterion suite
(reference: benches/main.rs:12-139 — same named workloads on the same
example.gro / short_trajectory.xtc fixtures).  Prints one line per bench:
`<name>: <median ms> (<n> reps)`.

Run: python benches/micro.py [fixture_dir]
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIXTURES = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/test_files"


def bench(name, fn, reps=9, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{name}: {statistics.median(times):.3f} ms ({reps} reps)", flush=True)


def main():
    from groan_rs_tpu.core.dimension import Dimension
    from groan_rs_tpu.system import System

    system = System.from_file(os.path.join(FIXTURES, "example.gro"))
    system.group_create("Protein", "@protein")
    system.group_create("Membrane", "resname POPC")
    xtc = os.path.join(FIXTURES, "short_trajectory.xtc")

    bench("System::atoms_iter", lambda: sum(1 for _ in system.atoms_iter()))
    bench("System::group_iter (Membrane)",
          lambda: sum(1 for _ in system.group_iter("Membrane")))
    bench("System::atoms_iter (creation)", lambda: system.atoms_iter())
    bench("System::group_iter (Membrane, creation)",
          lambda: system.group_iter("Membrane"))
    bench("System::get_atoms_as_ref and iter",
          lambda: sum(a.get_atom_number() for a in system.get_atoms()))
    bench("System::group_estimate_center (Protein)",
          lambda: system.group_estimate_center("Protein"))
    bench("System::group_get_center (Protein)",
          lambda: system.group_get_center("Protein"))
    bench("System::group_estimate_center (Membrane)",
          lambda: system.group_estimate_center("Membrane"))
    bench("System::group_get_center (Membrane)",
          lambda: system.group_get_center("Membrane"))
    bench("System::atoms_center (Protein, xyz)",
          lambda: system.copy().atoms_center("Protein", Dimension.XYZ))
    bench("System::atoms_center (Membrane, xyz)",
          lambda: system.copy().atoms_center("Membrane", Dimension.XYZ))
    bench("System::atoms_translate (short)",
          lambda: system.atoms_translate([0.001, 0.001, 0.001]))
    bench("System::atoms_translate (medium)",
          lambda: system.atoms_translate([0.8, -0.5, 0.3]))
    bench("System::atoms_translate (long)",
          lambda: system.atoms_translate([4.2, -1.1, 2.3]))
    bench("System::xtc_iter (no progress printing)",
          lambda: sum(1 for _ in system.xtc_iter(xtc)))

    from groan_rs_tpu.progress import ProgressPrinter

    class _Null:
        def write(self, *_):
            pass

        def flush(self):
            pass

    printer = ProgressPrinter().with_output(_Null()).with_print_freq(1)
    bench("System::xtc_iter (with progress printing)",
          lambda: sum(1 for _ in system.xtc_iter(xtc).print_progress(printer)))

    # batched-pipeline counterparts (the batched path)
    import jax.numpy as jnp

    from groan_rs_tpu.io.traj import traj_iter
    from groan_rs_tpu.ops import center as center_ops
    from groan_rs_tpu.parallel.engine import FrameEngine

    idx = jnp.asarray(system.group_indices("Protein"))
    eng = FrameEngine(lambda p, b, m: {
        "c": center_ops.center(jnp.take(p, idx, 1), b[:, None, :])})
    eng.run(traj_iter(system, xtc, batch_size=16).batches())  # compile
    bench("pipeline: xtc pass + device center (Protein)",
          lambda: eng.run(traj_iter(system, xtc, batch_size=16).batches()))

    # structure parsing (round-3 vectorized parsers)
    bench("read_gro(example.gro)",
          lambda: System.from_file(os.path.join(FIXTURES, "example.gro")),
          reps=5)
    bench("read_pdb(example.pdb)",
          lambda: System.from_file(os.path.join(FIXTURES, "example.pdb")),
          reps=5)
    tpr = os.path.join(FIXTURES, "aa_membrane_peptide.tpr")
    if os.path.exists(tpr):
        bench("read_tpr(aa_membrane_peptide.tpr, 33k atoms)",
              lambda: System.from_file(tpr), reps=3)

    tng = os.path.join(FIXTURES, "short_trajectory.tng")
    if os.path.exists(tng):
        from groan_rs_tpu.io.tng import TngSource

        import numpy as np

        src = TngSource(tng)
        ids = np.arange(src.n_frames())
        bench("tng_read_batch(short_trajectory.tng, XTC2 x11 frames)",
              lambda: TngSource(tng).read_batch(ids), reps=3)
        bench("tng_decode_only(11 frames, warm source)",
              lambda: src.read_batch(ids), reps=3)


if __name__ == "__main__":
    main()
