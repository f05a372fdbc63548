#!/usr/bin/env python
"""Reproduce the reference's own headline benchmark study on OUR reader.

The reference's only published end-to-end numbers are the
`comparison/xdrfile_vs_molly` study (BASELINE.md rows 1-7): a ~94,700-atom
membrane-peptide system, 5,000-frame XTC, iterated with the per-frame API
("read + touch 1 atom per frame"), full / every-5th-frame / time-range /
partial-group variants (reference: comparison/xdrfile_vs_molly/info.md:3-36).
These passes are host-decode-bound — no device in the loop — so
they compare OUR native decoder + per-frame System machinery directly
against the reference's molly backend numbers on its own workload shapes.

Reference hardware: i7-10700 (single-threaded pass), NVMe SSD.  Each row
reports min-of-reps and the run stamps a CPU canary, so steal on a shared
host is visible.

Synthetic system mirrors the study's composition and ORDER (the partial
rows depend on where the group sits in the file): peptide ~400 atoms at
the file START, membrane ~40,000 next, water ~54,300 at the file END
(info.md:19-36; water-at-end is why its partial pass costs almost a full
one).  Trajectory spans 500 ns at 0.1 ns/frame so the 300-400 ns range row
covers ~1/5 of the file, matching the study's range/full ratio (2.1/10.1).

Run: python benches/baseline_rows.py [--frames N] [--reps K] [--json]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".bench_cache")

N_ATOMS = 94_700
N_PEP = 400
N_MEM = 40_000
N_WAT = N_ATOMS - N_PEP - N_MEM  # 54,300, at the end of the file

# reference seconds (molly backend, info.md) keyed by row name; the study's
# full pass is 5,000 frames — scaled linearly when --frames differs
REF_S = {
    "full_pass": 10.1,
    "full_pass_xdrfile": 16.3,
    "step5_pass": 2.1,
    "range_300_400ns": 2.1,
    "group_pep_mem_full": 4.0,
    "group_pep_mem_step5": 0.9,
    "group_peptide_full": 0.3,
    "group_peptide_step5": 0.1,
    "group_water_full": 8.7,
    "group_water_step5": 1.8,
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _cell_order(points, cell=0.5):
    key = np.floor(points / cell).astype(np.int64)
    return np.lexsort((key[:, 2], key[:, 1], key[:, 0]))


def build_trajectory(path, n_frames):
    """94,700-atom membrane-peptide system, study-ordered, spatially
    coherent (real GROMACS output is; random order would make the XTC
    delta coder pathological in a way the study's files are not)."""
    from groan_rs_tpu.io import native

    rng = np.random.default_rng(11)
    box = np.array([9.8, 9.8, 11.0], np.float32)
    pos = np.empty((N_ATOMS, 3), np.float32)

    # peptide: compact blob at the box center (file start)
    sigma = (N_PEP / 100.0) ** (1.0 / 3.0) / 2.0
    pep = box / 2 + rng.normal(size=(N_PEP, 3)).astype(np.float32) * max(0.6, sigma)
    pos[:N_PEP] = pep[_cell_order(pep)]

    # membrane: ~50-atom lipids in a slab
    lip_sz = 50
    n_lip = N_MEM // lip_sz
    heads = rng.uniform(0, 1, size=(n_lip, 3)).astype(np.float32)
    heads[:, :2] *= box[:2]
    heads[:, 2] = 4.0 + heads[:, 2] * 3.0
    heads = heads[_cell_order(heads, cell=1.0)]
    walk = np.cumsum(rng.normal(size=(n_lip, lip_sz, 3)).astype(np.float32) * 0.08,
                     axis=1)
    pos[N_PEP : N_PEP + N_MEM] = (heads[:, None, :] + walk).reshape(-1, 3)[:N_MEM]

    # water triplets (file end)
    n_mol = (N_WAT + 2) // 3
    centers = rng.uniform(0, 1, size=(n_mol, 3)).astype(np.float32) * box
    centers = centers[_cell_order(centers)]
    offsets = rng.normal(size=(n_mol, 2, 3)).astype(np.float32) * 0.06
    trip = np.stack([centers, centers + offsets[:, 0], centers + offsets[:, 1]],
                    axis=1)
    pos[N_PEP + N_MEM :] = trip.reshape(-1, 3)[:N_WAT]
    pos %= box

    box33 = np.diag(box).astype(np.float32).reshape(9)
    drift = np.random.default_rng(13)
    cur = pos.copy()
    t0 = time.perf_counter()
    for f in range(n_frames):
        if f:
            cur = (cur + drift.normal(size=(1, 3)).astype(np.float32) * 0.05
                   + drift.normal(size=cur.shape).astype(np.float32) * 0.01) % box
        # 0.1 ns/frame -> 5,000 frames span 500 ns (range row = 1/5 of file)
        native.xtc_write_frame(path, N_ATOMS, f * 50_000, f * 100.0, box33,
                               cur, 1000.0)
        if f % 500 == 499:
            log(f"  wrote frame {f + 1}/{n_frames} "
                f"({time.perf_counter() - t0:.0f}s)")
    return box


def build_system(frame0, box):
    from groan_rs_tpu.core.simbox import SimBox
    from groan_rs_tpu.core.topology import Topology
    from groan_rs_tpu.system import System

    topo = Topology(N_ATOMS)
    topo.atomnum = np.arange(1, N_ATOMS + 1, dtype=np.int64)
    topo.resnum = np.arange(N_ATOMS, dtype=np.int64) // 3 + 1
    s = System("baseline_rows", topo,
               simbox=SimBox.from_lengths(*map(float, box)), positions=frame0)
    s.group_create_from_ranges("Peptide", [(0, N_PEP - 1)])
    s.group_create_from_ranges("Peptide_Membrane", [(0, N_PEP + N_MEM - 1)])
    s.group_create_from_ranges("Water", [(N_PEP + N_MEM, N_ATOMS - 1)])
    return s


def canary_ms():
    c = np.random.default_rng(0).random((800, 800))
    t0 = time.perf_counter()
    c = c @ c
    return round((time.perf_counter() - t0) * 1e3 + float(c[0, 0]) * 0, 1)


def run(n_frames=5000, reps=3, quiet=False):
    """Run all rows; returns {row: {ours_s, ref_s, speedup}} + metadata."""
    from groan_rs_tpu.io import native

    os.makedirs(CACHE, exist_ok=True)
    xtc = os.path.join(CACHE, f"baseline_rows_{N_ATOMS}_{n_frames}.xtc")
    cache_ok = False
    if os.path.exists(xtc):
        try:
            offs, _, _, nat = native.xtc_scan(xtc)
            cache_ok = len(offs) == n_frames and nat == N_ATOMS
        except Exception:
            cache_ok = False
        if not cache_ok:
            log(f"cached study trajectory invalid ({xtc}); rebuilding")
            os.unlink(xtc)
    if not cache_ok:
        log(f"building {N_ATOMS}-atom x {n_frames}-frame study trajectory...")
        tmp = xtc + f".tmp{os.getpid()}"
        build_trajectory(tmp, n_frames)
        os.replace(tmp, xtc)
    with open(xtc, "rb") as fh:  # page-cache warm (study files are warm too)
        while fh.read(1 << 24):
            pass

    offsets, _, _, natoms = native.xtc_scan(xtc)
    assert natoms == N_ATOMS and len(offsets) == n_frames
    c0, b0, *_ = native.xtc_read_frames(xtc, offsets[:1], natoms)
    system = build_system(c0[0], b0[0][[0, 4, 8]])

    scale = n_frames / 5000.0

    def touch_pass(it):
        # the study's loop body: read each frame, touch 1 atom
        # (info.md: "iterates ... printing the position of one atom")
        acc = 0.0
        n = 0
        for frame in it:
            acc += float(frame.positions[0, 0])
            n += 1
        return n, acc

    rows = {}

    def row(name, make_iter, expect_frames):
        best = float("inf")
        can_best = None
        n_seen = 0
        for _ in range(reps):
            t0 = time.perf_counter()
            n_seen, _ = touch_pass(make_iter())
            dt = time.perf_counter() - t0
            if dt < best:
                best = dt
                # weather NEXT TO the recorded pass: future rounds can
                # normalize each row by its own canary (VERDICT r4 #10)
                can_best = canary_ms()
        assert n_seen == expect_frames, (name, n_seen, expect_frames)
        ref = REF_S[name] * scale
        rows[name] = {
            "ours_s": round(best, 3),
            "ref_molly_s": round(ref, 3),
            "speedup": round(ref / best, 2),
            "frames": n_seen,
            "canary_ms": can_best,
        }
        if not quiet:
            log(f"  {name:24s} ours {best:7.3f}s  molly {ref:6.2f}s  "
                f"-> {ref / best:5.2f}x")

    n_step5 = (n_frames + 4) // 5
    row("full_pass", lambda: system.xtc_iter(xtc), n_frames)
    row("step5_pass", lambda: system.xtc_iter(xtc, step=5), n_step5)
    # 300-400 ns of the 500 ns file (start/end inclusive, reference
    # with_range semantics) — scaled with the file when frames != 5000
    t_lo, t_hi = 0.6 * n_frames * 100.0, 0.8 * n_frames * 100.0
    n_range = int(t_hi // 100) - int(-(-t_lo // 100)) + 1
    row("range_300_400ns",
        lambda: system.xtc_iter(xtc, start_time=t_lo, end_time=t_hi), n_range)
    row("group_pep_mem_full",
        lambda: system.group_xtc_iter("Peptide_Membrane", xtc), n_frames)
    row("group_pep_mem_step5",
        lambda: system.group_xtc_iter("Peptide_Membrane", xtc, step=5), n_step5)
    row("group_peptide_full",
        lambda: system.group_xtc_iter("Peptide", xtc), n_frames)
    row("group_peptide_step5",
        lambda: system.group_xtc_iter("Peptide", xtc, step=5), n_step5)
    row("group_water_full",
        lambda: system.group_xtc_iter("Water", xtc), n_frames)
    row("group_water_step5",
        lambda: system.group_xtc_iter("Water", xtc, step=5), n_step5)

    # the batched path on the same workload (no per-frame System
    # update): what a pipeline consumer actually pays for host decode
    from groan_rs_tpu.io.traj import traj_iter

    best = float("inf")
    can_best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        n = 0
        for fb in traj_iter(system, xtc, batch_size=64).batches(prefetch=False):
            n += fb.positions.shape[0]
        dt = time.perf_counter() - t0
        if dt < best:
            best = dt
            can_best = canary_ms()
    assert n == n_frames
    rows["full_pass_batched"] = {
        "ours_s": round(best, 3),
        "ref_molly_s": round(REF_S["full_pass"] * scale, 3),
        "speedup": round(REF_S["full_pass"] * scale / best, 2),
        "frames": n_frames,
        "canary_ms": can_best,
    }
    if not quiet:
        log(f"  {'full_pass_batched':24s} ours {best:7.3f}s  molly "
            f"{REF_S['full_pass'] * scale:6.2f}s  "
            f"-> {rows['full_pass_batched']['speedup']:5.2f}x")

    # geomean over the study's own 9 rows only; the batched-pipeline row
    # re-measures the full-pass workload through a different API and would
    # double-weight it (it is reported alongside, not inside)
    geo = float(np.exp(np.mean([np.log(r["speedup"])
                                for k, r in rows.items()
                                if k != "full_pass_batched"])))
    return {
        "n_atoms": N_ATOMS,
        "n_frames": n_frames,
        "reps": reps,
        "cpu_canary_ms": canary_ms(),
        "geomean_speedup_vs_molly": round(geo, 2),
        "rows": rows,
        "note": ("reference seconds from comparison/xdrfile_vs_molly/info.md "
                 "(i7-10700 single-thread, molly backend), scaled to n_frames; "
                 "ours = min-of-reps on the host that ran it"),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    out = run(args.frames, args.reps)
    if args.json:
        print(json.dumps(out))
    else:
        log(f"geomean speedup vs molly: {out['geomean_speedup_vs_molly']}x "
            f"(canary {out['cpu_canary_ms']} ms)")


if __name__ == "__main__":
    main()
