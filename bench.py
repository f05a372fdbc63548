#!/usr/bin/env python
"""North-star benchmark: 1M-atom XTC dist+COM+RMSD pass (frames/s on one GPU).

Builds (once, cached) a synthetic 1M-atom system with water-like atom
triplets and a multi-frame XTC written by the native codec
(`groan_rs_tpu.synthetic`), then times the PRODUCT pipeline —
`TrajectoryAnalysis(...).runner().run(xtc)` — which owns the full fast
path: partial-frame decode up to the last touched atom, compact
int8-delta/q16 wire with on-device dequantization (bit-identical to the
float decode), subset-of-atoms ship, and decode/transfer/compute overlap.

Parity: the COM, distance and RMSD series are checked against a float64
host recomputation of the reference algorithms (refined Bai-Breen center,
iterators.rs:1237-1266; mass-weighted Kabsch, rmsd.rs:547-604), plus a
per-frame COM trace on a real fixture trajectory.

Baseline anchor (BASELINE.md row 1): groan_rs single-thread full-system XTC
pass at ~47 M atom-frames/s == 47 frames/s at 1M atoms.

Needs a GPU: exits non-zero when JAX finds none.  Prints the card's name
and power limit on stderr and exactly ONE JSON line to stdout.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from groan_rs_tpu import synthetic

N_ATOMS = int(os.environ.get("BENCH_ATOMS", 1_000_000))
# 240 frames / batch 12 = 20 batches: the cold pass is measured in its
# pipelined steady state (fill/drain excluded via `steady_fps`), and the
# SAME window loads device-resident in one piece — 240 frames x ~400k
# shipped atoms x 6 B ~= 0.6 GB of device memory — so the resident figure
# amortizes fixed per-pass overhead over the whole window.
N_FRAMES = int(os.environ.get("BENCH_FRAMES", 240))
BATCH = int(os.environ.get("BENCH_BATCH", 12))
# frames whose dist/RMSD series are float64-recomputed on host for parity
# (parity is shape-independent; a full-series recompute adds minutes)
PARITY_FRAMES = min(N_FRAMES, int(os.environ.get("BENCH_PARITY_FRAMES", 24)))
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
BASELINE_FRAMES_PER_SEC = 47.0e6 / N_ATOMS  # reference atom-frames/s anchor


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def runner_reader_batches(runner, xtc, batch):
    """Host-only batch stream with the runner's exact reader config
    (selection, wire) — times decode+wire-prep without device/transfer."""
    from groan_rs_tpu.io.traj import traj_iter

    reader = traj_iter(runner.system, xtc, indices=runner.sel,
                       batch_size=batch)
    return reader.batches(wire=runner.wire, prefetch=False)


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {jax.devices()[0].platform}")
    from groan_rs_tpu.compile_cache import enable_compile_cache
    from groan_rs_tpu.io import native
    from groan_rs_tpu.models import TrajectoryAnalysis

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}; devices: {jax.devices()}")

    t_setup = time.perf_counter()
    n_prot, n_mem = synthetic.group_sizes(N_ATOMS)
    xtc = synthetic.ensure_trajectory(CACHE, N_ATOMS, N_FRAMES, log=log)
    log(f"setup: {time.perf_counter() - t_setup:.1f}s")

    offsets, _, _, natoms = native.xtc_scan(xtc)
    assert natoms == N_ATOMS
    c0, b0, *_ = native.xtc_read_frames(xtc, offsets[:1], natoms)
    box_l = b0[0][[0, 4, 8]]

    system, masses = synthetic.build_system(N_ATOMS, c0[0], box_l)

    # ---- the product pipeline: THE thing being measured -----------------
    pipe = (
        TrajectoryAnalysis(system)
        .add_com("Protein", name="com")
        .add_distance("Protein", "Membrane", com=(True, False), name="dist")
        .add_rmsd("Protein", reference=system, name="rmsd")
    )
    runner = pipe.runner()  # compiles once; fast path (ship=used, wire=auto)

    log("warmup pass...")
    out = runner.run(xtc, batch_size=BATCH)
    wire_bytes_per_atom_frame = runner.engine.h2d_bytes / max(
        1, runner.engine.frames_shipped
    ) / len(pipe.used_atoms())

    # ---- parity: series vs float64 host recomputation -------------------
    idx_prot = np.arange(n_prot)
    idx_mem = np.arange(n_prot, n_prot + n_mem)
    w_prot = masses[idx_prot]
    coords, b9, *_ = native.xtc_read_frames(
        xtc, offsets[:PARITY_FRAMES], natoms)
    ref = synthetic.host_flagship_series(coords, c0[0], box_l, idx_prot,
                                         idx_mem, w_prot)
    ref_com0 = ref["com"][0]
    dist_host, rmsd_host = ref["dist"], ref["rmsd"]
    com_err = np.abs(np.asarray(out["com"], np.float64)[0] - ref_com0).max()
    parity_ok = bool(com_err < 2e-3)
    dist_err = np.abs(
        np.asarray(out["dist"], np.float64)[:PARITY_FRAMES] - dist_host).max()
    rmsd_err = np.abs(
        np.asarray(out["rmsd"], np.float64)[:PARITY_FRAMES] - rmsd_host).max()
    series_parity_ok = bool(dist_err < 2e-3 and rmsd_err < 2e-3)
    parity_ok &= series_parity_ok
    log(f"series parity: dist err {dist_err:.2e}, rmsd err {rmsd_err:.2e}")

    # parity on a REAL fixture trajectory (groan_rs semantics): per-frame
    # protein COM on short_trajectory.xtc vs float64 host reference
    fixture_ok = None
    fx = "/root/reference/test_files/short_trajectory.xtc"
    fg = "/root/reference/test_files/example.gro"
    if os.path.exists(fx) and os.path.exists(fg):
        import jax.numpy as jnp

        from groan_rs_tpu.ops import center as center_ops
        from groan_rs_tpu.system import System

        fsys = System.from_file(fg)
        fsys.group_create("Prot", "@protein")
        fidx = fsys.group_indices("Prot")
        foff, _, _, fn = native.xtc_scan(fx)
        fc, fb9, *_ = native.xtc_read_frames(fx, foff, fn)
        fboxes = fb9[:, [0, 4, 8]]
        # unweighted (COG): gro structures carry no masses
        dev_com = np.asarray(
            center_ops.center(
                jnp.asarray(fc[:, fidx]), jnp.asarray(fboxes)[:, None, :]
            ),
            np.float64,
        )
        host_com = np.stack(
            [synthetic.host_refined_center(fc[i][fidx], fboxes[i])
             for i in range(len(foff))]
        )
        fixture_ok = bool((np.abs(dev_com - host_com) < 2e-4).all())
        parity_ok &= fixture_ok

    # host-CPU canary (an 800x800 float64 matmul), stamped per timed pass:
    # on a shared host, CPU steal changes the host stages of a pass
    def canary_ms():
        c = np.random.default_rng(0).random((800, 800))
        t0 = time.perf_counter()
        c = c @ c
        return round((time.perf_counter() - t0) * 1e3 + float(c[0, 0]) * 0, 1)

    # ---- timed passes (breakdown comes from the PRODUCTION pass) ---------
    # The engine keeps always-on per-batch stage clocks (decode_wait, h2d,
    # dispatch are host-synchronous in the pipelined configuration, so the
    # clocks describe the real schedule); the residual pass-minus-stages is
    # the overlapped device compute + packed result fetch.  This replaces
    # the r03 profiler-instrumented pass, whose forced per-batch syncs made
    # it run ~5x slower than the pass it claimed to describe.
    #
    # Each pass is stamped with its own canary and, if the base reps never
    # hit a healthy window (canary <= BENCH_HEALTHY_CANARY_MS), sampling
    # extends up to BENCH_EXTRA_S — keeping the best pass and the canary
    # measured NEXT TO it.
    log("timed passes...")
    can_timed = canary_ms()
    healthy_ms = float(os.environ.get("BENCH_HEALTHY_CANARY_MS", 90))
    extra_s = float(os.environ.get("BENCH_EXTRA_S", 600))
    best = float("inf")
    can_best = can_timed
    reps_run = 0
    timings = {}

    def timed_pass():
        nonlocal best, can_best, reps_run
        t0 = time.perf_counter()
        runner.run(xtc, batch_size=BATCH)
        dt = time.perf_counter() - t0
        can = canary_ms()
        reps_run += 1
        if dt < best:
            best = dt
            can_best = can
            timed_pass.stages = {k: list(v) for k, v in
                                 runner.engine.last_stage_seconds.items()}
            timed_pass.fetch_s = runner.engine.last_fetch_seconds
            timed_pass.walls = list(runner.engine.last_batch_walls)
        log(f"  pass {dt:.3f}s (canary {can:.0f} ms)")
        return can

    for _ in range(int(os.environ.get("BENCH_REPS", 5))):
        timed_pass()
    if can_best > healthy_ms and extra_s > 0:
        log(f"no healthy window in base reps (best-pass canary "
            f"{can_best:.0f} ms > {healthy_ms:.0f}); extending up to "
            f"{extra_s:.0f}s...")
        deadline = time.monotonic() + extra_s
        failures = 0
        while time.monotonic() < deadline:
            try:
                can = timed_pass()
            except Exception as e:  # keep the base-reps number on outage
                failures += 1
                log(f"extension pass failed ({e!r}); "
                    f"{failures} consecutive failures")
                if failures >= 3:
                    break
                time.sleep(10)
                continue
            failures = 0
            if can <= healthy_ms and can_best <= healthy_ms:
                break  # a healthy-window pass is now the recorded best
            time.sleep(2)  # let a steal burst pass rather than re-enter it
    stages = timed_pass.stages
    fetch_s = timed_pass.fetch_s
    n_batches = len(stages.get("h2d", []))
    stage_sum = sum(sum(v) for v in stages.values()) + fetch_s
    for k, v in stages.items():
        timings[f"{k}_med_ms"] = round(
            statistics.median(v) * 1e3, 1) if v else 0.0
    timings["fetch_s"] = round(fetch_s, 4)
    timings["n_batches"] = n_batches
    timings["pass_s"] = round(best, 4)
    timings["stage_sum_s"] = round(stage_sum, 4)
    # steady-state throughput of the best pass: inter-batch intervals of
    # the pipelined loop, first interval (pipeline fill) and last (partial
    # batch / drain) excluded — the sustained figure the 5,000-frame
    # reference workload (info.md:3-15) is about, vs `value` which still
    # charges startup + drain (VERDICT r4 #2)
    steady_fps = None
    walls = getattr(timed_pass, "walls", [])
    if len(walls) >= 4:
        iv = np.diff(np.asarray(walls))[1:-1]
        if iv.size and iv.sum() > 0:
            steady_fps = float(BATCH * iv.size / iv.sum())
    # the stages are clocked inside the timed pass, so they can never
    # exceed it; overlap_residual is the device-side work hidden behind
    # the host stages (negative only through clock jitter)
    timings["overlap_residual_s"] = round(best - stage_sum, 4)
    timings["breakdown_unreliable"] = bool(stage_sum > 1.05 * best)
    log(f"breakdown (production-pass stage clocks): {timings}")

    # ---- environment floors (measured IN-RUN, same weather) -------------
    # wire floor: ship one representative wire-sized buffer with forced
    # materialization (async puts under-attribute; reduce + fetch forces)
    bytes_per_pass = max(1, runner.engine.h2d_bytes // max(
        1, runner.engine.frames_shipped // N_FRAMES))
    import jax.numpy as jnp
    probe = np.frombuffer(
        np.random.default_rng(1).bytes(min(bytes_per_pass, 32_000_000)),
        np.uint8)
    dprobe = jnp.asarray(probe)  # warm path
    float(jnp.sum(dprobe.astype(jnp.int32)))
    t0 = time.perf_counter()
    dprobe = jnp.asarray(probe)
    float(jnp.sum(dprobe.astype(jnp.int32)))
    wire_rate = probe.nbytes / (time.perf_counter() - t0)
    wire_floor_fps = wire_rate / (bytes_per_pass / N_FRAMES)
    # decode floor: host-only consumption of the same batches (native
    # decode + wire prep, no device, no transfer)
    t0 = time.perf_counter()
    for _fb in runner_reader_batches(runner, xtc, BATCH):
        pass
    decode_floor_fps = N_FRAMES / (time.perf_counter() - t0)
    log(f"floors: wire {wire_floor_fps:.1f} f/s ({wire_rate/1e6:.0f} MB/s), "
        f"decode {decode_floor_fps:.1f} f/s")

    # ---- device-resident re-analysis (DeviceTrajectory) ------------------
    # decode + ship ONCE, then every further pass is pure device compute:
    # the parameter-sweep workflow.  Secondary metric; the headline above
    # stays the cold end-to-end pass.
    # warm the materialize path: the delta-wire materializer and the
    # concat finisher jit once per shape, which must not be attributed to
    # the load itself
    warm = runner.load_device(xtc, batch_size=BATCH)
    del warm
    load_s = float("inf")
    dtraj = None
    for _ in range(3):
        if dtraj is not None:
            del dtraj
        t0 = time.perf_counter()
        dtraj = runner.load_device(xtc, batch_size=BATCH)
        load_s = min(load_s, time.perf_counter() - t0)
        if load_s < 3.0 * best:
            break
    res_out = runner.run(dtraj, batch_size=BATCH)  # compile + parity
    resident_ok = bool(
        np.abs(np.asarray(res_out["com"], np.float64)[0] - ref_com0).max() < 2e-3
    )
    res_dist_err = np.abs(
        np.asarray(res_out["dist"], np.float64)[:PARITY_FRAMES]
        - dist_host).max()
    res_rmsd_err = np.abs(
        np.asarray(res_out["rmsd"], np.float64)[:PARITY_FRAMES]
        - rmsd_host).max()
    resident_ok &= bool(res_dist_err < 2e-3 and res_rmsd_err < 2e-3)
    best_res = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        runner.run(dtraj, batch_size=BATCH)
        best_res = min(best_res, time.perf_counter() - t0)
    resident_fps = N_FRAMES / best_res
    resident_frames = dtraj.n_frames
    resident_hbm_mb = dtraj.nbytes / 1e6
    log(f"device-resident: load {load_s:.2f}s ({resident_hbm_mb:.0f} MB, "
        f"{resident_frames} frames), re-analysis {best_res:.3f}s/pass "
        f"= {resident_fps:.0f} f/s")
    del dtraj

    # ---- small-group pass (BASELINE.md row 6: ~400-atom peptide) --------
    # decode early-stops at atom 400 and ships ~400 atoms: the partial-read
    # wire saving the feature exists for (reference: GroupXtcReader)
    small_pipe = (
        TrajectoryAnalysis(system)
        .add_com("Peptide", name="com")
        .add_rmsd("Peptide", reference=system, name="rmsd")
    )
    small_runner = small_pipe.runner()
    small_runner.run(xtc, batch_size=BATCH)  # compile
    best_small = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        small_out = small_runner.run(xtc, batch_size=BATCH)
        best_small = min(best_small, time.perf_counter() - t0)
    small_fps = N_FRAMES / best_small
    small_com0 = synthetic.host_refined_center(c0[0][:400], box_l,
                                               masses[:400])
    small_ok = bool(
        (np.abs(np.asarray(small_out["com"], np.float64)[0] - small_com0) < 2e-3).all()
    )

    fps = N_FRAMES / best
    floor_fps = min(wire_floor_fps, decode_floor_fps)
    # a pass with zero overlap of decode and transfer would run at the
    # harmonic (serial) floor 1/(1/wire + 1/decode); the gap between
    # serial_floor and min-floor is what the pipeline's overlap can win.
    serial_floor_fps = 1.0 / (1.0 / wire_floor_fps + 1.0 / decode_floor_fps)
    result = {
        "metric": "frames/s on one GPU, 1M-atom XTC dist+COM+RMSD pass; float32 parity vs groan_rs",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FRAMES_PER_SEC, 3),
        "n_atoms": N_ATOMS,
        "n_frames": N_FRAMES,
        "pass_seconds": round(best, 3),
        "atom_frames_per_sec": round(fps * N_ATOMS / 1e6, 1),
        "parity_ok": parity_ok,
        "series_parity_ok": series_parity_ok,
        "fixture_parity_ok": fixture_ok,
        "small_group_fps": round(small_fps, 2),
        "small_group_parity_ok": small_ok,
        "wire_bytes_per_atom_frame": round(float(wire_bytes_per_atom_frame), 3),
        "steady_fps": round(steady_fps, 2) if steady_fps else None,
        "device_resident_fps": round(resident_fps, 2),
        "device_resident_parity_ok": resident_ok,
        "resident_frames": resident_frames,
        "resident_hbm_mb": round(resident_hbm_mb, 1),
        "device_resident_vs_baseline": round(
            resident_fps / BASELINE_FRAMES_PER_SEC, 2),
        "device_load_seconds": round(load_s, 3),
        # environment floors measured in the SAME run/weather: the
        # headline can be judged against them inside the artifact itself
        "wire_floor_fps": round(wire_floor_fps, 1),
        "decode_floor_fps": round(decode_floor_fps, 1),
        "serial_floor_fps": round(serial_floor_fps, 1),
        "value_vs_env_floor": round(fps / floor_fps, 3) if floor_fps else None,
        "value_vs_serial_floor": (round(fps / serial_floor_fps, 3)
                                  if serial_floor_fps else None),
        "cpu_canary_ms": canary_ms(),
        "canary_timed_ms": can_timed,
        # canary measured immediately AFTER the recorded best pass
        "canary_at_best_ms": can_best,
        "reps_run": reps_run,
        # which native codec build produced this number (hash of
        # xdrcodec.cpp — correlates artifacts with decode-path commits)
        "native_lib": os.path.basename(native._build()).replace(
            "libgroanxdr-", "").replace(".so", ""),
        "breakdown": timings,
    }

    # ---- the reference's OWN published study (BASELINE.md rows 1-7) -----
    # host-only passes (no device): our reader vs the molly numbers
    # on the study's workload shapes.  BENCH_ROWS=0 skips; BENCH_ROWS_FRAMES
    # scales the one-time trajectory build (speedups are scale-free).
    if os.environ.get("BENCH_ROWS", "1") != "0":
        try:
            sys.path.insert(0, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "benches"))
            import baseline_rows

            log("reference-study rows (xdrfile_vs_molly workloads)...")
            result["baseline_rows"] = baseline_rows.run(
                n_frames=int(os.environ.get("BENCH_ROWS_FRAMES", 2000)),
                reps=3)
        except Exception as e:  # never let the secondary study kill the run
            result["baseline_rows"] = {"error": repr(e)}

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
