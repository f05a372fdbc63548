#!/usr/bin/env python
"""Smoke run of the trajectory pipeline on an NVIDIA GPU.

Drives the library's main path once, through the entry points a user
calls (`System`, `TrajectoryAnalysis(...).runner()`, `load_device`,
`run`), on a synthetic 1M-atom membrane-protein trajectory (99k protein
atoms, 300k membrane atoms, water; 96 frames in a 21 nm box, made from a
seed), and checks every phase against plain float64 host references:

- streamed flagship: COM + COM/COG distance + Kabsch RMSD, batch 12;
- resident: the same pass over `load_device`, fused and per-batch;
- small group: a 400-atom COM + RMSD pass (one-shot path);
- pair observables: minimum distance and contacts (0.35 nm) between the
  99k protein and 300k membrane atoms.

Run from the repository root:

    python chip_smoke.py          # one GPU, every phase above
    python chip_smoke.py --four   # four GPUs: the sharded flagship only

Each phase prints its errors beside its tolerance; any failure raises.
The last line of a successful run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

N_ATOMS = 1_000_000
N_FRAMES = 96
BATCH = 12
PAIR_FRAMES = 3         # frames of the full-width pair pass
PAIR_SUBSET = (20_000, 10_000)  # protein x membrane atoms vs float64 numpy
CUTOFF_NM = 0.35
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")

# Tolerances, each with its reason:
# - float32 against float64 for COM, distance and RMSD: the sums run over
#   1e5 atoms of coordinates up to 21 nm; float32 keeps every series
#   within ~5e-6 nm on the CPU and the GPU alike, so 5e-5 nm leaves 10x
#   headroom.  A TF32 contraction fails it: the RMSD's rotation einsum
#   rounds coordinates of a few nm to a 10-bit mantissa, and with the
#   HIGHEST pins lifted the frame-0 RMSD reads ~1.7e-3 nm (PERF.md).  The
#   orthorhombic COM and distance contract nothing.
TOL_REF_NM = 5e-5
# - two float32 evaluations of one quantity that differ only in fusion or
#   summation order (fused vs per-batch resident, sharded vs one device):
#   ~3e-6 nm apart on the card.
TOL_SAME_NM = 2e-5
# - minimum pair distance: the float32 coordinates (<= 21 nm) each carry
#   ~1e-6 nm of rounding, so the distance is good to a few 1e-6 nm.
TOL_MIN_NM = 1e-5
# - contact counts must be equal except for pairs whose float64 distance
#   lies within this band of the cutoff, where float32 may decide either way.
PAIR_BAND_NM = 1e-5
# Every frame is checked.  Where atoms sit on a periodic wrap plane (the
# centers unwrap around their estimate, the RMSD wraps around the COM),
# float32 may put such an atom on either side, which moves the RMSD by
# ~2e-3 nm; the float64 reference computes, per frame, how far that can
# move each observable (`ref["flip"]`, `synthetic.host_flagship_series`),
# and that frame's bound is the tolerance plus this reach.  The Gaussian
# protein blob reaches the wrap planes in about one frame in ten.


def log(msg: str) -> None:
    print(msg, flush=True)


def check(label: str, err: float, tol: float) -> None:
    """Print an error beside its tolerance; raise if it is not within."""
    ok = bool(np.isfinite(err) and err <= tol)
    log(f"  {label}: max err {err:.3e} nm (tol {tol:.1e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: error {err!r} exceeds {tol!r}")


def series_errors(out, ref):
    """Per-frame abs error of each flagship series in both -> {key: [F]}
    (the largest component for the COM)."""
    errs = {}
    for k in ("com", "dist", "rmsd"):
        if k in ref and k in out:
            d = np.abs(np.asarray(out[k], np.float64) - np.asarray(ref[k]))
            errs[k] = d.reshape(len(d), -1).max(axis=1)
    return errs


def check_series(label, out, ref, reach, tol):
    """Check each series frame by frame against `tol` plus that frame's
    float32 reach `reach` [F]; print every series before raising."""
    reach = np.asarray(reach, np.float64)
    bound = tol + reach
    firm = reach <= tol
    failed = []
    for k, err in series_errors(out, ref).items():
        ok = bool(np.isfinite(err).all() and (err <= bound).all())
        worst = int(np.argmax(err / bound))
        firm_max = float(err[firm].max()) if firm.any() else float("nan")
        log(f"  {label} {k}: max err {firm_max:.3e} nm on the "
            f"{int(firm.sum())} frames of reach <= tol (tol {tol:.1e}); "
            f"worst frame {worst}: {err[worst]:.3e} nm against "
            f"{bound[worst]:.3e} (reach {reach[worst]:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f"{label}: {failed} exceed their bounds")


def report_reach(ref):
    """Print how far float32 may move the series, frame by frame."""
    reach = np.asarray(ref["flip"])
    wide = np.nonzero(reach > TOL_SAME_NM)[0]
    log(f"  float32 reach: median {np.median(reach):.3e} nm, largest "
        f"{reach.max():.3e} nm (frame {int(reach.argmax())}); frames over "
        f"{TOL_SAME_NM:.0e} nm (atoms on a wrap plane): {wide.tolist()}")
    return reach


def check_shapes(out, n_frames, keys=("com", "dist", "rmsd")):
    for k in keys:
        arr = np.asarray(out[k])
        want = (n_frames, 3) if k == "com" else (n_frames,)
        if arr.shape != want or not np.isfinite(arr).all():
            raise AssertionError(
                f"'{k}' has shape {arr.shape} (want {want}) or non-finite "
                "values")


def peak_mb(device) -> str:
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 1e6:.1f} MB"


def device_report(cache_dir: str) -> None:
    """Print the card as nvidia-smi names it, and the JAX setup."""
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    dev = jax.devices()[0]
    log(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache_dir}")


def prepare(n_atoms=N_ATOMS, n_frames=N_FRAMES, cache_dir=CACHE):
    """Synthetic trajectory, its System and the float64 flagship series."""
    from groan_rs_tpu import synthetic
    from groan_rs_tpu.io import native

    t0 = time.perf_counter()
    xtc = synthetic.ensure_trajectory(cache_dir, n_atoms, n_frames)
    offsets, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offsets, nat)
    box = b9[0][[0, 4, 8]].astype(np.float32)
    system, masses = synthetic.build_system(n_atoms, coords[0], box)
    n_prot, n_mem = synthetic.group_sizes(n_atoms)
    idx_prot = np.arange(n_prot)
    idx_mem = np.arange(n_prot, n_prot + n_mem)
    ref = synthetic.host_flagship_series(coords, coords[0], box, idx_prot,
                                         idx_mem, masses[idx_prot])
    log(f"setup: {n_atoms} atoms x {n_frames} frames, "
        f"{time.perf_counter() - t0:.1f} s")
    return SimpleNamespace(
        xtc=xtc, system=system, masses=masses, coords=coords, box=box,
        n_atoms=n_atoms, n_frames=n_frames, n_prot=n_prot, n_mem=n_mem,
        ref=ref, reach=report_reach(ref))


def flagship(system, mesh=None):
    from groan_rs_tpu.models import TrajectoryAnalysis

    return (TrajectoryAnalysis(system, mesh=mesh)
            .add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False),
                          name="dist")
            .add_rmsd("Protein", reference=system, name="rmsd"))


def timed_run(runner, source, **kw):
    t0 = time.perf_counter()
    out = runner.run(source, **kw)
    return out, time.perf_counter() - t0


def stage_report(label, engine, wall):
    """The engine's stage clocks of its last pass, in host seconds: decode
    wait, H2D and dispatch summed over batches, and the final fetch.  The
    rest of the wall is device work the host stages did not hide, plus
    host time outside the clocks."""
    stages = {k: [float(x) for x in v]
              for k, v in engine.last_stage_seconds.items()}
    parts = {k: sum(v) for k, v in stages.items()}
    parts["fetch"] = float(engine.last_fetch_seconds)
    waits = stages.get("decode_wait") or [0.0]
    log(f"  {label} stages: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
        + f", rest {wall - sum(parts.values()):.4f} s; "
        f"{len(stages.get('h2d', []))} batches, longest decode wait "
        f"{max(waits):.4f} s")


def phase_streamed(ctx, batch=BATCH):
    import jax

    log(f"[streamed] flagship over {ctx.n_frames} frames, batch {batch}")
    runner = flagship(ctx.system).runner()
    out, first = timed_run(runner, ctx.xtc, batch_size=batch)
    stage_report("first pass", runner.engine, first)
    out, warm = timed_run(runner, ctx.xtc, batch_size=batch)
    stage_report("warm pass", runner.engine, warm)
    check_shapes(out, ctx.n_frames)
    check_series("streamed vs float64", out, ctx.ref, ctx.reach,
                 TOL_REF_NM)
    log(f"  first pass {first:.3f} s (compile ~{max(first - warm, 0):.3f} s); "
        f"warm pass {warm:.3f} s = {ctx.n_frames / warm:.2f} frames/s; "
        f"peak device memory {peak_mb(jax.devices()[0])}")
    return runner, out


def phase_resident(ctx, runner, streamed, batch=BATCH):
    import jax

    n_batches = -(-ctx.n_frames // batch)
    log(f"[resident] load_device + run, {n_batches} batches of {batch}")
    if n_batches < 4:
        raise AssertionError("the fused resident pass needs >= 4 batches")
    t0 = time.perf_counter()
    dt = runner.load_device(ctx.xtc, batch_size=batch)
    log(f"  load_device {time.perf_counter() - t0:.3f} s, "
        f"{dt.nbytes / 1e6:.1f} MB resident")
    outs = {}
    saved = os.environ.get("GROAN_RESIDENT_FUSED")
    try:
        for mode, label in (("1", "fused"), ("0", "per-batch")):
            os.environ["GROAN_RESIDENT_FUSED"] = mode
            _, first = timed_run(runner, dt, batch_size=batch)
            out, warm = timed_run(runner, dt, batch_size=batch)
            check_shapes(out, ctx.n_frames)
            check_series(f"{label} vs float64", out, ctx.ref,
                         ctx.reach, TOL_REF_NM)
            log(f"  {label}: first {first:.3f} s, warm {warm:.4f} s = "
                f"{ctx.n_frames / warm:.1f} frames/s")
            outs[label] = out
    finally:
        if saved is None:
            os.environ.pop("GROAN_RESIDENT_FUSED", None)
        else:
            os.environ["GROAN_RESIDENT_FUSED"] = saved
    all_frames = {k: np.asarray(v, np.float64) for k, v in outs["fused"].items()
                  if k in ("com", "dist", "rmsd")}
    check_series("fused vs per-batch", outs["per-batch"], all_frames,
                 ctx.reach, TOL_SAME_NM)
    check_series("per-batch vs streamed", outs["per-batch"],
                 {k: np.asarray(streamed[k], np.float64) for k in all_frames},
                 ctx.reach, TOL_SAME_NM)
    log(f"  peak device memory {peak_mb(jax.devices()[0])}")
    return outs


def phase_small_group(ctx, batch=BATCH):
    import jax

    from groan_rs_tpu import synthetic
    from groan_rs_tpu.models import TrajectoryAnalysis

    n = min(400, ctx.n_prot)
    log(f"[small group] {n}-atom Peptide COM + RMSD")
    runner = (TrajectoryAnalysis(ctx.system)
              .add_com("Peptide", name="com")
              .add_rmsd("Peptide", reference=ctx.system, name="rmsd")
              .runner())
    platforms = sorted({d.platform for d in runner.engine.mesh.devices.flat})
    log(f"  engine devices: {platforms}")
    if platforms != [jax.devices()[0].platform]:
        raise AssertionError(f"engine runs on {platforms}, not the default "
                             "device")
    _, first = timed_run(runner, ctx.xtc, batch_size=batch)
    out, warm = timed_run(runner, ctx.xtc, batch_size=batch)
    oneshot = len(runner.engine.last_batch_walls) == 1
    log(f"  one-shot path: {oneshot}; warm {warm:.4f} s = "
        f"{ctx.n_frames / warm:.1f} frames/s")
    # the one-shot path serves single-shard engines (one device)
    if runner.engine.n_shards == 1 and not oneshot:
        raise AssertionError("the small pass did not take the one-shot path")
    idx = np.arange(n)
    ref = synthetic.host_flagship_series(ctx.coords, ctx.coords[0], ctx.box,
                                         idx, idx, ctx.masses[idx])
    check_shapes(out, ctx.n_frames, keys=("com", "rmsd"))
    check_series("peptide vs float64", out,
                 {k: ref[k] for k in ("com", "rmsd")}, report_reach(ref),
                 TOL_REF_NM)
    return out


def pair_pipe(system, g1, g2):
    from groan_rs_tpu.models import TrajectoryAnalysis

    return (TrajectoryAnalysis(system)
            .add_min_distance(g1, g2, name="mindist")
            .add_contacts(g1, g2, CUTOFF_NM, name="contacts"))


def phase_pairs(ctx, n_frames=PAIR_FRAMES, subset=PAIR_SUBSET):
    """Minimum distance and contacts, Protein x Membrane: a subset against
    float64 numpy, then full width against an independent evaluation of
    the same reduction on the device."""
    import jax
    import jax.numpy as jnp

    from groan_rs_tpu import synthetic
    from groan_rs_tpu.ops import distances

    end = (n_frames - 1) * 10.0  # frames are 10 ps apart
    sa, sb = min(subset[0], ctx.n_prot), min(subset[1], ctx.n_mem)
    log(f"[pairs] {sa} x {sb} atoms vs float64, {n_frames} frames")
    sys_ = ctx.system
    sys_.group_create_from_ranges("ProtSub", [(0, sa - 1)])
    sys_.group_create_from_ranges(
        "MemSub", [(ctx.n_prot, ctx.n_prot + sb - 1)])
    out = pair_pipe(sys_, "ProtSub", "MemSub").runner().run(
        ctx.xtc, end_time=end, batch_size=n_frames)
    for f in range(n_frames):
        p = ctx.coords[f]
        dmin, lo, hi = synthetic.host_pair_reference(
            p[:sa], p[ctx.n_prot:ctx.n_prot + sb], ctx.box, CUTOFF_NM,
            PAIR_BAND_NM)
        check(f"frame {f} min distance", abs(float(out["mindist"][f]) - dmin),
              TOL_MIN_NM)
        got = int(out["contacts"][f])
        log(f"  frame {f} contacts {got}, float64 band [{lo}, {hi}]")
        if not lo <= got <= hi:
            raise AssertionError(f"frame {f}: {got} contacts outside "
                                 f"[{lo}, {hi}]")

    log(f"[pairs] {ctx.n_prot} x {ctx.n_mem} atoms, {n_frames} frames")
    runner = pair_pipe(sys_, "Protein", "Membrane").runner()
    _, first = timed_run(runner, ctx.xtc, end_time=end, batch_size=n_frames)
    out, warm = timed_run(runner, ctx.xtc, end_time=end, batch_size=n_frames)
    log(f"  first pass {first:.3f} s, warm pass {warm:.3f} s "
        f"({ctx.n_prot * ctx.n_mem * n_frames / warm / 1e9:.2f} G pairs/s "
        "for each observable)")
    # independent evaluation: the same frames through the plain form (an
    # explicit row chunking keeps the kernel out), plus the contact band
    # at cutoff -/+ band
    pos = jnp.asarray(ctx.coords[:n_frames])
    a = pos[:, :ctx.n_prot]
    b = pos[:, ctx.n_prot:ctx.n_prot + ctx.n_mem]
    box = jnp.broadcast_to(jnp.asarray(ctx.box), (n_frames, 3))
    chunk = 1 << 24
    alt_min = np.sqrt(np.asarray(jax.jit(
        lambda a, b, box: distances._pair_reduce(
            a, b, box, None, None, None, chunk))(a, b, box)))
    band = []
    for c in (CUTOFF_NM - PAIR_BAND_NM, CUTOFF_NM + PAIR_BAND_NM):
        cut2 = float(np.float32(c) * np.float32(c))
        band.append(np.asarray(jax.jit(
            lambda a, b, box, cut2=cut2: distances._pair_reduce(
                a, b, box, cut2, None, None, chunk))(a, b, box)))
    for f in range(n_frames):
        check(f"frame {f} full-width min distance vs plain form",
              abs(float(out["mindist"][f]) - float(alt_min[f])), TOL_MIN_NM)
        got = int(out["contacts"][f])
        log(f"  frame {f} contacts {got}, band [{band[0][f]}, {band[1][f]}]")
        if not band[0][f] <= got <= band[1][f]:
            raise AssertionError(f"frame {f}: full-width contacts {got} "
                                 "outside the band")
    log(f"  peak device memory {peak_mb(jax.devices()[0])}")
    return out


def phase_four(ctx, batch=BATCH):
    """The flagship on a 4x1 (frames) and a 2x2 (frames x atoms) mesh,
    each against a single-device run in the same process."""
    import jax

    from groan_rs_tpu.parallel.engine import make_mesh

    devs = jax.devices()[:4]
    log(f"[four] flagship on 4 devices: {[str(d) for d in devs]}")
    solo = flagship(ctx.system, mesh=make_mesh(1, 1, devices=devs[:1])
                    ).runner().run(ctx.xtc, batch_size=batch)
    check_shapes(solo, ctx.n_frames)
    check_series("one device vs float64", solo, ctx.ref, ctx.reach,
                 TOL_REF_NM)
    solo64 = {k: np.asarray(solo[k], np.float64) for k in ("com", "dist",
                                                          "rmsd")}
    for shape in ((4, 1), (2, 2)):
        runner = flagship(ctx.system, mesh=make_mesh(*shape, devices=devs)
                          ).runner()
        _, first = timed_run(runner, ctx.xtc, batch_size=batch)
        out, warm = timed_run(runner, ctx.xtc, batch_size=batch)
        check_shapes(out, ctx.n_frames)
        log(f"  mesh {shape[0]}x{shape[1]}: first {first:.3f} s, warm "
            f"{warm:.3f} s = {ctx.n_frames / warm:.2f} frames/s")
        check_series(f"mesh {shape[0]}x{shape[1]} vs one device", out,
                     solo64, ctx.reach, TOL_SAME_NM)
        check_series(f"mesh {shape[0]}x{shape[1]} vs float64", out, ctx.ref,
                     ctx.reach, TOL_REF_NM)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the flagship sharded over 4 GPUs")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 1

    from groan_rs_tpu.compile_cache import enable_compile_cache

    device_report(enable_compile_cache())
    ctx = prepare()
    if args.four:
        phase_four(ctx)
    else:
        runner, streamed = phase_streamed(ctx)
        phase_resident(ctx, runner, streamed)
        phase_small_group(ctx)
        phase_pairs(ctx)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
