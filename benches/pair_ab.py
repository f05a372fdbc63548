#!/usr/bin/env python
"""A/B of the two minimum-image pair reductions on a GPU.

`ops.distances` reduces minimum distance and contact counts over all
N x M pairs in one of two ways: plain JAX (row chunks under `lax.map`,
each one fused elementwise-plus-reduce pass that XLA compiles) or, lowered
for a GPU without masks, the Pallas kernel of `ops.pair_triton` on the
Triton route.  This script times both on the
synthetic membrane-protein system (`groan_rs_tpu.synthetic`):

- op level at 99k x 300k atoms: plain against several Triton tile
  settings, checked against each other;
- end to end at several widths up to Protein x Membrane (99k x 300k): an
  `add_min_distance` + `add_contacts` pass through
  `TrajectoryAnalysis(...).runner().run(...)`, streamed from the XTC and
  over a `load_device` window, in turns (plain, triton, triton, plain).

Run from the repository root on a machine with a GPU:
    python benches/pair_ab.py
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CUTOFF = 0.35
# (tile_n, tile_m, warps, stages) of the op-level sweep
CONFIGS = [(32, 128, 2, 1), (32, 128, 4, 1), (32, 256, 4, 1), (32, 64, 2, 1),
           (16, 128, 2, 1)]
# (protein atoms, membrane atoms, frames) of the end-to-end passes
WIDTHS = [(4_000, 4_000, 96), (16_000, 16_000, 96), (32_000, 32_000, 96),
          (99_000, 300_000, 4)]


def log(msg):
    print(msg, flush=True)


def best_of(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def op_level(coords, box, n_prot, n_mem):
    import jax
    import jax.numpy as jnp

    from groan_rs_tpu.ops import distances, pair_triton

    log(f"== op level, {n_prot} x {n_mem}, 4 frames, min + count ==")
    pos = jnp.asarray(coords[:4])
    a, b = pos[:, :n_prot], pos[:, n_prot:n_prot + n_mem]
    bx = jnp.broadcast_to(jnp.asarray(box), (4, 3))
    cut2 = float(np.float32(CUTOFF) * np.float32(CUTOFF))
    chunk = distances._PAIR_CHUNK_ELEMS
    fmin = jax.jit(lambda a, b, bx: distances._pair_reduce(
        a, b, bx, None, None, None, chunk))
    fcnt = jax.jit(lambda a, b, bx: distances._pair_reduce(
        a, b, bx, cut2, None, None, chunk))
    t = best_of(lambda: (fmin(a, b, bx), fcnt(a, b, bx)))
    ref = np.asarray(fmin(a, b, bx)), np.asarray(fcnt(a, b, bx))
    log(f"  plain: {t * 1e3:.3f} ms")
    for tn, tm, nw, ns in CONFIGS:
        kw = dict(tile_n=tn, tile_m=tm, num_warps=nw, num_stages=ns)
        try:
            gmin = jax.jit(lambda a, b, bx, kw=kw: pair_triton.pair_reduce(
                a, b, bx, None, **kw))
            gcnt = jax.jit(lambda a, b, bx, kw=kw: pair_triton.pair_reduce(
                a, b, bx, cut2, **kw))
            t = best_of(lambda: (gmin(a, b, bx), gcnt(a, b, bx)))
            dmin = float(np.abs(np.asarray(gmin(a, b, bx)) - ref[0]).max())
            dcnt = int(np.abs(np.asarray(gcnt(a, b, bx)) - ref[1]).max())
            log(f"  triton {tn}x{tm} warps {nw} stages {ns}: "
                f"{t * 1e3:.3f} ms; vs plain d2 {dmin:.2e}, count {dcnt}")
        except Exception as e:  # a setting the compiler refuses
            log(f"  triton {tn}x{tm} warps {nw} stages {ns}: FAILED "
                f"{type(e).__name__}: {str(e)[:300]}")


def _plain_reduce(a, b, box, cut2):
    """The plain form, standing in for the kernel in the plain arm."""
    from groan_rs_tpu.ops import distances

    return distances._pair_reduce(a, b, box, cut2, None, None,
                                  distances._PAIR_CHUNK_ELEMS)


def end_to_end(system, xtc, n_prot):
    from groan_rs_tpu.models import TrajectoryAnalysis
    from groan_rs_tpu.ops import pair_triton

    kernel = pair_triton.pair_reduce
    for na, nb, frames in WIDTHS:
        g1, g2 = f"P{na}", f"M{nb}"
        system.group_create_from_ranges(g1, [(0, na - 1)])
        system.group_create_from_ranges(g2, [(n_prot, n_prot + nb - 1)])
        end = (frames - 1) * 10.0
        batch = min(frames, 12)
        log(f"== end to end, {na} x {nb}, {frames} frames, batch {batch} ==")
        runners, dts, outs = {}, {}, {}
        for impl, reduce in (("plain", _plain_reduce), ("triton", kernel)):
            # the runners trace here, so each keeps the arm it was built in
            pair_triton.pair_reduce = reduce
            r = (TrajectoryAnalysis(system)
                 .add_min_distance(g1, g2, name="mind")
                 .add_contacts(g1, g2, CUTOFF, name="cont").runner())
            outs[impl] = r.run(xtc, end_time=end, batch_size=batch)
            dts[impl] = r.load_device(xtc, end_time=end, batch_size=batch)
            r.run(dts[impl], batch_size=batch)
            runners[impl] = r
        pair_triton.pair_reduce = kernel
        log(f"  results: min diff "
            f"{np.abs(outs['plain']['mind'] - outs['triton']['mind']).max():.2e}"
            f", count diff "
            f"{np.abs(outs['plain']['cont'] - outs['triton']['cont']).max()}")
        for impl in ("plain", "triton", "triton", "plain"):
            r = runners[impl]
            t0 = time.perf_counter()
            r.run(xtc, end_time=end, batch_size=batch)
            e2e = time.perf_counter() - t0
            t0 = time.perf_counter()
            r.run(dts[impl], batch_size=batch)
            res = time.perf_counter() - t0
            log(f"  {impl}: streamed {e2e:.4f} s ({frames / e2e:.2f} f/s); "
                f"resident {res:.5f} s ({frames / res:.2f} f/s)")
        del dts


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("pair_ab: needs a GPU")
    from groan_rs_tpu import synthetic
    from groan_rs_tpu.compile_cache import enable_compile_cache
    from groan_rs_tpu.io import native

    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"card: {card}; jax {jax.__version__}")
    n_atoms, n_frames = 1_000_000, 96
    xtc = synthetic.ensure_trajectory(os.path.join(ROOT, ".bench_cache"),
                                      n_atoms, n_frames)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offs[:4], nat)
    box = b9[0][[0, 4, 8]].astype(np.float32)
    system, _ = synthetic.build_system(n_atoms, coords[0], box)
    n_prot, n_mem = synthetic.group_sizes(n_atoms)
    op_level(coords, box, n_prot, n_mem)
    end_to_end(system, xtc, n_prot)


if __name__ == "__main__":
    main()
