"""Minimum-image pair reductions as a Pallas kernel on the Triton route.

`pair_reduce` reduces over all N x M pairs of two orthorhombic-box point
sets without forming the pair matrix: the smallest d^2, or the number of
pairs with d^2 < cutoff^2.  Each
program owns `tile_n` rows of `a` and walks the whole of `b` in
`tile_m`-wide blocks, keeping a per-row running minimum of d^2 (or a
per-row count of d^2 < cutoff^2) in registers; it writes its `tile_n`
row results and nothing carries between programs.  jnp reduces the rows.
Frames map onto a grid axis through `vmap`.

The arithmetic is `ops.distances`' plain form, term for term:
d - L * floor(d * (1/L) + 0.5) per axis, then dx^2 + dy^2 + dz^2.
`interpret=True` runs the kernel in the Pallas interpreter (tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# the fastest of the tile settings timed on an H100 at 99k x 300k atoms
# (benches/pair_ab.py, PERF.md)
TILE_N = 32
TILE_M = 128
NUM_WARPS = 2
NUM_STAGES = 1
_BIG = 1e30  # python float: a jnp constant would be captured by the kernel


def _kernel(ax_ref, ay_ref, az_ref, bx_ref, by_ref, bz_ref, box_ref, out_ref,
            *, m, tile_m, cut2):
    lx, ly, lz = box_ref[0], box_ref[1], box_ref[2]
    ix, iy, iz = box_ref[4], box_ref[5], box_ref[6]
    ax = ax_ref[...][:, None]
    ay = ay_ref[...][:, None]
    az = az_ref[...][:, None]

    def body(j, acc):
        cols = j * tile_m + jnp.arange(tile_m)
        ok = cols < m
        bx = plgpu.load(bx_ref.at[cols], mask=ok, other=0.0)[None, :]
        by = plgpu.load(by_ref.at[cols], mask=ok, other=0.0)[None, :]
        bz = plgpu.load(bz_ref.at[cols], mask=ok, other=0.0)[None, :]
        dx = ax - bx
        dx = dx - lx * jnp.floor(dx * ix + 0.5)
        dy = ay - by
        dy = dy - ly * jnp.floor(dy * iy + 0.5)
        dz = az - bz
        dz = dz - lz * jnp.floor(dz * iz + 0.5)
        d2 = dx * dx + dy * dy + dz * dz
        if cut2 is None:
            return jnp.minimum(
                acc, jnp.min(jnp.where(ok[None, :], d2, _BIG), axis=1))
        hit = ok[None, :] & (d2 < cut2)
        return acc + jnp.sum(jnp.where(hit, 1, 0).astype(jnp.int32), axis=1)

    tile_n = out_ref.shape[0]
    init = (jnp.full((tile_n,), _BIG, jnp.float32) if cut2 is None
            else jnp.zeros((tile_n,), jnp.int32))
    out_ref[...] = lax.fori_loop(0, pl.cdiv(m, tile_m), body, init)


@functools.partial(jax.jit, static_argnames=(
    "cut2", "tile_n", "tile_m", "num_warps", "num_stages", "interpret"))
def _row_reduce(a, b, box, *, cut2, tile_n, tile_m, num_warps, num_stages,
                interpret):
    """a [F, N, 3], b [F, M, 3], box [F, 3] -> per-row results [F, N]."""
    n, m = a.shape[1], b.shape[1]
    n_pad = -(-n // tile_n) * tile_n
    a = jnp.pad(a.astype(jnp.float32), ((0, 0), (0, n_pad - n), (0, 0)))
    b = b.astype(jnp.float32)
    box = box.astype(jnp.float32)
    zero = jnp.zeros_like(box[:, :1])
    box8 = jnp.concatenate([box, zero, 1.0 / box, zero], axis=1)
    row = pl.BlockSpec((tile_n,), lambda i: (i,))
    whole = pl.BlockSpec()
    call = pl.pallas_call(
        functools.partial(_kernel, m=m, tile_m=tile_m, cut2=cut2),
        out_shape=jax.ShapeDtypeStruct(
            (n_pad,), jnp.float32 if cut2 is None else jnp.int32),
        grid=(n_pad // tile_n,),
        in_specs=[row, row, row, whole, whole, whole, whole],
        out_specs=row,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="pair_reduce_triton",
    )
    out = jax.vmap(call)(a[..., 0], a[..., 1], a[..., 2],
                         b[..., 0], b[..., 1], b[..., 2], box8)
    return out[:, :n]


def pair_reduce(a, b, box, cut2, *, tile_n=None, tile_m=None,
                num_warps=None, num_stages=None, interpret=False):
    """Smallest minimum-image d^2 over all pairs (`cut2` None), or the
    number of pairs with d^2 < cut2: a [F, N, 3], b [F, M, 3], box [F, 3]
    -> [F].  Tile settings default to the module constants."""
    rows = _row_reduce(
        a, b, box, cut2=cut2,
        tile_n=tile_n or TILE_N, tile_m=tile_m or TILE_M,
        num_warps=num_warps or NUM_WARPS, num_stages=num_stages or NUM_STAGES,
        interpret=interpret)
    return jnp.min(rows, axis=1) if cut2 is None else jnp.sum(rows, axis=1)
