"""Frame-sharded map-reduce engine (see package docstring)."""

from __future__ import annotations

import time

import numpy as np

from ..errors import ParallelError


def _unpack6(row, k3):
    """One frame of the 6-bit delta wire: 4 biased (u = d+32) 6-bit
    values per 3 bytes, MSB-first -> int32 deltas [k3//3, 3]."""
    import jax.numpy as jnp

    b = row.reshape(-1, 3).astype(jnp.int32)
    u = jnp.stack(
        [b[:, 0] >> 2,
         ((b[:, 0] & 3) << 4) | (b[:, 1] >> 4),
         ((b[:, 1] & 15) << 2) | (b[:, 2] >> 6),
         b[:, 2] & 63],
        axis=1,
    ).reshape(-1)[:k3]
    return (u - 32).reshape(-1, 3)


def make_mesh(n_frames_axis: int | None = None, n_atoms_axis: int = 1, devices=None):
    """Build a `(frames, atoms)` device mesh.

    Default: all devices on the `frames` axis (pure frame data-parallel,
    the reference's decomposition); set `n_atoms_axis > 1` to also shard
    the atom dimension for >HBM systems.
    """
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    if n_frames_axis is None:
        n_frames_axis = max(1, len(devices) // n_atoms_axis)
    n = n_frames_axis * n_atoms_axis
    if n > len(devices):
        raise ParallelError(
            f"mesh {n_frames_axis}x{n_atoms_axis} needs {n} devices, "
            f"have {len(devices)}"
        )
    dev_array = np.array(devices[:n]).reshape(n_frames_axis, n_atoms_axis)
    return Mesh(dev_array, ("frames", "atoms"))


class DeviceTrajectory:
    """A trajectory window held resident in device memory (HBM).

    Decode and ship ONCE (`FrameEngine.materialize` /
    `PipelineRunner.load_device`), then analyze any number of times at
    pure device-compute speed — no file IO, no host->device wire.  The
    int16 quantized representation takes 6 B/atom/frame, so a 1M-atom
    window of F frames holds 6F MB of device memory; re-runs with
    different observables or parameters (the sweep workflow) skip
    everything but the math.

    The reference has no analogue — its closest mechanism is the OS
    page cache over the XTC file (comparison/xdrfile_vs_molly/info.md
    measures warm-cache passes), which still pays decode per pass.
    Dequantization on use is bit-identical to the streamed q16 wire.
    """

    def __init__(self, pos, boxes, inv_prec, times, steps, kind, aux=(),
                 aux_names=None):
        self.pos = pos            # device [F, K, 3] int16/int32 q or f32
        self.boxes = boxes        # device [F, 3] f32 lengths
        self.inv_prec = inv_prec  # device [F] f32 (ones for f32 kind)
        self.times = times        # host [F]
        self.steps = steps        # host [F]
        self.kind = kind          # "q16" (int q) | "f32"
        self.aux = tuple(aux)     # device [F, K, 3] f32 channels (vel/frc)
        # which channel each aux slot holds ("vel"/"frc"), so a later
        # pass can pick the channels it consumes by NAME — a trajectory
        # loaded with velocities still serves a position-only step
        self.aux_names = (tuple(aux_names) if aux_names is not None
                          else ("vel", "frc")[: len(self.aux)])

    @property
    def n_frames(self) -> int:
        return int(self.pos.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.pos.nbytes + self.boxes.nbytes + self.inv_prec.nbytes
                   + sum(a.nbytes for a in self.aux))


class FrameEngine:
    """Runs a per-frame-batch analysis step over a trajectory reader.

    `step_fn(positions[B, K, 3], boxes[B, 3], frame_mask[B]) -> pytree`
    is jitted once per wire format; batches are padded to a multiple of
    the frame-axis device count and sharded over the mesh.  Results come
    back on host, concatenated over frames (padded frames dropped).

    The engine is wire-aware: FrameBatches in the compact "q16"/"delta"
    formats (see io.traj.FrameBatch) dequantize INSIDE the jitted step —
    bit-identical to the float decode path — so the host->device transfer
    ships 6/3 bytes per atom instead of 12.  The delta wire carries a
    persistent int32 quantized frame across batches on device.
    """

    def __init__(self, step_fn, mesh=None,
                 box: str = "lengths", spec=None, aux=()):
        """`spec=(fn, params_device, n_atoms_pad)` switches the engine to
        ATOMS-SHARDED mode: `fn` is a compiled shard_map step from
        `TrajectoryAnalysis.sharded(mesh)` (signature
        `fn(pos, boxes, mask, inv_prec, *params)`, pos f32 or q16 int16),
        positions are sharded over BOTH mesh axes, and the static
        observable arrays ride along pre-placed on the mesh.  The delta
        wires are frame-sequential and unsupported here; use q16/f32.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        if box not in ("lengths", "matrix"):
            raise ParallelError(f"unknown box mode '{box}'")
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape["frames"]
        self._in_shard = NamedSharding(self.mesh, P("frames"))
        self._replicated = NamedSharding(self.mesh, P())
        self._user_step = step_fn
        self._steps = {}
        self._box_mode = box
        self._spec = spec
        if spec is not None:
            self._pos_shard = NamedSharding(self.mesh,
                                            P("frames", "atoms", None))
        # aux channels riding the batch alongside positions: any of
        # ("vel", "frc") — shipped as f32 [B, K, 3] (the TRR decoder's
        # native precision, reference trr_io.rs:30 x/v/f per frame) and
        # appended to the user step's arguments after the mask
        self.aux = tuple(aux)
        if any(a not in ("vel", "frc") for a in self.aux):
            raise ParallelError(f"unknown aux channels {aux}")
        if self.aux and spec is not None:
            raise ParallelError(
                "aux channels are not supported by the atoms-sharded spec")
        self._carry_q = None  # delta-wire device carry (int32 [K, 3])
        self.h2d_bytes = 0  # coordinate bytes shipped (wire accounting)
        # per-batch stage clocks of the most recent pass (see run())
        self.last_stage_seconds = {"decode_wait": [], "h2d": [], "dispatch": []}
        self.last_fetch_seconds = 0.0
        self.last_batch_walls = []
        self.frames_shipped = 0
        # one-deep software pipelining of the run loop (transfer N+1
        # overlaps compute N); set False to retire each batch in order
        self.pipelined = True
        self._unpackers = {}

    def _step_for(self, kind: str):
        if kind == "spec":
            return self._spec[0]
        if kind in self._steps:
            return self._steps[kind]
        import jax
        import jax.numpy as jnp

        user = self._user_step
        if kind == "f32":
            fn = jax.jit(user)
        elif kind == "q16":
            def q16_step(q, boxes, mask, inv_prec, *ax):
                pos = q.astype(jnp.float32) * inv_prec[:, None, None]
                return user(pos, boxes, mask, *ax)

            fn = jax.jit(q16_step)
        elif kind == "delta":
            def delta_step(carry, d, shifts, eidx, eval_, boxes, mask, inv_prec):
                # key-frame reseeds / escape values may ship as int16
                # (half the wire); widen on device
                carry = carry.astype(jnp.int32)

                def body(c, xs):
                    df, sf, ei, ev = xs
                    c = c + df.astype(jnp.int32) + sf[None, :]
                    # escapes: absolute quantized ints; padding rows carry
                    # the out-of-range sentinel index -> dropped
                    c = c.at[ei].set(ev.astype(jnp.int32), mode="drop")
                    return c, c

                carry2, qs = jax.lax.scan(body, carry, (d, shifts, eidx, eval_))
                pos = qs.astype(jnp.float32) * inv_prec[:, None, None]
                return user(pos, boxes, mask), carry2

            fn = jax.jit(delta_step)
        elif kind == "delta6":
            def delta6_step(carry, packed, shifts, eidx, eval_, boxes, mask,
                            inv_prec):
                carry = carry.astype(jnp.int32)
                k3 = carry.shape[0] * 3

                def body(c, xs):
                    pf, sf, ei, ev = xs
                    c = c + _unpack6(pf, k3) + sf[None, :]
                    c = c.at[ei].set(ev.astype(jnp.int32), mode="drop")
                    return c, c

                carry2, qs = jax.lax.scan(body, carry,
                                          (packed, shifts, eidx, eval_))
                pos = qs.astype(jnp.float32) * inv_prec[:, None, None]
                return user(pos, boxes, mask), carry2

            fn = jax.jit(delta6_step)
        else:  # pragma: no cover
            raise ParallelError(f"unknown wire format '{kind}'")
        self._steps[kind] = fn
        return fn

    def _pad(self, arr: np.ndarray, b_target: int, mode: str = "edge",
             value: int = 0) -> np.ndarray:
        b = arr.shape[0]
        if b == b_target:
            return arr
        pad = [(0, b_target - b)] + [(0, 0)] * (arr.ndim - 1)
        if mode == "edge":
            return np.pad(arr, pad, mode="edge")
        return np.pad(arr, pad, mode="constant", constant_values=value)

    @staticmethod
    def _pack_host(arrs):
        """Concatenate host arrays into one uint8 buffer + segment metas."""
        metas = []
        parts = []
        off = 0
        for a in arrs:
            a = np.ascontiguousarray(a)
            raw = a.reshape(-1).view(np.uint8)
            pad = (-raw.size) % 4
            metas.append((str(a.dtype), a.shape, off, raw.size))
            parts.append(raw)
            if pad:
                parts.append(np.zeros(pad, np.uint8))
            off += raw.size + pad
        return np.concatenate(parts), tuple(metas)

    @staticmethod
    def _unpack_exprs(buf, key):
        """Slice + bitcast the packed segments back out (traceable)."""
        import jax

        out = []
        for dt, shape, o, nb in key:
            seg = jax.lax.slice(buf, (o,), (o + nb,))
            if dt == "bool":
                out.append((seg != 0).reshape(shape))
            else:
                it = np.dtype(dt).itemsize
                arr = jax.lax.bitcast_convert_type(
                    seg.reshape(-1, it), np.dtype(dt))
                out.append(arr.reshape(shape))
        return tuple(out)

    def _put_small(self, arrs):
        """Ship several small host arrays as ONE device_put.

        A batch's sidecar arrays (boxes, mask, inv_prec, drift shifts,
        escapes) are a few KB each; rather than one transfer each, pack
        them into one uint8 buffer (4-byte aligned segments), replicate it
        (tiny), and split it back with one jitted kernel whose outputs are
        sharded over the frames axis — so this works on any mesh (the
        slice from a replicated buffer needs no cross-device traffic).
        """
        import jax

        buf_host, key = self._pack_host(arrs)
        unpack = self._unpackers.get(key)
        if unpack is None:
            fn = lambda buf: self._unpack_exprs(buf, key)  # noqa: E731
            if self.mesh.size > 1:
                unpack = jax.jit(
                    fn, out_shardings=tuple(self._in_shard for _ in key))
            else:
                unpack = jax.jit(fn)
            self._unpackers[key] = unpack
        buf = jax.device_put(buf_host, self._replicated)
        return unpack(buf)

    def _put_aux(self, fb, b_pad):
        """Ship the requested aux channels (velocities/forces) as f32
        [B, K, 3] device arrays, frame-sharded like positions."""
        import jax

        if not self.aux:
            return ()
        out = []
        for ch in self.aux:
            arr = fb.velocities if ch == "vel" else fb.forces
            if arr is None:
                raise ParallelError(
                    f"the analysis needs '{ch}' but the trajectory batch "
                    "carries none (XTC stores positions only; use TRR)"
                )
            out.append(jax.device_put(
                self._pad(np.asarray(arr, np.float32), b_pad),
                self._in_shard))
        return tuple(out)

    def _put_inputs(self, fb, b_pad):
        """Device-put one batch in its wire format -> (kind, args tuple)."""
        import jax

        kind = getattr(fb, "wire", "f32")
        self.h2d_bytes += fb.positions.nbytes + sum(
            a.nbytes for a in (fb.base_q, fb.shifts, fb.esc_idx, fb.esc_val)
            if a is not None
        )
        self.frames_shipped += fb.positions.shape[0]
        box_host = (fb.box_matrices() if self._box_mode == "matrix"
                    else fb.box_lengths())
        mask = np.zeros(b_pad, dtype=bool)
        mask[:fb.positions.shape[0]] = True

        if self._spec is not None:
            if kind not in ("f32", "q16"):
                raise ParallelError(
                    "the atoms-sharded step supports the q16/f32 wires only "
                    f"(got '{kind}'); request wire='q16'"
                )
            _, params, n_pad = self._spec
            pos_host = self._pad(fb.positions, b_pad)
            if pos_host.shape[1] != n_pad:
                pos_host = np.pad(
                    pos_host,
                    ((0, 0), (0, n_pad - pos_host.shape[1]), (0, 0)),
                )
            pos = jax.device_put(pos_host, self._pos_shard)
            if kind == "q16":
                inv = np.float32(1.0) / np.asarray(fb.precisions, np.float32)
            else:
                inv = np.ones(len(fb), np.float32)
            boxes, mask_d, inv_d = self._put_small(
                [self._pad(box_host, b_pad), mask, self._pad(inv, b_pad)])
            return "spec", (pos, boxes, mask_d, inv_d) + tuple(params)

        if kind == "f32":
            pos = jax.device_put(self._pad(fb.positions, b_pad), self._in_shard)
            boxes, mask_d = self._put_small(
                [self._pad(box_host, b_pad), mask])
            return kind, (pos, boxes, mask_d) + self._put_aux(fb, b_pad)

        inv = np.float32(1.0) / np.asarray(fb.precisions, np.float32)
        if kind == "q16":
            pos = jax.device_put(self._pad(fb.positions, b_pad), self._in_shard)
            boxes, mask_d, inv_d = self._put_small(
                [self._pad(box_host, b_pad), mask, self._pad(inv, b_pad)])
            return kind, (pos, boxes, mask_d, inv_d) + self._put_aux(fb, b_pad)

        if kind in ("delta", "delta6"):
            if self.aux:
                raise ParallelError(
                    "velocity/force channels ride the q16/f32 wires only; "
                    "request wire='q16' (TRR sources produce f32 batches)"
                )
            if self.n_shards > 1:
                raise ParallelError(
                    "the delta wire reconstructs sequentially over the frame "
                    "axis and cannot be frames-sharded; request wire='q16' "
                    "for multi-device meshes"
                )
            if fb.base_q is not None:
                # int16 key frames ship as-is; delta_step widens on device
                self._carry_q = jax.device_put(
                    np.asarray(fb.base_q), self._replicated
                )
            elif self._carry_q is None:
                raise ParallelError(
                    "delta batch without a base frame and no carry "
                    "(batches consumed out of order?)"
                )
            # pad frames decode to delta 0 (repeat the last real frame in
            # quantized space, keeping the carry exact): zeros for int8
            # deltas; the biased "all u=32" byte pattern for 6-bit packed
            pos_host = fb.positions
            if pos_host.shape[0] != b_pad:
                if kind == "delta6":
                    pad_row = np.tile(np.array([0x82, 0x08, 0x20], np.uint8),
                                      pos_host.shape[1] // 3)
                    pos_host = np.concatenate(
                        [pos_host,
                         np.broadcast_to(pad_row,
                                         (b_pad - pos_host.shape[0],
                                          pos_host.shape[1]))],
                        axis=0,
                    )
                else:
                    pos_host = self._pad(pos_host, b_pad, "zero")
            d = jax.device_put(pos_host, self._in_shard)
            sentinel = (fb.wire_natoms if kind == "delta6"
                        else fb.positions.shape[1])
            sh_host = self._pad(np.asarray(fb.shifts, np.int32), b_pad, "zero")
            # sentinel index = K (out of range -> scatter drops)
            ei_host = self._pad(np.asarray(fb.esc_idx, np.int32), b_pad,
                                "zero", value=sentinel)
            ev_host = self._pad(np.asarray(fb.esc_val), b_pad, "zero")
            sh, ei, ev, boxes, mask_d, inv_d = self._put_small(
                [sh_host, ei_host, ev_host,
                 self._pad(box_host, b_pad), mask, self._pad(inv, b_pad)])
            return kind, (self._carry_q, d, sh, ei, ev, boxes, mask_d, inv_d)
        raise ParallelError(f"unknown wire format '{kind}'")

    def run(self, batches, collect: bool = True, fold=None, init=None,
            on_batch=None, on_carry=None, profiler=None):
        """Iterate FrameBatches, running the step on each.

        - default: per-frame results come back to host, concatenated over
          the trajectory.
        - `fold(carry, step_out, frame_mask) -> carry` keeps the reduction
          ON DEVICE (the `ParallelTrajData::reduce` analogue,
          reference parallel.rs:31-49): the step output never leaves HBM;
          `init` is the initial carry pytree.  Returns (collected, carry).
        - `on_batch(frame_batch)` is called after each batch completes
          (progress ticking / cooperative abort — raise to stop the pass,
          the reference's error-flag analogue, parallel.rs:28,230).

        Scheduling: if `batches` exposes `.release()` (a deferred
        `TrajReader.batches(deferred=True)` loader), the engine forces the
        device transfer while the decoder is idle, dispatches compute,
        releases the next decode, and only then (optionally) syncs, so
        decode overlaps device compute instead of the transfer.
        """
        import jax

        import contextlib

        fold_j = jax.jit(fold) if fold is not None else None
        carry = init
        outs = []
        release = getattr(batches, "release", None)

        # Always-on per-batch stage clocks (microseconds of overhead, no
        # forced syncs): decode_wait and h2d are host-synchronous in the
        # production configuration (the transfer is blocked on before the
        # decoder is released), so these numbers describe the REAL pass —
        # unlike a profiler-instrumented pass, whose per-batch syncs
        # change the schedule they claim to measure.  The residual
        # `pass - sum(stages)` is the overlapped device compute + fetch.
        stage_times = {"decode_wait": [], "h2d": [], "dispatch": []}
        self.last_stage_seconds = stage_times
        self.last_fetch_seconds = 0.0
        # wall timestamp at the end of each batch's dispatch: consecutive
        # deltas are the pipeline's inter-batch intervals, from which a
        # steady-state throughput (excluding fill/drain) can be read —
        # see bench.py `steady_fps`
        self.last_batch_walls = []
        _pc = time.perf_counter

        def _stage(name):
            return profiler.stage(name) if profiler is not None else contextlib.nullcontext()

        # One-deep software pipeline: the host fetch (and callbacks) for
        # batch N are deferred until batch N+1's transfer has been pushed
        # and its step dispatched, so the wire push for N+1 overlaps the
        # device compute of N instead of serializing behind its result.
        pending = None  # (fb, b, res, carry-at-res)

        # Fetches defer further still: results stay on device for the
        # whole pass and come back in ONE packed fetch instead of one
        # np.asarray per batch per leaf.  `on_batch` consumers (progress ticks, hbond host
        # scoring) read only the host-side FrameBatch, never the device
        # result, so they keep working; only `on_carry` (checkpointing
        # must persist the carry as of that batch) and the profiler
        # (stage attribution needs the sync) force per-batch fetches.
        defer_fetch = (collect and on_carry is None and profiler is None)
        dev_outs = []  # (res, n_real_frames) when defer_fetch

        def _retire(p):
            pfb, pb, pres, pcarry = p
            if collect:
                if defer_fetch:
                    dev_outs.append((pres, pb))
                else:
                    outs.append(jax.tree.map(
                        lambda x: np.asarray(x)[:pb], pres))
            if on_batch is not None:
                on_batch(pfb)
            if on_carry is not None and fold_j is not None:
                on_carry(pfb, pcarry)

        it = iter(batches)
        while True:
            if profiler is not None:
                profiler.start_batch(0)
            _t0 = _pc()
            with _stage("decode_wait"):
                fb = next(it, None)
            stage_times["decode_wait"].append(_pc() - _t0)
            if fb is None:
                if profiler is not None:
                    profiler._open = None
                break
            if profiler is not None:
                profiler._open["n_frames"] = len(fb)
            b = fb.positions.shape[0]
            b_pad = -(-b // self.n_shards) * self.n_shards
            try:
                _t0 = _pc()
                with _stage("h2d"):
                    kind, args = self._put_inputs(fb, b_pad)
                    step = self._step_for(kind)
                    if release is not None or profiler is not None:
                        # finish the transfer before waking the decoder
                        jax.block_until_ready(args)
                stage_times["h2d"].append(_pc() - _t0)
                # wake the decoder BEFORE dispatching, so the next
                # batch decodes while this one computes
                if release is not None:
                    release()
                _t0 = _pc()
                with _stage("compute"):
                    res = step(*args)
                    if kind in ("delta", "delta6"):
                        res, self._carry_q = res
                    mask_d = (args[2] if kind not in ("delta", "delta6")
                              else args[6])
                    if fold_j is not None:
                        carry = fold_j(carry, res, mask_d)
                    if profiler is not None:
                        jax.block_until_ready(res)
                stage_times["dispatch"].append(_pc() - _t0)
            except ParallelError:
                raise
            except Exception as e:
                raise ParallelError(
                    f"analysis step failed on frames "
                    f"{int(fb.frame_numbers[0])}..{int(fb.frame_numbers[-1])}: {e}"
                ) from e
            if pending is not None:
                _retire(pending)
            pending = (fb, b, res, carry)
            if not self.pipelined:
                _retire(pending)
                pending = None
            self.last_batch_walls.append(_pc())
            if profiler is not None:
                profiler.end_batch()
        if pending is not None:
            _retire(pending)
        if defer_fetch and dev_outs:
            _t0 = _pc()
            fetched = self._fetch_packed(
                tuple(r for r, _ in dev_outs),
                trims=tuple(b for _, b in dev_outs))
            outs = [fetched]
            self.last_fetch_seconds = _pc() - _t0
        if fold is not None:
            collected = (
                jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *outs)
                if collect and outs else ({} if collect else None)
            )
            return collected, carry
        if not collect:
            return None
        if not outs:
            return {}
        return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *outs)

    def run_oneshot(self, fb):
        """Whole-pass-in-one-put path for small passes.

        Ships positions AND sidecars as ONE packed device_put, evaluates
        every frame in ONE fused jitted dispatch, and fetches the (tiny)
        per-frame results as one packed buffer, instead of a transfer,
        dispatch and fetch per batch (BASELINE.md rows 5-7: the
        reference's ~400-atom partial reads do 5,000 frames in 0.3 s);
        `PipelineRunner.run` routes here when the estimated wire size fits
        `GROAN_ONESHOT_BYTES`.
        """
        import jax
        import jax.numpy as jnp

        kind = getattr(fb, "wire", "f32")
        if kind not in ("q16", "f32"):
            raise ParallelError(
                f"run_oneshot supports the q16/f32 wires only (got '{kind}')")
        if self._user_step is None:
            raise ParallelError("run_oneshot needs a per-batch step")
        b = fb.positions.shape[0]
        box_host = (fb.box_matrices() if self._box_mode == "matrix"
                    else fb.box_lengths())
        mask = np.ones(b, dtype=bool)
        aux_host = []
        for ch in self.aux:
            arr = fb.velocities if ch == "vel" else fb.forces
            if arr is None:
                raise ParallelError(
                    f"the analysis needs '{ch}' but the trajectory batch "
                    "carries none (XTC stores positions only; use TRR)")
            aux_host.append(np.asarray(arr, np.float32))
        if kind == "q16":
            inv = np.float32(1.0) / np.asarray(fb.precisions, np.float32)
            arrs = [fb.positions, box_host, mask, inv] + aux_host
        else:
            arrs = [fb.positions, box_host, mask] + aux_host
        buf_host, metas = self._pack_host(arrs)
        self.h2d_bytes += fb.positions.nbytes
        self.frames_shipped += b
        key = ("oneshot", kind, metas, buf_host.shape)
        cached = self._steps.get(key)
        if cached is None:
            user = self._user_step

            def fused(buf):
                parts = self._unpack_exprs(buf, metas)
                if kind == "q16":
                    q, boxes, m, iv, *ax = parts
                    pos = q.astype(jnp.float32) * iv[:, None, None]
                else:
                    pos, boxes, m, *ax = parts
                return user(pos, boxes, m, *ax)

            # Results come back as ONE packed f32 buffer: the fused step
            # concatenates all float32 leaves and the host unpacks them.
            out_shape = jax.eval_shape(
                fused, jax.ShapeDtypeStruct(buf_host.shape, buf_host.dtype))
            leaves, treedef = jax.tree.flatten(out_shape)
            f32_idx = [i for i, l in enumerate(leaves)
                       if l.dtype == jnp.float32]

            def fused_packed(buf):
                ls = jax.tree.leaves(fused(buf))
                packed = (jnp.concatenate([ls[i].ravel() for i in f32_idx])
                          if f32_idx else jnp.zeros((0,), jnp.float32))
                rest = [ls[i] for i in range(len(ls)) if i not in f32_idx]
                return packed, rest

            cached = (jax.jit(fused_packed), treedef, leaves, f32_idx)
            self._steps[key] = cached
        jfn, treedef, leaves, f32_idx = cached
        _t0 = time.perf_counter()
        buf = jax.device_put(buf_host, self._replicated)
        _t1 = time.perf_counter()
        packed, rest = jax.device_get(jfn(buf))
        _t2 = time.perf_counter()
        # same stage-clock surface the streamed run() exposes (bench reads
        # these).  The put is not blocked on: h2d records only the async
        # put call, the transfer itself rides inside the fused
        # dispatch+fetch window.
        self.last_stage_seconds = {"decode_wait": [], "h2d": [_t1 - _t0],
                                   "dispatch": []}
        self.last_fetch_seconds = _t2 - _t1
        self.last_batch_walls = [_t2]
        outs = [None] * len(leaves)
        off = 0
        for i in f32_idx:
            n = int(np.prod(leaves[i].shape))
            outs[i] = np.asarray(packed[off:off + n]).reshape(leaves[i].shape)
            off += n
        rest_it = iter(rest)
        for i in range(len(leaves)):
            if outs[i] is None:
                outs[i] = np.asarray(next(rest_it))
        import jax.tree_util as jtu
        return jtu.tree_unflatten(treedef, outs)

    # ------------------------------------------------------------------
    # device-resident trajectories
    # ------------------------------------------------------------------

    def _mat_for(self, kind: str):
        """Jitted batch materializer: wire inputs -> (q int32 [B,K,3], carry)."""
        key = ("mat", kind)
        if key in self._steps:
            return self._steps[key]
        import jax
        import jax.numpy as jnp

        if kind == "delta":
            def mat(carry, d, shifts, eidx, eval_):
                carry = carry.astype(jnp.int32)

                def body(c, xs):
                    df, sf, ei, ev = xs
                    c = c + df.astype(jnp.int32) + sf[None, :]
                    c = c.at[ei].set(ev.astype(jnp.int32), mode="drop")
                    return c, c

                return jax.lax.scan(body, carry, (d, shifts, eidx, eval_))[::-1]
        elif kind == "delta6":
            def mat(carry, packed, shifts, eidx, eval_):
                carry = carry.astype(jnp.int32)
                k3 = carry.shape[0] * 3

                def body(c, xs):
                    pf, sf, ei, ev = xs
                    c = c + _unpack6(pf, k3) + sf[None, :]
                    c = c.at[ei].set(ev.astype(jnp.int32), mode="drop")
                    return c, c

                return jax.lax.scan(body, carry,
                                    (packed, shifts, eidx, eval_))[::-1]
        else:  # pragma: no cover
            raise ParallelError(f"no materializer for wire '{kind}'")
        fn = jax.jit(mat)
        self._steps[key] = fn
        return fn

    def materialize(self, batches) -> DeviceTrajectory:
        """Decode + ship a trajectory once; keep it resident on device.

        Consumes a `TrajReader.batches(...)` iterator in any wire format
        and returns a `DeviceTrajectory` of quantized int positions (or
        f32 when the stream is not quantization-representable).  Use
        `run_resident` for every subsequent pass.
        """
        import jax
        import jax.numpy as jnp

        if self.n_shards > 1 or self._spec is not None:
            raise ParallelError(
                "materialize targets a single device's HBM; use a "
                "single-shard engine (frames axis = 1)")
        release = getattr(batches, "release", None)
        qs_parts, box_parts, inv_parts, maxs = [], [], [], []
        aux_parts = [[] for _ in self.aux]
        times, steps = [], []
        kinds = set()
        for fb in batches:
            b = fb.positions.shape[0]
            kind2, args = self._put_inputs(fb, b)
            # Block only on the freshly transferred arrays — NOT the delta
            # carry (args[0]), which is the previous batch's scan output:
            # blocking on it would serialize every transfer behind the
            # previous compute.  Finish the transfer before waking the
            # decoder, as `run` does.
            fresh = args[1:] if kind2 in ("delta", "delta6") else args
            jax.block_until_ready(fresh)
            if release is not None:
                release()
            if kind2 in ("delta", "delta6"):
                qs, self._carry_q = self._mat_for(kind2)(*args[:5])
                inv_parts.append(args[7])
                box_parts.append(args[5])
                kinds.add("q16")
                # lazy device scalar; the single sync happens at the end
                maxs.append(jnp.max(jnp.abs(qs)))
            elif kind2 == "q16":
                qs = args[0]
                box_parts.append(args[1])
                inv_parts.append(args[3])
                kinds.add("q16")
                for ci, arr in enumerate(args[4:]):
                    aux_parts[ci].append(arr)
            elif kind2 == "f32":
                qs = args[0]
                box_parts.append(args[1])
                inv_parts.append(jax.device_put(np.ones(b, np.float32),
                                                self._replicated))
                kinds.add("f32")
                for ci, arr in enumerate(args[3:]):
                    aux_parts[ci].append(arr)
            else:
                raise ParallelError(
                    "materialize supports the f32/q16/delta wires only "
                    f"(got '{kind2}')")
            qs_parts.append(qs)
            times.append(np.asarray(fb.times))
            steps.append(np.asarray(fb.steps))
        if not qs_parts:
            raise ParallelError("empty trajectory")
        if kinds == {"q16"}:
            out_kind = "q16"
            # narrow to int16 when every coordinate fits (6 B/atom HBM).
            # q16-wire parts arrive int16 already; only the int32 scan
            # outputs of the delta wires need the range check — ONE fused
            # device reduction, one sync (was: one blocking sync per
            # part plus per-part astype allocations).
            if maxs:
                hi = int(jnp.max(jnp.stack(maxs)))
            else:
                hi = 0
            dt = jnp.int16 if hi <= 32767 else jnp.int32
            fin = self._finisher(dt)
        else:
            out_kind = "f32"
            fin = self._finisher(jnp.float32)
        pos, boxes, inv = fin(qs_parts, box_parts, inv_parts)
        aux = tuple(jnp.concatenate(parts, axis=0) for parts in aux_parts)
        return DeviceTrajectory(
            pos=pos, boxes=boxes, inv_prec=inv,
            times=np.concatenate(times), steps=np.concatenate(steps),
            kind=out_kind, aux=aux, aux_names=self.aux,
        )

    def _finisher(self, dt):
        """One jitted dispatch assembling the resident trajectory: concat
        over frames + dtype narrowing (+ dequantization for f32) fused —
        no per-part syncs, one device reallocation."""
        import jax
        import jax.numpy as jnp

        key = ("finish", np.dtype(dt).name)
        if key in self._steps:
            return self._steps[key]

        if np.dtype(dt) == np.float32:
            def fin(qs, boxes, invs):
                parts = [
                    (q.astype(jnp.float32) * iv[:, None, None]
                     if q.dtype != jnp.float32 else q)
                    for q, iv in zip(qs, invs)
                ]
                return (jnp.concatenate(parts, axis=0),
                        jnp.concatenate(boxes, axis=0),
                        jnp.ones(sum(i.shape[0] for i in invs), jnp.float32))
        else:
            def fin(qs, boxes, invs):
                return (jnp.concatenate([q.astype(dt) for q in qs], axis=0),
                        jnp.concatenate(boxes, axis=0),
                        jnp.concatenate(invs, axis=0))
        fn = jax.jit(fin)
        self._steps[key] = fn
        return fn

    def _resident_aux(self, dt):
        """The aux channels this step consumes, picked by NAME from the
        trajectory's carried channels: extra channels are ignored (a
        velocity-loaded trajectory serves a position-only step), missing
        ones raise."""
        if not self.aux:
            return ()
        names = tuple(getattr(dt, "aux_names", ()) or ())
        try:
            return tuple(dt.aux[names.index(ch)] for ch in self.aux)
        except ValueError:
            raise ParallelError(
                "this DeviceTrajectory was loaded without the aux "
                f"channels the step needs ({'/'.join(self.aux)}, carried: "
                f"{'/'.join(names) or 'none'}); reload it through a "
                "runner that declares them") from None

    def run_resident(self, dt: DeviceTrajectory, batch_size: int = 32,
                     collect: bool = True, fold=None, init=None,
                     fetch: bool = True):
        """One analysis pass over a device-resident trajectory.

        Pure device work: slices of `dt` feed the jitted step directly;
        nothing crosses the wire but the (tiny) per-frame results.

        `fetch=False` leaves the collected results ON DEVICE (a tuple of
        per-batch pytrees, dispatched asynchronously) so a sweep of many
        passes can share ONE packed fetch at the end — see
        `models.run_many`.
        """
        import jax
        import jax.numpy as jnp

        dt_aux = self._resident_aux(dt)
        fold_j = jax.jit(fold) if fold is not None else None
        carry = init
        outs = []
        step = self._step_for(dt.kind)
        n = dt.n_frames
        masks = {}
        # Per-batch dispatches stay ASYNC (no per-batch `np.asarray`);
        # results accumulate on device and come back in ONE packed fetch
        # below.  The per-batch step is
        # the SAME jitted function the streamed wire uses — compiling
        # the whole pass as one program changes XLA fusion and breaks
        # the bit-identical resident==streamed contract by ~1 ulp.
        for f0 in range(0, n, batch_size):
            f1 = min(f0 + batch_size, n)
            b = f1 - f0
            if b not in masks:
                masks[b] = jax.device_put(np.ones(b, bool), self._replicated)
            pos = jax.lax.dynamic_slice_in_dim(dt.pos, f0, b, 0)
            boxes = jax.lax.dynamic_slice_in_dim(dt.boxes, f0, b, 0)
            ax = tuple(jax.lax.dynamic_slice_in_dim(A, f0, b, 0)
                       for A in dt_aux)
            if dt.kind == "q16":
                inv = jax.lax.dynamic_slice_in_dim(dt.inv_prec, f0, b, 0)
                res = step(pos, boxes, masks[b], inv, *ax)
            else:
                res = step(pos, boxes, masks[b], *ax)
            if fold_j is not None:
                carry = fold_j(carry, res, masks[b])
            if collect:
                outs.append(res)
        if collect:
            collected = (self._fetch_packed(tuple(outs)) if fetch
                         else tuple(outs))
        else:
            collected = None
        if fold is not None:
            return collected, carry
        return collected

    def run_resident_fused(self, dt: DeviceTrajectory, batch_size: int = 32):
        """Whole-window resident pass as ONE device dispatch + ONE packed
        fetch.

        `run_resident` dispatches one step per batch; each dispatch is
        cheap device-side but costs host work — at hundreds of resident
        frames the dispatch stream itself can become the floor.  Here the whole window runs as a
        single jitted program: a `lax.scan` over [nb, B, K, 3] batch
        slabs whose body is the SAME per-batch step computation, then an
        in-program concat + per-dtype packing, so the pass costs one
        dispatch and one fetch regardless of window length.  This is the
        configuration that amortizes fixed per-pass overhead across the
        whole resident window (the 1M-atom parameter-sweep workflow; the
        reference re-decodes the file per pass, info.md:3-15).

        Tiling contract: the scan body is compiled as part of a larger
        program than the per-batch dispatch, so results match
        `run_resident` to f32 ulps (same contract as any other tiling
        change — see tests/test_device_resident.py); integer observables
        with boundary guards (dense hbonds) stay exact through the guard
        re-score.  `fold` consumers use `run_resident`.
        """
        import jax
        import jax.numpy as jnp

        dt_aux = self._resident_aux(dt)
        user = self._user_step
        kind = dt.kind
        n = dt.n_frames
        b = min(batch_size, n)
        nb = -(-n // b)
        n_pad = nb * b

        def pre(args):
            pos, boxes, inv = args[:3]
            ax = args[3:]

            def padf(x):
                if n_pad == n:
                    return x
                reps = jnp.broadcast_to(x[-1:], (n_pad - n,) + x.shape[1:])
                return jnp.concatenate([x, reps], axis=0)

            def slab(x):
                return padf(x).reshape((nb, b) + x.shape[1:])

            mask = (jnp.arange(n_pad) < n).reshape(nb, b)
            xs = [slab(pos), slab(boxes), mask]
            if kind == "q16":
                xs.append(slab(inv))
            xs.extend(slab(a) for a in ax)

            def body(carry, x):
                if kind == "q16":
                    p, bx, m, iv, *a = x
                    out = user(p.astype(jnp.float32) * iv[:, None, None],
                               bx, m, *a)
                else:
                    p, bx, m, *a = x
                    out = user(p, bx, m, *a)
                return carry, out

            _, outs = jax.lax.scan(body, 0, tuple(xs))
            return jax.tree.map(
                lambda o: o.reshape((n_pad,) + o.shape[2:])[:n], outs)

        tree = (dt.pos, dt.boxes, dt.inv_prec) + tuple(dt_aux)
        return self._fetch_tree(tree, pre,
                                ("resident-fused", kind, n, b, len(dt_aux)))

    def _fetch_packed(self, outs, trims=None):
        """Concatenate per-batch result pytrees over the frame axis and
        fetch them in as few transfers as possible: one jitted dispatch
        packs the leaves into one buffer per dtype (see `_fetch_tree`).  `trims[i]` keeps only
        the first `trims[i]` frames of batch i (shard padding)."""
        def catted(os):
            return FrameEngine.cat_batches(os, trims)

        return self._fetch_tree(outs, catted, ("fetch-packed", trims))

    @staticmethod
    def cat_batches(outs, trims=None):
        """Concatenate a tuple of per-batch result pytrees over the frame
        axis (device-side, traceable); `trims[i]` keeps the first
        `trims[i]` frames of batch i.  Shared by the packed fetch and the
        sweep path (models.run_many) so their concat semantics cannot
        drift."""
        import jax
        import jax.numpy as jnp

        if trims is not None:
            outs = tuple(jax.tree.map(lambda x: x[:t], o)
                         for o, t in zip(outs, trims))
        return (jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
                if len(outs) > 1 else outs[0])

    def _fetch_tree(self, tree, pre, tag):
        """Generic pack-and-fetch: apply `pre` (a pure device transform)
        to `tree`, pack the leaves of the result into ONE device buffer
        PER DTYPE in ONE jitted dispatch, and fetch them together (an int
        observable — hbond counts, contacts — rides a packed buffer
        exactly like the f32 ones).  `tag` keys the jit cache alongside
        the tree structure + leaf shapes; any closure state of `pre`
        that changes the computation must be part of it."""
        import jax
        import jax.numpy as jnp
        import jax.tree_util as jtu

        shapes = tuple(
            (tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree))
        key = (tag, jtu.tree_structure(tree), shapes)
        cached = self._steps.get(key)
        if cached is None:
            out_shape = jax.eval_shape(pre, tree)
            leaves, treedef = jax.tree.flatten(out_shape)
            # group leaf indices by dtype, first-appearance order
            groups = []
            by_dt = {}
            for i, l in enumerate(leaves):
                dt = str(l.dtype)
                if dt not in by_dt:
                    by_dt[dt] = []
                    groups.append((dt, by_dt[dt]))
                by_dt[dt].append(i)

            def pack(os):
                ls = jax.tree.leaves(pre(os))
                return tuple(
                    jnp.concatenate([ls[i].ravel() for i in idxs])
                    for _, idxs in groups)

            cached = (jax.jit(pack), treedef, leaves, groups)
            self._steps[key] = cached
        jfn, treedef, leaves, groups = cached
        bufs = jax.device_get(jfn(tree))
        flat = [None] * len(leaves)
        for buf, (_, idxs) in zip(bufs, groups):
            off = 0
            for i in idxs:
                cnt = int(np.prod(leaves[i].shape))
                flat[i] = np.asarray(buf[off:off + cnt]).reshape(
                    leaves[i].shape)
                off += cnt
        return jtu.tree_unflatten(treedef, flat)


def traj_iter_map_reduce(system, filenames, body, *, init=None, fold=None,
                         reduce=None, group: str | None = None,
                         fmt: str | None = None, batch_size: int = 64,
                         start_time=None, end_time=None, step=None,
                         progress=None, mesh=None, collect=None,
                         progress_shards: int | None = None,
                         checkpoint=None):
    """API-parity analogue of `System::traj_iter_map_reduce`
    (reference: parallel.rs:208) running device-parallel.

    - `body(positions, boxes, mask) -> pytree` — the jitted per-batch step,
      sharded over the mesh's `frames` axis (the thread-body analogue).
    - `init` + `fold(carry, step_out, mask) -> carry` — optional DEVICE-side
      reduction across batches (the `ParallelTrajData::{initialize,reduce}`
      protocol, parallel.rs:31-49); per-frame outputs then never leave HBM
      unless `collect=True` is forced.
    - `reduce(x) -> result` — host finalization, applied to the carry (when
      `fold` is given) or to the concatenated per-frame outputs.
    - `progress` — a ProgressPrinter; emits the reference's master-thread
      output: a jump line, the master shard's frames, COMPLETED at its last
      frame, then a final COMPLETED with the globally latest (step, time)
      (parallel.rs:287-296, goldens progress_multithreaded_*.txt).
    - errors in any batch abort the pass: progress flips to FAILED and a
      ParallelError with the frame range propagates (the reference's shared
      error-flag behaviour, parallel.rs:28,230,298-309).
    - `checkpoint` (path, requires `fold`): resumable pass state — the
      frame cursor and the partial reduction are saved after every batch;
      an interrupted pass restarts from the last completed batch
      (SURVEY §5 checkpoint/resume; the reference's analogue is O(1)
      time-seek restart via `with_range`).
    """
    from ..io.traj import cat_iter, traj_iter
    from ..progress import ProgressStatus

    if isinstance(filenames, (list, tuple)):
        reader = cat_iter(system, filenames, fmt=fmt, group=group,
                          batch_size=batch_size, start_time=start_time,
                          end_time=end_time, step=step)
    else:
        reader = traj_iter(system, filenames, fmt=fmt, group=group,
                           batch_size=batch_size, start_time=start_time,
                           end_time=end_time, step=step)

    engine = FrameEngine(body, mesh=mesh)

    on_batch = None
    if progress is not None:
        n_sh = max(progress_shards or engine.n_shards, 1)
        times = reader.times
        steps_arr = reader.steps
        # the master shard's frames (thread 0 of n, parallel.rs:425-448)
        master = np.arange(0, times.shape[0], n_sh)
        state = {"printed": 0}

        progress.print_jumping()

        def on_batch(fb):
            lo = state["printed"]
            # global positions covered so far
            done_until = state.get("done", 0) + len(fb)
            state["done"] = done_until
            while lo < master.shape[0] and master[lo] < done_until:
                g = master[lo]
                progress.print(lo, int(steps_arr[g]), float(times[g]))
                lo += 1
            state["printed"] = lo

    collect_flag = (fold is None) if collect is None else collect

    # resumable pass state (requires a device-side fold)
    ckpt_state = None
    if checkpoint is not None:
        if fold is None:
            raise ParallelError("checkpoint requires a fold reduction")
        from ..io.index_cache import PassState

        ckpt_state = PassState.load(checkpoint, like=init) or PassState(0, init)
        if ckpt_state.cursor > 0:
            init = ckpt_state.carry
            # restrict iteration to the unprocessed tail
            sel = reader.selected_frames()
            skip = sel[: ckpt_state.cursor]
            newmask = reader._mask.copy()
            newmask[skip] = False
            reader._mask = newmask

    on_carry = None
    if ckpt_state is not None:
        import jax

        done = {"n": ckpt_state.cursor}

        def on_carry(fb, carry):
            done["n"] += len(fb)
            ckpt_state.update(done["n"], jax.tree.map(np.asarray, carry))
            ckpt_state.save(checkpoint)

    try:
        out = engine.run(reader.batches(), collect=collect_flag, fold=fold,
                         init=init, on_batch=on_batch, on_carry=on_carry)
    except Exception:
        if progress is not None:
            progress.set_status(ProgressStatus.FAILED)
            progress.print(0, system.get_step(), system.get_time())
        raise

    if progress is not None:
        progress.set_status(ProgressStatus.COMPLETED)
        if state["printed"] > 0:
            # the master shard's own completion prints WITHOUT the end
            # newline (reference: parallel.rs:411 clones the printer with
            # newline_at_end=false for the worker pass)
            saved = progress.newline_at_end
            progress.newline_at_end = False
            g = master[state["printed"] - 1]
            progress.print(0, int(steps_arr[g]), float(times[g]))
            progress.newline_at_end = saved
        # final print with the globally latest step/time (parallel.rs:287-296)
        if times.shape[0] > 0:
            progress.print(0, int(steps_arr[-1]), float(times[-1]))

    if fold is not None:
        collected, carry = out
        result = reduce(carry) if reduce is not None else carry
        return (result, collected) if collect_flag else result
    if reduce is not None:
        return reduce(out)
    return out
