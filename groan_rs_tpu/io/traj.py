"""Trajectory reader/writer protocol.

Batched re-design of the reference reader stack (`src/io/traj_read.rs`,
`xtc_io/`, `trr_io/`, `gro_io/trajectory.rs`, `traj_cat.rs`):

- Every format exposes a **frame index** (offsets/steps/times scanned once,
  O(frames)); range/step/concatenation are pure index arithmetic instead of
  the reference's seek-and-skip adapters (`with_range`/`with_step`,
  traj_read.rs:301-514; jump logic xdrfile_jump.c:25).
- `TrajReader` iterates frame-by-frame updating a `System` (API parity with
  `system.xtc_iter()` -> yields the mutated system), while `batches()`
  yields `[B, N, 3]` numpy FrameBatches decoded in bulk by the native codec
  with a background prefetch thread — the device pipeline path with zero
  per-frame host round-trips.
- Group/partial reads decode only the first `last_selected_atom + 1` atoms
  (sequential decompression early-stop, the molly trick at
  molly_xtc.rs:58-63) and gather the selection.
- Concatenation dedupes adjacent equal-time frames exactly like
  `TrajConcatenator` (traj_cat.rs:229-260).
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass

import numpy as np

from ..core.simbox import SimBox
from ..errors import ReadTrajError, WriteTrajError
from ..files import FileType
from ..progress import ProgressPrinter, ProgressStatus
from . import native

TIME_PRECISION = 0.001  # reference: molly_xtc.rs:30


# =====================================================================
# Frame batches
# =====================================================================

@dataclass
class FrameBatch:
    """A decoded batch of frames (host numpy, ready for device_put).

    `wire` selects the on-wire coordinate format (the compact formats cut
    host->device transfer; all dequantize on
    device bit-identically to the float decode path):
      - "f32":   positions are float32 [B, K, 3] (12 B/atom)
      - "q16":   positions are raw quantized int16 (6 B/atom);
                 pos = f32(q) * (1/precision)
      - "delta": positions are int8 inter-frame deltas (~3 B/atom) with
                 per-frame drift `shifts` [B, 3] i32 and sparse escapes
                 (`esc_idx` [B, E] i32, `esc_val` [B, E, 3] i32/i16; index
                 K marks padding).  `base_q` [K, 3] i32/i16, present on
                 chain resets, (re)seeds the device-side carry:
                   carry += shifts[f] + deltas[f]; carry[esc_idx[f]] = esc_val[f]
      - "delta6": positions are 6-bit PACKED biased deltas (2.25 B/atom;
                 u = d + 32, four values per 3 bytes, escapes at
                 |d| > 31); `wire_natoms` carries the atom count and the
                 same shifts/escape/key-frame machinery applies
    """

    positions: np.ndarray  # [B, K, 3] (dtype per `wire`)
    boxes9: np.ndarray  # [B, 9] gro-order box components
    steps: np.ndarray  # [B]
    times: np.ndarray  # [B]
    frame_numbers: np.ndarray  # [B] global frame indices in the iteration
    velocities: np.ndarray | None = None
    forces: np.ndarray | None = None
    precisions: np.ndarray | None = None
    has_x: np.ndarray | None = None  # [B] bool (TRR frames may lack blocks)
    has_v: np.ndarray | None = None
    has_f: np.ndarray | None = None
    vel_mask: np.ndarray | None = None  # [B, K] per-atom velocity presence
                                        # (mixed-velocity GRO frames)
    atom_indices: np.ndarray | None = None  # selection indices if partial
    wire: str = "f32"
    wire_natoms: int | None = None  # atom count for packed wires (delta6)
    base_q: np.ndarray | None = None  # i32 [K, 3] delta-chain key frame
    shifts: np.ndarray | None = None  # i32 [B, 3] per-frame drift
    esc_idx: np.ndarray | None = None  # i32 [B, E]
    esc_val: np.ndarray | None = None  # i32 [B, E, 3]

    def __len__(self) -> int:
        return self.positions.shape[0]

    def box_lengths(self) -> np.ndarray:
        """[B, 3] orthogonal box lengths (v1x, v2y, v3z)."""
        return self.boxes9[:, :3]

    def box_matrices(self) -> np.ndarray:
        """[B, 3, 3] row-major box matrices."""
        b = self.boxes9
        out = np.zeros((b.shape[0], 3, 3), np.float32)
        out[:, 0, 0] = b[:, 0]
        out[:, 1, 1] = b[:, 1]
        out[:, 2, 2] = b[:, 2]
        out[:, 0, 1] = b[:, 3]
        out[:, 0, 2] = b[:, 4]
        out[:, 1, 0] = b[:, 5]
        out[:, 1, 2] = b[:, 6]
        out[:, 2, 0] = b[:, 7]
        out[:, 2, 1] = b[:, 8]
        return out


def _pad_escapes(ei: np.ndarray, ev: np.ndarray, stop: int):
    """Pad the escape width up to a bounded set of buckets so jitted
    consumers see few distinct shapes (pad index = `stop`, the
    scatter-drop sentinel).  Power-of-two buckets below 1024, then
    multiples of 1024: at ~10 B per slot the pow2 rounding was costing
    up to half the escape wire on large systems (a 4.1k-escape frame
    padded to 8192), while >=1024-escape frames waste <=1023 slots."""
    e = ei.shape[1]
    if e == 0:
        tgt = 0
    elif e <= 1024:
        tgt = max(16, 1 << (e - 1).bit_length())
    else:
        tgt = -(-e // 1024) * 1024
    if tgt > e:
        ei = np.concatenate(
            [ei, np.full((ei.shape[0], tgt - e), stop, np.int32)], axis=1)
        ev = np.concatenate(
            [ev, np.zeros((ev.shape[0], tgt - e, 3), ev.dtype)], axis=1)
    return ei, ev


def _xtc_box_to_gro9(box33: np.ndarray) -> np.ndarray:
    """[F, 9] row-major 3x3 (XTC/TRR storage) -> gro-order 9-vector."""
    b = box33.reshape(-1, 3, 3)
    out = np.empty((b.shape[0], 9), np.float32)
    out[:, 0] = b[:, 0, 0]
    out[:, 1] = b[:, 1, 1]
    out[:, 2] = b[:, 2, 2]
    out[:, 3] = b[:, 0, 1]
    out[:, 4] = b[:, 0, 2]
    out[:, 5] = b[:, 1, 0]
    out[:, 6] = b[:, 1, 2]
    out[:, 7] = b[:, 2, 0]
    out[:, 8] = b[:, 2, 1]
    return out


# =====================================================================
# Frame sources (per format)
# =====================================================================

class FrameSource:
    """A trajectory file with a scanned frame index."""

    kind: str
    path: str
    natoms: int
    times: np.ndarray  # f32 [F]
    steps: np.ndarray  # i64 [F]

    def n_frames(self) -> int:
        return self.times.shape[0]

    def read_batch(self, frame_ids: np.ndarray, stop_after: int | None = None) -> FrameBatch:
        raise NotImplementedError


class XtcSource(FrameSource):
    kind = "xtc"

    def __init__(self, path, use_index_cache: bool = True):
        from .index_cache import load_index, save_index

        self.path = str(path)
        # Two independent XTC backends, like the reference's molly/xdrfile
        # pair (src/io/xtc_io/): the C++ codec (default) or the pure-Python
        # one (GROAN_XTC_BACKEND=py).  Both are bit-identical; the py
        # backend forces the plain f32 wire (no compact-wire entry points).
        self._codec = native
        self.native_wire = True
        if os.environ.get("GROAN_XTC_BACKEND", "native") == "py":
            from . import xtc_py
            self._codec = xtc_py
            self.native_wire = False
        cached = load_index(self.path) if use_index_cache else None
        if cached is not None:
            offsets = cached["offsets"]
            steps = cached["steps"]
            times = cached["times"]
            natoms = int(cached["natoms"])
        else:
            offsets, steps, times, natoms = self._codec.xtc_scan(self.path)
            if use_index_cache:
                save_index(self.path, dict(offsets=offsets, steps=steps,
                                           times=times, natoms=natoms))
        if natoms <= 0:
            # an empty/headerless file has no magic number to read
            # (reference: ReadTrajError::CouldNotReadMagic, xtc_io tests)
            raise ReadTrajError(
                f"could not read magic number from '{self.path}' (empty or "
                "not an xtc file)", code="CouldNotReadMagic",
            )
        self.offsets = offsets
        self.steps = steps.astype(np.int64)
        self.times = times
        self.natoms = natoms

    def read_batch(self, frame_ids, stop_after=None):
        coords, boxes, steps, times, precisions = self._codec.xtc_read_frames(
            self.path, self.offsets[frame_ids], self.natoms, stop_after=stop_after
        )
        return FrameBatch(
            positions=coords,
            boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64),
            times=times,
            frame_numbers=np.asarray(frame_ids, np.int64),
            precisions=precisions,
        )


class TrrSource(FrameSource):
    kind = "trr"

    def __init__(self, path):
        self.path = str(path)
        offsets, steps, times, lambdas, flags, natoms = native.trr_scan(self.path)
        if natoms <= 0:
            raise ReadTrajError(
                f"could not read magic number from '{self.path}' (empty or "
                "not a trr file)", code="CouldNotReadMagic",
            )
        self.offsets = offsets
        self.steps = steps.astype(np.int64)
        self.times = times.astype(np.float32)
        self.lambdas = lambdas
        self.flags = flags
        self.natoms = natoms

    def read_batch(self, frame_ids, stop_after=None):
        # byte-level partial read: TRR blocks are uncompressed, so only the
        # first stop_after atoms of each x/v/f block are fetched
        x, v, f, boxes, steps, times, lambdas, flags = native.trr_read_frames(
            self.path, self.offsets[frame_ids], self.natoms, stop_after=stop_after
        )
        return FrameBatch(
            positions=x,
            velocities=v,
            forces=f,
            boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64),
            times=times.astype(np.float32),
            frame_numbers=np.asarray(frame_ids, np.int64),
            has_x=(flags & 1) > 0,
            has_v=(flags & 2) > 0,
            has_f=(flags & 4) > 0,
        )


_TIME_STEP_RE = re.compile(r"t=\s*([\d\.\-]+)\s+step=\s*(\d+)")


class GroSource(FrameSource):
    """Multi-frame GRO trajectory (reference: gro_io/trajectory.rs:37).

    Streaming design: construction only SCANS the file (recording each
    frame's byte offset, time and step from the title line); atom blocks
    are parsed lazily per requested batch, so arbitrarily large multi-frame
    GRO files never materialize whole in memory.
    """

    kind = "gro"

    def __init__(self, path):
        self.path = str(path)
        offsets, times, steps = [], [], []
        natoms = None
        try:
            fh = open(path, "rb")
        except OSError:
            raise ReadTrajError(f"file '{path}' was not found", code="FileNotFound") from None
        with fh:
            while True:
                start = fh.tell()
                title = fh.readline()
                if not title:
                    break
                if not title.strip() and not fh.readline():
                    break
                if not title.strip():
                    raise ReadTrajError(
                        f"could not parse number of atoms in '{path}'", code="FrameNotFound"
                    )
                nline = fh.readline()
                try:
                    n = int(nline.strip())
                except ValueError:
                    raise ReadTrajError(
                        f"could not parse number of atoms in '{path}'", code="FrameNotFound"
                    ) from None
                if natoms is None:
                    natoms = n
                elif natoms != n:
                    raise ReadTrajError(
                        f"inconsistent atom count in '{path}'", code="AtomsNumberMismatch"
                    )
                for _ in range(n + 1):  # atom lines + box line
                    if not fh.readline():
                        raise ReadTrajError(
                            f"truncated frame in '{path}'", code="FrameNotFound"
                        )
                m = _TIME_STEP_RE.search(title.decode(errors="replace"))
                if m:
                    t, st = float(m.group(1)), int(m.group(2))
                else:
                    # a title without t=/step= keeps the previous frame's
                    # values (reference: time.unwrap_or(system time),
                    # gro_io/trajectory.rs:210,340)
                    t = times[-1] if times else 0.0
                    st = steps[-1] if steps else 0
                offsets.append(start)
                times.append(t)
                steps.append(st)

        self.natoms = natoms or 0
        self._offsets = np.asarray(offsets, np.int64)
        self.times = np.asarray(times, np.float32)
        self.steps = np.asarray(steps, np.int64)

    def n_frames(self) -> int:
        return self._offsets.shape[0]

    def _parse_frame(self, fh, stop):
        from ..utils.textcols import FixedWidthLines
        from .gro import parse_atom_block, parse_box_line

        fh.readline()  # title
        n = int(fh.readline().strip())
        # one bulk read of the frame's atom block + box line, parsed as a
        # byte matrix (no per-line Python strings; see io/gro.py)
        blob = b"".join(fh.readline() for _ in range(n + 1))
        box_start = blob.rfind(b"\n", 0, len(blob) - 1) + 1
        try:
            fw = FixedWidthLines.from_bytes(blob[:box_start], n_lines=n)
            _, _, _, _, pos, vel, has_vel = parse_atom_block(None, fw=fw)
        except Exception as e:
            raise ReadTrajError(
                f"could not parse frame in '{self.path}': {e}", code="FrameNotFound"
            ) from None
        try:
            box = parse_box_line(blob[box_start:].decode(errors="replace"))
        except Exception as e:
            raise ReadTrajError(f"invalid box in '{self.path}': {e}", code="InvalidBox") from None
        box9 = np.array(list(iter(box)), np.float32)
        return (pos[:stop], (vel[:stop] if vel is not None else None),
                np.asarray(has_vel)[:stop], box9)

    def read_batch(self, frame_ids, stop_after=None):
        stop = stop_after if stop_after is not None else self.natoms
        ids = np.asarray(frame_ids)
        b = len(ids)
        pos = np.zeros((b, stop, 3), np.float32)
        vel = np.zeros((b, stop, 3), np.float32)
        has_v = np.zeros(b, bool)
        vel_mask = np.zeros((b, stop), bool)
        boxes = np.zeros((b, 9), np.float32)
        with open(self.path, "rb") as fh:
            for k, fid in enumerate(ids):
                fh.seek(self._offsets[fid])
                p, v, hv, box9 = self._parse_frame(fh, stop)
                pos[k] = p
                if v is not None:
                    vel[k] = v
                    # per-atom presence: a frame may mix lines with and
                    # without velocity columns (reference: line_as_atom
                    # leaves velocity None per atom)
                    vel_mask[k] = hv
                    has_v[k] = bool(hv.any())
                boxes[k] = box9
        return FrameBatch(
            positions=pos,
            velocities=vel,
            boxes9=boxes,
            steps=self.steps[ids],
            times=self.times[ids],
            frame_numbers=ids.astype(np.int64),
            has_x=np.ones(b, bool),
            has_v=has_v,
            has_f=np.zeros(b, bool),
            vel_mask=vel_mask,
        )


def open_source(path, fmt: str | None = None) -> FrameSource:
    if fmt is None:
        fmt = FileType.from_name(path).value
    if fmt == "xtc":
        return XtcSource(path)
    if fmt == "trr":
        return TrrSource(path)
    if fmt == "gro":
        return GroSource(path)
    if fmt == "tng":
        from .tng import TngSource

        return TngSource(path)
    if fmt in ("dcd", "nc", "lammpstrj", "xyz", "mol2"):
        from .chem import open_extra_source

        return open_extra_source(path, fmt)
    raise ReadTrajError(f"unsupported trajectory format '{fmt}' ('{path}')", code="UnknownFormat")


# =====================================================================
# The reader facade
# =====================================================================

class TrajReader:
    """Iterator over trajectory frames, updating a System per frame.

    reference: `TrajReader`/`TrajRangeRead`/`TrajStepRead`
    (traj_read.rs:128-514).  Also exposes `batches()` for the bulk device
    pipeline.
    """

    def __init__(self, system, sources: list[FrameSource], group: str | None = None,
                 batch_size: int = 64, indices=None):
        self.system = system
        self.sources = sources
        self.group = group
        self.batch_size = batch_size
        self.progress: ProgressPrinter | None = None
        if group is not None and indices is not None:
            raise ReadTrajError(
                "pass either group or indices, not both", code="InvalidSelection"
            )

        natoms = sources[0].natoms
        for s in sources:
            if s.natoms != natoms:
                raise ReadTrajError(
                    f"'{s.path}' has {s.natoms} atoms, expected {natoms}",
                    code="AtomsNumberMismatch",
                )
        if natoms != system.get_n_atoms():
            raise ReadTrajError(
                f"trajectory '{sources[0].path}' has {natoms} atoms but "
                f"system has {system.get_n_atoms()}",
                code="AtomsNumberMismatch",
            )

        if group is not None:
            self._sel = system.group_indices(group)
            self._stop_after = int(self._sel[-1]) + 1 if len(self._sel) else 0
        elif indices is not None:
            sel = np.unique(np.asarray(indices, np.int64))
            if len(sel) and (sel[0] < 0 or sel[-1] >= natoms):
                raise ReadTrajError(
                    f"selection indices out of range [0, {natoms})",
                    code="InvalidSelection",
                )
            self._sel = sel
            self._stop_after = int(sel[-1]) + 1 if len(sel) else 0
        else:
            self._sel = None
            self._stop_after = None
        # contiguous selections (whole-group reads usually are) write back
        # into the System as a slice: a 40k-atom fancy scatter costs
        # ~1 ms/frame — more than the frame's decode.  The selection is
        # fixed per reader, so decide once here.
        self._sel_slice = None
        if self._sel is not None and len(self._sel) and \
                int(self._sel[-1]) - int(self._sel[0]) + 1 == len(self._sel):
            self._sel_slice = slice(int(self._sel[0]), int(self._sel[-1]) + 1)

        # global frame table: (source_idx, local_frame, time, step)
        src_ids, local_ids, times, steps = [], [], [], []
        last_time = None
        for si, s in enumerate(sources):
            at_boundary = si > 0
            for fi in range(s.n_frames()):
                t = float(s.times[fi])
                # concatenation dedup: drop equal-time frames ONLY at file
                # boundaries; duplicates inside one file are kept
                # (reference: traj_cat.rs:229-260, test at traj_cat.rs:624)
                if at_boundary and last_time is not None and t == last_time:
                    continue
                at_boundary = False
                src_ids.append(si)
                local_ids.append(fi)
                times.append(t)
                steps.append(int(s.steps[fi]))
                last_time = t
        self._src = np.array(src_ids, np.int64)
        self._local = np.array(local_ids, np.int64)
        self._times = np.array(times, np.float32)
        self._steps = np.array(steps, np.int64)
        self._mask = np.ones(self._times.shape[0], bool)
        # stepping state: the reference's adapters commute —
        # `.with_step(n).with_range(a, b)` equals
        # `.with_range(a, b).with_step(n)` because jumping to the range
        # start restarts the step counter there (traj_read.rs:474
        # TrajStepReader::with_range).  Track the pre-step selection and
        # the accumulated step so with_range can re-anchor the stride.
        self._prestep_mask = self._mask.copy()
        self._step_factor = 1

    def _apply_step(self):
        sel = np.nonzero(self._prestep_mask)[0][::self._step_factor]
        m = np.zeros_like(self._prestep_mask)
        m[sel] = True
        self._mask = m

    # ------------------------------------------------------------- adapters
    def with_range(self, start_time: float, end_time: float) -> "TrajReader":
        """Restrict to sim times in [start, end] (reference: traj_read.rs:301)."""
        if start_time < 0 or end_time < 0:
            raise ReadTrajError("range times must be non-negative", code="TimeRangeNegative")
        if start_time > end_time:
            raise ReadTrajError("range start exceeds end", code="InvalidTimeRange")
        if self.progress is not None:
            self.progress.print_jumping()
        rng = (self._times >= start_time - TIME_PRECISION) & (
            self._times <= end_time + TIME_PRECISION
        )
        self._prestep_mask &= rng
        self._apply_step()
        if not self._mask.any():
            raise ReadTrajError(
                f"start of time range ({start_time} ps) not found in trajectory",
                code="StartNotFound",
            )
        return self

    def with_host_shard(self, host_id: int, n_hosts: int) -> "TrajReader":
        """Restrict to this host's frame stripe for multi-host passes.

        The multi-host (DCN) decomposition: each host opens the shared file
        and takes frames `host_id::n_hosts` of the current selection by
        byte offsets from the frame index — the cross-host generalization
        of the reference's per-thread striding (parallel.rs:425-448).
        Per-host partial reductions combine with a final cross-host
        collective or gather.
        """
        if not (0 <= host_id < n_hosts):
            raise ReadTrajError(
                f"host_id {host_id} not in [0, {n_hosts})", code="InvalidHostShard"
            )
        sel = np.nonzero(self._mask)[0]
        keep = sel[host_id::n_hosts]
        newmask = np.zeros_like(self._mask)
        newmask[keep] = True
        self._mask = newmask
        # materialize: the stripe is the new baseline selection (stepping
        # before/after a host shard does not need range re-anchoring)
        self._prestep_mask = newmask.copy()
        self._step_factor = 1
        return self

    def with_step(self, step: int) -> "TrajReader":
        """Every `step`-th frame of the current selection
        (reference: traj_read.rs:394)."""
        if step == 0:
            raise ReadTrajError("step must be non-zero", code="InvalidStep")
        self._step_factor *= int(step)
        self._apply_step()
        return self

    def print_progress(self, printer: ProgressPrinter) -> "TrajReader":
        self.progress = printer
        return self

    # ------------------------------------------------------------- frame info
    def selected_frames(self) -> np.ndarray:
        return np.nonzero(self._mask)[0]

    def n_selected(self) -> int:
        return int(self._mask.sum())

    @property
    def times(self) -> np.ndarray:
        return self._times[self._mask]

    @property
    def steps(self) -> np.ndarray:
        return self._steps[self._mask]

    def read_frames(self, frame_ids) -> "FrameBatch":
        """Read an arbitrary set of frames (absolute frame numbers in the
        concatenated stream) as ONE absolute-coordinate (f32) FrameBatch —
        the random-access companion to `batches()` (used e.g. by the
        strict dense-hbond re-score to revisit flagged frames)."""
        ids = np.asarray(frame_ids, np.int64)
        srcs = self._src[ids]
        parts = []
        for si in np.unique(srcs):
            parts.append(self.sources[int(si)].read_batch(
                self._local[ids[srcs == si]], stop_after=self._stop_after))
        if len(parts) == 1:
            out = parts[0]
        else:
            out = FrameBatch(
                positions=np.concatenate([p.positions for p in parts]),
                boxes9=np.concatenate([p.boxes9 for p in parts]),
                steps=np.concatenate([p.steps for p in parts]),
                times=np.concatenate([p.times for p in parts]),
                frame_numbers=np.concatenate(
                    [p.frame_numbers for p in parts]),
                velocities=_cat_opt([p.velocities for p in parts]),
                forces=_cat_opt([p.forces for p in parts]),
                precisions=_cat_opt([p.precisions for p in parts]),
                has_x=_cat_opt([p.has_x for p in parts]),
                has_v=_cat_opt([p.has_v for p in parts]),
                has_f=_cat_opt([p.has_f for p in parts]),
            )
        if self._sel is not None and out.atom_indices is None:
            self._gather_selection(out)
        return out

    # ------------------------------------------------------------- batch pipeline
    def batches(self, batch_size: int | None = None, prefetch: bool = True,
                wire: str = "f32", deferred: bool = False):
        """Iterate FrameBatches (bulk native decode, background prefetch).

        `wire` requests a host->device coordinate format ("f32", "q16",
        "delta", "delta6", or "auto" = smallest the file supports, with
        per-chunk fallback delta6 -> delta -> q16 -> f32); see
        `FrameBatch`.  Non-XTC sources
        always produce f32.  With `deferred=True` the returned loader does
        NOT start decoding the next chunk until `.release()` is called:
        the consumer calls release() after its transfer completes so
        decode overlaps device compute, not the transfer (FrameEngine
        does this).
        """
        bs = batch_size or self.batch_size
        sel = self.selected_frames()
        chunks = [sel[i : i + bs] for i in range(0, len(sel), bs)]
        wire = os.environ.get("GROAN_WIRE", wire)
        if wire not in ("f32", "q16", "delta", "delta6", "auto"):
            raise ReadTrajError(f"unknown wire format '{wire}'", code="InvalidWire")
        # delta chains across consecutive chunks of one file; state below.
        # ladder: 6-bit packed deltas -> int8 deltas -> q16 -> f32, each
        # tier falling through on DeltaRange/Q16Range with hysteresis.
        # atom selections are gathered INSIDE the native delta decoders
        # (deltas/escapes/key frames in selection space — no host gather
        # pass); the q16/f32 tiers gather on host.
        state = {"prev_q": None, "prev_prec": 0.0, "prev_src": None,
                 "delta6_ok": wire in ("auto", "delta6"),
                 "delta_ok": wire in ("auto", "delta", "delta6"),
                 "q16_ok": wire in ("auto", "delta", "delta6", "q16")}

        def load(chunk) -> FrameBatch:
            # group by source (chunks can straddle file boundaries)
            srcs = self._src[chunk]
            uniq = np.unique(srcs)
            parts = []
            for si in uniq:
                ids = self._local[chunk[srcs == si]]
                if len(uniq) > 1:
                    # a chunk straddling files cannot be one coherent wire
                    # stream; ship it absolute and reset the delta chain
                    state["prev_q"] = None
                    parts.append(self.sources[int(si)].read_batch(
                        ids, stop_after=self._stop_after))
                else:
                    parts.append(self._read_part(int(si), ids, state))
            if len(parts) == 1:
                out = parts[0]
            else:
                out = FrameBatch(
                    positions=np.concatenate([p.positions for p in parts]),
                    boxes9=np.concatenate([p.boxes9 for p in parts]),
                    steps=np.concatenate([p.steps for p in parts]),
                    times=np.concatenate([p.times for p in parts]),
                    frame_numbers=np.concatenate([p.frame_numbers for p in parts]),
                    velocities=_cat_opt([p.velocities for p in parts]),
                    forces=_cat_opt([p.forces for p in parts]),
                    precisions=_cat_opt([p.precisions for p in parts]),
                    has_x=_cat_opt([p.has_x for p in parts]),
                    has_v=_cat_opt([p.has_v for p in parts]),
                    has_f=_cat_opt([p.has_f for p in parts]),
                )
            if self._sel is not None and out.atom_indices is None:
                self._gather_selection(out)
            return out

        return _PipelinedLoader(load, chunks,
                                deferred=deferred, prefetch=prefetch)

    def _read_part(self, si: int, ids: np.ndarray, state: dict) -> FrameBatch:
        """Read one source's frames in the smallest wire format allowed."""
        src = self.sources[si]
        compact = ((state["delta_ok"] or state["q16_ok"]) and src.kind == "xtc"
                   and getattr(src, "native_wire", False))
        if not compact:
            return src.read_batch(ids, stop_after=self._stop_after)
        if state["prev_src"] != si:
            # a different file is a new quantization stream: reset the chain
            state["prev_q"] = None
        stop = self._stop_after if self._stop_after is not None else src.natoms
        nout = len(self._sel) if self._sel is not None else stop
        if state["delta6_ok"]:
            try:
                (pk, sh, ei, ev, base_out, last, boxes, steps, times,
                 precs) = native.xtc_read_frames_delta6(
                    src.path, src.offsets[ids], src.natoms,
                    base=state["prev_q"], base_prec=state["prev_prec"],
                    stop_after=stop, sel=self._sel,
                )
                state["prev_q"], state["prev_prec"] = last, float(precs[0])
                state["prev_src"] = si
                ei, ev = _pad_escapes(ei, ev, nout)
                return FrameBatch(
                    positions=pk, boxes9=_xtc_box_to_gro9(boxes),
                    steps=steps.astype(np.int64), times=times,
                    frame_numbers=np.asarray(ids, np.int64),
                    precisions=precs, wire="delta6", wire_natoms=nout,
                    base_q=base_out, shifts=sh, esc_idx=ei, esc_val=ev,
                    atom_indices=self._sel,
                )
            except ReadTrajError as e:
                if e.code not in ("DeltaRange", "Q16Range"):
                    raise
                # dense motion: |delta| > 31 too often — drop to int8 tier
                state["delta6_ok"] = False
                state["prev_q"] = None
        if state["delta_ok"]:
            try:
                (d, sh, ei, ev, base_out, last, boxes, steps, times,
                 precs) = native.xtc_read_frames_delta(
                    src.path, src.offsets[ids], src.natoms,
                    base=state["prev_q"], base_prec=state["prev_prec"],
                    stop_after=stop, sel=self._sel,
                )
                state["prev_q"], state["prev_prec"] = last, float(precs[0])
                state["prev_src"] = si
                ei, ev = _pad_escapes(ei, ev, nout)
                return FrameBatch(
                    positions=d, boxes9=_xtc_box_to_gro9(boxes),
                    steps=steps.astype(np.int64), times=times,
                    frame_numbers=np.asarray(ids, np.int64),
                    precisions=precs, wire="delta", wire_natoms=nout,
                    base_q=base_out,
                    shifts=sh, esc_idx=ei, esc_val=ev,
                    atom_indices=self._sel,
                )
            except ReadTrajError as e:
                if e.code not in ("DeltaRange", "Q16Range"):
                    raise
                # hysteresis: dense motion (frames far apart in time) will
                # recur every chunk — stop paying the doomed decode
                state["delta_ok"] = False
        if state["q16_ok"]:
            try:
                q, boxes, steps, times, precs = native.xtc_read_frames_q16(
                    src.path, src.offsets[ids], src.natoms, stop_after=stop
                )
                state["prev_q"] = q[-1].astype(np.int32)
                state["prev_prec"] = float(precs[0]) if len(precs) else 0.0
                state["prev_src"] = si
                return FrameBatch(
                    positions=q, boxes9=_xtc_box_to_gro9(boxes),
                    steps=steps.astype(np.int64), times=times,
                    frame_numbers=np.asarray(ids, np.int64),
                    precisions=precs, wire="q16",
                )
            except ReadTrajError as e:
                if e.code != "Q16Range":
                    raise
                state["q16_ok"] = False
        state["prev_q"] = None
        return src.read_batch(ids, stop_after=self._stop_after)

    def _gather_selection(self, out: FrameBatch) -> None:
        """Compact a decoded batch to the atom selection (all wires).

        Contiguous selections (sorted-unique by construction) use a basic
        slice instead of a fancy-index gather; a prefix selection that
        already equals the decoded width (stop_after == len(sel)) is a
        pure relabel — no copy at all.  The common case: analysis atoms
        laid out as a file prefix, where the old gather copied the whole
        batch to itself."""
        sel = self._sel
        n = len(sel)
        contig = n > 0 and int(sel[-1]) - int(sel[0]) == n - 1
        if contig and int(sel[0]) == 0 and out.positions.shape[1] == n:
            ix = None  # identity: decode already stopped at the selection
        elif contig:
            ix = slice(int(sel[0]), int(sel[0]) + n)
        else:
            ix = sel
        if ix is not None:
            out.positions = out.positions[:, ix, :]
            if out.velocities is not None:
                out.velocities = out.velocities[:, ix, :]
            if out.forces is not None:
                out.forces = out.forces[:, ix, :]
            if out.base_q is not None:
                out.base_q = out.base_q[ix]
        if out.esc_idx is not None and out.esc_idx.size:
            # escapes are indexed in decode space [0, stop]: drop atoms
            # outside the selection, remap the rest; index len(sel) is the
            # scatter-drop sentinel
            stop = int(self._stop_after)
            lut = np.full(stop + 1, len(sel), np.int32)
            lut[sel] = np.arange(len(sel), dtype=np.int32)
            out.esc_idx = lut[out.esc_idx]
        out.atom_indices = sel

    # ------------------------------------------------------------- analyzers
    def calc_rmsd(self, reference, group: str) -> "RMSDTrajIterator":
        """Per-frame RMSD vs a reference (reference: rmsd.rs:258)."""
        return RMSDTrajIterator(self, reference, group, fit=False)

    def calc_rmsd_and_fit(self, reference, group: str) -> "RMSDTrajIterator":
        """Per-frame RMSD + fit every frame onto the reference
        (reference: rmsd.rs:286)."""
        return RMSDTrajIterator(self, reference, group, fit=True)

    # ------------------------------------------------------------- per-frame iteration
    def __iter__(self):
        frame_counter = 0
        try:
            for batch in self.batches():
                for k in range(len(batch)):
                    self._update_system(batch, k)
                    if self.progress is not None:
                        self.progress.print(
                            frame_counter, self.system.get_step(), self.system.get_time()
                        )
                    frame_counter += 1
                    yield self.system
        except Exception:
            if self.progress is not None:
                self.progress.set_status(ProgressStatus.FAILED)
                self.progress.print(0, self.system.get_step(), self.system.get_time())
            raise
        if self.progress is not None:
            self.progress.set_status(ProgressStatus.COMPLETED)
            self.progress.print(0, self.system.get_step(), self.system.get_time())

    def _update_system(self, batch: FrameBatch, k: int):
        """Write one frame into the System (reference:
        XtcFrameData::update_system, molly_xtc.rs:292-306)."""
        s = self.system
        sel = batch.atom_indices
        if sel is not None and self._sel_slice is not None:
            sel = self._sel_slice  # contiguous selection: slice, not scatter
        has_x = batch.has_x is None or bool(batch.has_x[k])
        has_v = batch.velocities is not None and (batch.has_v is None or bool(batch.has_v[k]))
        has_f = batch.forces is not None and (batch.has_f is None or bool(batch.has_f[k]))

        if sel is None:
            if has_x:
                s.positions[:] = batch.positions[k]
                s.has_position[:] = True
            else:
                s.has_position[:] = False
            if has_v:
                s.velocities[:] = batch.velocities[k]
                if batch.vel_mask is not None:
                    s.has_velocity[:] = batch.vel_mask[k]
                else:
                    s.has_velocity[:] = True
            else:
                s.has_velocity[:] = False
            if has_f:
                s.forces[:] = batch.forces[k]
                s.has_force[:] = True
            else:
                s.has_force[:] = False
        else:
            if has_x:
                s.positions[sel] = batch.positions[k]
                s.has_position[sel] = True
            else:
                s.has_position[sel] = False
            if has_v:
                s.velocities[sel] = batch.velocities[k]
                s.has_velocity[sel] = True
            else:
                s.has_velocity[sel] = False
            s.has_force[sel] = False

        b9 = batch.boxes9[k]
        s.set_box(SimBox.from_gro_line(b9) if np.any(b9 != 0.0) else None)
        s.set_step(int(batch.steps[k]))
        s.set_time(float(batch.times[k]))
        if batch.precisions is not None and batch.precisions[k] > 0:
            s.set_precision(int(batch.precisions[k]))


class _PipelinedLoader:
    """Single-worker chunk loader with an explicit decode-release handshake.

    Chunks MUST decode sequentially (the delta wire chains through the
    previous chunk's last frame), so there is exactly one worker thread.
    Eager mode starts the next decode as soon as a batch is handed out;
    deferred mode waits for `release()` (or the next `__next__` as a
    fallback) so the consumer can schedule host-CPU-hungry work (device
    transfer) while the decoder is idle.
    """

    def __init__(self, load, chunks, deferred: bool = False, prefetch: bool = True):
        self._load = load
        self._chunks = list(chunks)
        self._deferred = deferred
        self._prefetch = prefetch
        self._i = 0
        self._thread = None
        self._result = {}
        if self._prefetch and self._chunks:
            self._start(0)

    def __len__(self) -> int:
        return len(self._chunks)

    def _start(self, i: int) -> None:
        def work():
            try:
                self._result[i] = self._load(self._chunks[i])
            except BaseException as e:  # re-raised on the consumer side
                self._result[i] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._thread = (i, t)

    def release(self) -> None:
        """Start decoding the next chunk (no-op if already running/done)."""
        if self._thread is None and self._i < len(self._chunks):
            self._start(self._i)

    def __iter__(self):
        return self

    def __next__(self) -> FrameBatch:
        i = self._i
        if i >= len(self._chunks):
            raise StopIteration
        if not self._prefetch:
            self._i = i + 1
            return self._load(self._chunks[i])
        if self._thread is None:
            self._start(i)
        ti, t = self._thread
        assert ti == i, "loader consumed out of order"
        t.join()
        self._thread = None
        out = self._result.pop(i)
        self._i = i + 1
        if isinstance(out, BaseException):
            raise out
        if not self._deferred and self._i < len(self._chunks):
            self._start(self._i)
        return out


class RMSDTrajIterator:
    """Batched trajectory RMSD (reference: RMSDTrajRead, rmsd.rs:258).

    Iterates (system, rmsd) per frame; RMSD evaluates on device over whole
    frame batches (one jitted kabsch per batch instead of the reference's
    per-frame SVD), optionally RMSD-fitting each frame
    (`calc_rmsd_and_fit`, rmsd.rs:286).
    """

    def __init__(self, reader: "TrajReader", reference, group: str, fit: bool = False):
        import jax

        from ..system.rmsd import _extract, _masses

        self.reader = reader
        self.fit = fit
        if reader._sel is not None:
            from ..errors import RMSDError

            raise RMSDError(
                "trajectory RMSD requires full-frame reading", code="PartialRead"
            )
        ref_coords, ref_center, ref_idx = _extract(reference, group)
        self._w = _masses(reference, group, ref_idx)
        self._ref = ref_coords
        self._ref_center = ref_center
        self._idx = reader.system.group_indices(group)
        if self._idx.shape[0] != ref_idx.shape[0]:
            from ..errors import RMSDError

            raise RMSDError(
                f"group '{group}' atom count differs between reference and system",
                code="InconsistentGroup",
            )
        self._ref_group_com = np.asarray(reference.group_get_com(group), np.float32)

        from ..ops import rmsd as rmsd_ops

        idx = self._idx

        def batch_rmsd(positions, boxes):
            import jax.numpy as jnp

            g = jnp.take(positions, jnp.asarray(idx), axis=1)
            rot, rms = rmsd_ops.rmsd_frames(
                jnp.asarray(self._ref), jnp.asarray(self._ref_center), g, boxes,
                jnp.asarray(self._w),
            )
            return rot, rms

        self._batch_rmsd = jax.jit(batch_rmsd)

    def __iter__(self):
        import jax.numpy as jnp

        from ..ops import rmsd as rmsd_ops

        reader = self.reader
        frame_counter = 0
        for batch in reader.batches():
            rots, rmss = self._batch_rmsd(
                jnp.asarray(batch.positions), jnp.asarray(batch.box_lengths())
            )
            rots = np.asarray(rots)
            rmss = np.asarray(rmss)
            for k in range(len(batch)):
                reader._update_system(batch, k)
                system = reader.system
                if self.fit:
                    from ..ops import center as center_ops

                    box = system.box_lengths()
                    com = np.asarray(
                        center_ops.center(
                            system.positions[self._idx], box,
                            weights=system.topology.mass[self._idx],
                        )
                    )
                    # np.array (not asarray): views of jax buffers are
                    # read-only and the next frame writes in place
                    system.positions = np.array(
                        rmsd_ops.fit_transform(
                            system.positions, box, com, rots[k], self._ref_group_com
                        ),
                        dtype=np.float32,
                    )
                if reader.progress is not None:
                    reader.progress.print(frame_counter, system.get_step(), system.get_time())
                frame_counter += 1
                yield system, float(rmss[k])


def _cat_opt(parts):
    if any(p is None for p in parts):
        return None
    return np.concatenate(parts)


# =====================================================================
# Entry points (System methods delegate here)
# =====================================================================

def traj_iter(system, filename, fmt: str | None = None, group: str | None = None,
              start_time: float | None = None, end_time: float | None = None,
              step: int | None = None, batch_size: int = 64,
              indices=None) -> TrajReader:
    reader = TrajReader(system, [open_source(filename, fmt)], group=group,
                        batch_size=batch_size, indices=indices)
    if start_time is not None or end_time is not None:
        reader = reader.with_range(
            0.0 if start_time is None else start_time,
            float("inf") if end_time is None else end_time,
        )
    if step is not None:
        reader = reader.with_step(step)
    return reader


def xtc_iter(system, filename, **kw) -> TrajReader:
    if FileType.from_name(filename) is not FileType.XTC:
        raise ReadTrajError(f"'{filename}' is not an xtc file", code="NotXtc")
    return traj_iter(system, filename, fmt="xtc", **kw)


def trr_iter(system, filename, **kw) -> TrajReader:
    if FileType.from_name(filename) is not FileType.TRR:
        raise ReadTrajError(f"'{filename}' is not a trr file", code="NotTrr")
    return traj_iter(system, filename, fmt="trr", **kw)


def gro_iter(system, filename, **kw) -> TrajReader:
    return traj_iter(system, filename, fmt="gro", **kw)


def tng_iter(system, filename, **kw) -> TrajReader:
    """Iterate a TNG trajectory (reference behavior: ChemfilesReader over
    TNG, src/io/chemfiles.rs:25-41; here via the native container parser,
    io/tng.py)."""
    return traj_iter(system, filename, fmt="tng", **kw)


def cat_iter(system, filenames, fmt: str | None = None, group: str | None = None,
             **kw) -> TrajReader:
    """Concatenated iteration with boundary dedup (reference: traj_cat.rs)."""
    if not filenames:
        raise ReadTrajError("no trajectory files provided", code="NoTrajectories")
    sources = [open_source(f, fmt) for f in filenames]
    reader = TrajReader(system, sources, group=group,
                        batch_size=kw.pop("batch_size", 64),
                        indices=kw.pop("indices", None))
    start_time, end_time, step = kw.pop("start_time", None), kw.pop("end_time", None), kw.pop("step", None)
    if start_time is not None or end_time is not None:
        reader = reader.with_range(
            0.0 if start_time is None else start_time,
            float("inf") if end_time is None else end_time,
        )
    if step is not None:
        reader = reader.with_step(step)
    return reader


# =====================================================================
# Trajectory writers
# =====================================================================

class TrajWriter:
    """Base frame writer (reference: traj_write.rs:451 sealed trait)."""

    def __init__(self, system, path, group: str = "all"):
        if not system.group_exists(group):
            raise WriteTrajError(f"group '{group}' does not exist", code="GroupNotFound")
        self.system = system
        self.path = str(path)
        self.group = group
        # snapshot indices at init (reference writers capture the group)
        self.indices = system.group_indices(group)
        if os.path.exists(self.path):
            os.remove(self.path)

    def write_frame(self):
        raise NotImplementedError

    def close(self):
        pass


class XtcWriter(TrajWriter):
    def write_frame(self):
        s = self.system
        box = s.get_box()
        box33 = box.to_matrix() if box is not None else np.zeros((3, 3), np.float32)
        pos = s.positions[self.indices]
        native.xtc_write_frame(
            self.path, len(self.indices), s.get_step(), s.get_time(),
            box33.reshape(9), pos, float(s.get_precision()),
        )


class TrrWriter(TrajWriter):
    def write_frame(self):
        s = self.system
        box = s.get_box()
        box33 = box.to_matrix().reshape(9) if box is not None else None
        idx = self.indices
        # the reference ALWAYS writes x, v and f blocks, substituting zeros
        # for atoms that lack the vector (trr_io.rs:483-506)
        x = np.where(s.has_position[idx, None], s.positions[idx], 0.0)
        v = np.where(s.has_velocity[idx, None], s.velocities[idx], 0.0)
        f = np.where(s.has_force[idx, None], s.forces[idx], 0.0)
        native.trr_write_frame(
            self.path, len(idx), s.get_step(), s.get_time(), s.get_lambda(), box33,
            x=x, v=v, f=f,
        )


class GroTrajWriter(TrajWriter):
    def __init__(self, system, path, group: str = "all",
                 write_velocities: bool | None = None):
        super().__init__(system, path, group)
        # None = reference behavior: write velocities per frame iff the
        # whole system has them (gro_io/trajectory.rs:545 passes
        # system.has_velocities()); an explicit bool overrides.
        self.write_velocities = write_velocities

    def write_frame(self):
        from .gro import write_gro_frame

        wv = (self.system.has_velocities() if self.write_velocities is None
              else self.write_velocities)
        with open(self.path, "a") as fh:
            write_gro_frame(self.system, fh, self.group, wv, is_trajectory=True)


class TngTrajWriter(TrajWriter):
    """TNG writer — surpass feature, the reference cannot write TNG
    (chemfiles is read-only there, src/io/chemfiles.rs).  ``codec`` picks
    the POSITIONS payload: ``"gzip"`` (lossless) or ``"tng"`` (the
    GROMACS-native codec-2 XTC2 coder at ``multiplier`` ints/nm)."""

    def __init__(self, system, path, group: str = "all",
                 codec: str = "gzip", multiplier: float = 1000.0):
        super().__init__(system, path, group)
        from .tng import TngFrameWriter

        self._w = TngFrameWriter(self.path, len(self.indices),
                                 codec=codec, multiplier=multiplier)

    def write_frame(self):
        s = self.system
        box = s.get_box()
        box33 = box.to_matrix() if box is not None else None
        idx = self.indices
        v = s.velocities[idx] if s.has_velocity[idx].all() else None
        f = s.forces[idx] if s.has_force[idx].all() else None
        self._w.write_frame(s.positions[idx], box33, s.get_step(), s.get_time(),
                            velocities=v, forces=f, lam=s.get_lambda())

    def close(self):
        self._w.close()


class XyzTrajWriter(TrajWriter):
    """Extended-XYZ writer — surpass feature, the reference reads XYZ via
    chemfiles but cannot write it (src/io/chemfiles.rs is read-only).
    Emits ``Lattice=`` (when the system has a box), ``Properties=`` and
    ``Time=`` extxyz metadata so `XyzSource` round-trips box and time;
    coordinates in Angstrom.  Species come from the topology's element
    symbols where guessed, the atom name otherwise."""

    def __init__(self, system, path, group: str = "all"):
        super().__init__(system, path, group)
        topo = system.topology
        sym = topo.element_symbol.values()[self.indices]
        names = topo.atomname.values()[self.indices]
        self._species = np.where(sym == "", names, sym)

    def write_frame(self):
        s = self.system
        idx = self.indices
        pos = np.asarray(s.positions[idx], np.float64) * 10.0
        box = s.get_box()
        comment = f"Properties=species:S:1:pos:R:3 Time={float(s.get_time()):g}"
        if box is not None:
            h = np.asarray(box.to_matrix(), np.float64) * 10.0
            lat = " ".join(f"{v:.6f}" for v in h.reshape(9))
            comment = f'Lattice="{lat}" ' + comment
        lines = [str(len(idx)), comment]
        lines.extend(
            f"{sp} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            for sp, p in zip(self._species, pos)
        )
        with open(self.path, "a") as fh:
            fh.write("\n".join(lines) + "\n")


def make_writer(system, path, group: str = "all", fmt: str | None = None, **kw) -> TrajWriter:
    if fmt is None:
        fmt = FileType.from_name(path).value
    if fmt == "xtc":
        return XtcWriter(system, path, group)
    if fmt == "trr":
        return TrrWriter(system, path, group)
    if fmt == "gro":
        return GroTrajWriter(system, path, group, **kw)
    if fmt == "tng":
        return TngTrajWriter(system, path, group, **kw)
    if fmt == "xyz":
        return XyzTrajWriter(system, path, group)
    raise WriteTrajError(f"unsupported trajectory format '{fmt}'", code="UnknownFormat")
