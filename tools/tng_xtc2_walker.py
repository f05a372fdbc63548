#!/usr/bin/env python
"""Reverse-engineering harness for the TNG tng_compress XTC2 coding.

Reconstructs the known-plaintext skeleton of a codec-2 POSITIONS payload
(initial_coding=5) and walks the bitstream labeling large atoms, small
runs and the instruction gaps between them.  See
docs/tng_compress_notes.md for the cracked layers and the open
instruction-grammar question this tool exists to answer.

Usage (CPU only):
    env JAX_PLATFORMS=cpu \
        python tools/tng_xtc2_walker.py <file.tng> <file.xtc> [frame]

The XTC file must be the same trajectory (the fixtures were written by
`gmx trjconv` from XTC at 10x coarser precision, so quantized ints match
exactly 10:1).
"""

import json
import math
import struct
import sys

import numpy as np

MAGIC = [0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50,
         64, 80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024,
         1290, 1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321,
         13003, 16384, 20642, 26007, 32768, 41285, 52015, 65536]


def unzig(u):
    """tng zigzag: v>0 -> 2v-1, v<=0 -> -2v."""
    return (u + 1) // 2 if u % 2 else -(u // 2)


class Walker:
    def __init__(self, payload: bytes, q: np.ndarray):
        """payload: codec-2 stream AFTER the 40-byte TNGP header.
        q: exact quantized ints [natoms, 3] for this frame."""
        self.bits = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.int64)
        self.q = q.astype(np.int64)
        self.minint = struct.unpack("<3i", payload[:12])
        self.BL = [MAGIC[payload[12] + 4], MAGIC[payload[13] + 4],
                   MAGIC[payload[14] + 4]]
        self.WL = math.ceil(math.log2(self.BL[0] * self.BL[1] * self.BL[2]))
        self.L2 = {i: math.log2(MAGIC[i]) for i in range(12, 46)}

    def rd_send(self, off, n):
        """xdrfile sendints bit layout: LSB bytes first (each byte
        MSB-first), then the remainder bits MSB-first."""
        bits = self.bits
        v = 0
        nb = n // 8
        for k in range(nb):
            byte = 0
            for i in range(8):
                byte = (byte << 1) | int(bits[off + 8 * k + i])
            v |= byte << (8 * k)
        rem = n - 8 * nb
        if rem:
            top = 0
            for i in range(rem):
                top = (top << 1) | int(bits[off + 8 * nb + i])
            v |= top << (8 * nb)
        return v

    def try_large(self, off, a):
        """Absolute mixed-radix triple at the header bases."""
        if off + self.WL > len(self.bits) or a >= len(self.q):
            return False
        v = self.rd_send(off, self.WL)
        z = v % self.BL[2]; r = v // self.BL[2]
        y = r % self.BL[1]; x = r // self.BL[1]
        return [x + self.minint[0], y + self.minint[1],
                z + self.minint[2]] == self.q[a].tolist()

    def try_run(self, off, a, idx, K):
        """K small atoms as ONE sendints integer: 3K zigzag intra deltas
        at base magicints[idx]; returns the bit width or None."""
        B = MAGIC[idx]
        W = math.ceil(3 * K * self.L2[idx])
        if off + W > len(self.bits) or a + K > len(self.q):
            return None
        v = self.rd_send(off, W)
        ts = [0] * (3 * K)
        for i in range(3 * K - 1, -1, -1):
            ts[i] = v % B
            v //= B
        if v:
            return None
        prev = self.q[a - 1]
        for k in range(K):
            nxt = (prev[0] + unzig(ts[3 * k]), prev[1] + unzig(ts[3 * k + 1]),
                   prev[2] + unzig(ts[3 * k + 2]))
            qa = self.q[a + k]
            if nxt[0] != qa[0] or nxt[1] != qa[1] or nxt[2] != qa[2]:
                return None
            prev = np.array(nxt)
        return W

    def max_run(self, off, a, idx, cap=64):
        best = None
        K = 1
        while K <= cap:
            w = self.try_run(off, a, idx, K)
            if w is not None:
                best = (K, w)
            elif best is not None and K > best[0] + 4:
                break
            K += 1
        return best

    def walk(self, start_bit=147, max_gap=72):
        """Greedy labeled walk; returns (atoms_decoded, transitions)."""
        pos, a = start_bit, 0
        cur = None
        trans = []
        while a < len(self.q):
            if self.try_large(pos, a):
                pos += self.WL
                a += 1
                continue
            if cur is not None:
                mr = self.max_run(pos, a, cur)
                if mr:
                    K, w = mr
                    pos += w
                    a += K
                    continue
            best = None
            for off in range(pos, min(pos + max_gap, len(self.bits))):
                if self.try_large(off, a):
                    best = (off, "L", None)
                    break
                hit = None
                for idx in range(16, 44):
                    mr = self.max_run(off, a, idx)
                    if mr:
                        hit = (idx,) + mr
                        break
                if hit:
                    best = (off, "R", hit)
                    break
            if best is None:
                print(f"DEAD at atom {a} bit {pos}")
                ctx = "".join(str(int(x)) for x in self.bits[pos:pos + 80])
                print(f"  ctx: {ctx}")
                break
            off, kind, hit = best
            gap = "".join(str(int(x)) for x in self.bits[pos:off])
            if kind == "L":
                trans.append((gap, cur, "L", a, pos))
                pos = off + self.WL
                a += 1
            else:
                idx, K, w = hit
                trans.append((gap, cur, f"R{idx},K{K}", a, pos))
                cur = idx
                pos = off + w
                a += K
        return a, trans


def main():
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    ".."))
    from groan_rs_tpu.io import native, tng

    tng_path, xtc_path = sys.argv[1], sys.argv[2]
    frame = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    data = open(tng_path, "rb").read()
    endian, blocks = tng._scan_blocks(data, tng_path)
    pbs = [tng._parse_data_block(data, b, endian)
           for b in blocks if b.name == "POSITIONS"]
    off, _, _, n = native.xtc_scan(xtc_path)
    c, *_ = native.xtc_read_frames(xtc_path, off, n)
    # TNG multiplier is 1000 on the fixtures; XTC is 100 -> ints are 10:1
    q = np.round(np.asarray(c[frame], np.float64) * 1000).astype(np.int64)
    w = Walker(pbs[frame].payload[40:], q)
    a, trans = w.walk()
    print(f"decoded {a}/{len(q)} atoms, {len(trans)} labeled transitions")
    for g, p, nn, aa, pp in trans[:60]:
        print(f"  gap='{g or '(none)'}' prev={p} new={nn} atom={aa} bit={pp}")
    json.dump(trans, open("/tmp/tng_xtc2_trans.json", "w"))


if __name__ == "__main__":
    main()
