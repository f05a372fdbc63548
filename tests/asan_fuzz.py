"""One-shot AddressSanitizer run of the native-codec fuzz corpus.

Not part of the pytest suite (ASan needs a dedicated build + preload).
Run manually:

    python tests/asan_fuzz.py

It compiles `io/native/xdrcodec.cpp` with `-fsanitize=address`, re-execs
itself with the ASan runtime preloaded, and replays the threaded fuzz
corpus of `test_fuzz_robustness.py` (corrupted payload bytes, truncated
mid-run payloads, q16/delta wires, n_threads=4).  Any OOB read/write or
use-after-free aborts the process with an ASan report; a clean exit
prints OK.  (Reference analogue: the fake_*/truncated fixture corpus +
Rust's memory safety, SURVEY §5.)
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "groan_rs_tpu", "io", "native", "xdrcodec.cpp")
FIXTURE = "/root/reference/test_files/short_trajectory.xtc"


def build_asan_lib(tmp: str) -> str:
    so = os.path.join(tmp, "libgroanxdr-asan.so")
    subprocess.run(
        ["g++", "-O1", "-g", "-shared", "-fPIC", "-std=c++17",
         "-fsanitize=address", "-fno-omit-frame-pointer", "-pthread",
         SRC, "-o", so],
        check=True,
    )
    return so


def asan_runtime() -> str:
    out = subprocess.run(
        ["g++", "-print-file-name=libasan.so"], check=True,
        capture_output=True, text=True,
    ).stdout.strip()
    return out


def main() -> None:
    if os.environ.get("_GROAN_ASAN_CHILD") != "1":
        tmp = tempfile.mkdtemp(prefix="groan_asan_")
        so = build_asan_lib(tmp)
        env = dict(os.environ)
        env["_GROAN_ASAN_CHILD"] = "1"
        env["GROAN_NATIVE_LIB"] = so
        env["LD_PRELOAD"] = asan_runtime()
        # leaks from the Python interpreter itself are not interesting
        env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
        env["JAX_PLATFORMS"] = "cpu"
        rc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                            env=env).returncode
        sys.exit(rc)

    sys.path.insert(0, REPO)
    import types

    import numpy as np

    # import native.py WITHOUT executing groan_rs_tpu/__init__.py (which
    # pulls jax/jaxlib — their MLIR bindings throw C++ exceptions that
    # ASan's interceptors cannot unwind through)
    pkg = types.ModuleType("groan_rs_tpu")
    pkg.__path__ = [os.path.join(REPO, "groan_rs_tpu")]
    sys.modules["groan_rs_tpu"] = pkg
    iopkg = types.ModuleType("groan_rs_tpu.io")
    iopkg.__path__ = [os.path.join(REPO, "groan_rs_tpu", "io")]
    sys.modules["groan_rs_tpu.io"] = iopkg
    import groan_rs_tpu.io.native as native
    from groan_rs_tpu.errors import GroanError

    data = bytearray(open(FIXTURE, "rb").read())
    offs, _, _, na = native.xtc_scan(FIXTURE)
    ends = list(offs[1:]) + [len(data)]
    ranges = list(zip(offs, ends))
    rng = np.random.default_rng(123)
    tmpdir = tempfile.mkdtemp(prefix="groan_asan_corpus_")
    n_typed = n_ok = 0
    for trial in range(60):
        corrupted = bytearray(data)
        for k in rng.choice(len(ranges), size=2, replace=False):
            s, e = ranges[int(k)]
            for _ in range(6):
                j = int(rng.integers(s + 100, e))
                corrupted[j] ^= int(rng.integers(1, 256))
        cut = len(data) if trial % 3 else int(rng.integers(100, len(data)))
        p = os.path.join(tmpdir, "fuzz.xtc")
        with open(p, "wb") as fh:
            fh.write(bytes(corrupted[:cut]))
        for read in (
            lambda o, n: native.xtc_read_frames(p, o, n, n_threads=4),
            lambda o, n: native.xtc_read_frames_q16(p, o, n, n_threads=4),
            lambda o, n: native.xtc_read_frames_delta(p, o, n),
            lambda o, n: native.xtc_read_frames_delta6(p, o, n),
            lambda o, n: native.xtc_read_frames_delta6(
                p, o, n, sel=np.arange(0, n, 7)),
            # contiguous selections take the flat vectorized pack path
            lambda o, n: native.xtc_read_frames_delta6(
                p, o, n, sel=np.arange(n // 3, n - n // 3)),
            lambda o, n: native.xtc_read_frames_delta(
                p, o, n, sel=np.arange(n // 3, n - n // 3)),
        ):
            try:
                o, _, _, n = native.xtc_scan(p)
                if len(o):
                    read(o, n)
                n_ok += 1
            except GroanError:
                n_typed += 1
    # successful delta packs: a smooth synthetic trajectory (plus a few
    # teleporting atoms) runs the flat fast path to completion with
    # escapes firing, on full / contiguous / scattered selections
    sp = os.path.join(tmpdir, "smooth.xtc")
    na2, box9 = 5000, np.diag([8.0] * 3).astype(np.float32).reshape(9)
    pos = rng.uniform(0, 8.0, size=(na2, 3)).astype(np.float32)
    for f in range(6):
        if f:
            pos = (pos + rng.normal(size=pos.shape).astype(np.float32)
                   * 0.004) % 8.0
            jump = rng.choice(na2, size=9, replace=False)
            pos[jump] = rng.uniform(0, 8.0, size=(9, 3)).astype(np.float32)
        native.xtc_write_frame(sp, na2, f, f * 1.0, box9, pos, 1000.0)
    o2, _, _, _ = native.xtc_scan(sp)
    for sel in (None, np.arange(1000, 4000), np.arange(0, na2, 3)):
        for read2 in (native.xtc_read_frames_delta6,
                      native.xtc_read_frames_delta):
            read2(sp, o2, na2, sel=sel, n_threads=4)
            n_ok += 1

    # the XTC2 encoder on adversarial walks (+ decode of its own output,
    # and decode of bit-flipped encoder output)
    for trial in range(40):
        n = int(rng.integers(1, 3000))
        w = np.cumsum(rng.integers(-60, 61, size=(n, 3)), axis=0)
        if n > 16:
            stride = int(rng.integers(5, 50))
            w[::stride] += rng.integers(-400000, 400000,
                                        size=(w[::stride].shape[0], 3))
        enc = native.tng_xtc2_encode(w.astype(np.int64))
        q = native.tng_xtc2_decode(enc, n)
        assert (q.astype(np.int64) == w).all()
        bad = bytearray(enc)
        for _ in range(4):
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            native.tng_xtc2_decode(bytes(bad), n)
            n_ok += 1
        except GroanError:
            n_typed += 1

    # the hbond candidate walk on valid + degenerate inputs
    pos, box9, *_ = (native.xtc_read_frames(FIXTURE, offs[:1], na))
    box = box9[0][[0, 4, 8]]
    acc = rng.choice(na, size=4000, replace=False).astype(np.int32)
    don = rng.choice(na, size=3000, replace=False).astype(np.int32)
    native.hbond_candidates(pos[0], box, np.sort(acc), np.sort(don), 0.3)
    native.hbond_candidates(pos[0], box, np.sort(acc)[:1], np.sort(don)[:1],
                            5.0)  # one cell per axis
    print(f"ASAN FUZZ OK: {n_ok} clean decodes, {n_typed} typed errors, "
          "no sanitizer reports")


if __name__ == "__main__":
    main()
