"""Host-side path for interactive per-call System analysis.

The reference's per-call methods (``System::group_get_center`` etc.,
`src/system/analysis.rs:105`) are microseconds of CPU math on one frame
of host-resident data.  This module runs the SAME jnp kernels on the
local CPU backend, jit-compiled with power-of-two padding so the compile
cache stays small, so that such a call needs no transfer to or dispatch
on the accelerator.

The batched trajectory path (`parallel/`, `models/`) never comes through
here — it runs on the default device.  Set
``GROAN_INTERACTIVE_DEVICE=default`` to dispatch interactive calls to the
default jax device instead.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

__all__ = [
    "host_enabled",
    "host",
    "estimate_center",
    "center",
    "center_naive",
    "center_triclinic",
    "distance",
    "distance_triclinic",
    "distance_matrix",
]

_cpu_dev = None
_cpu_checked = False


def _cpu():
    global _cpu_dev, _cpu_checked
    if not _cpu_checked:
        _cpu_checked = True
        try:
            import jax

            _cpu_dev = jax.local_devices(backend="cpu")[0]
        except Exception:  # no CPU backend in this build: fall through
            _cpu_dev = None
    return _cpu_dev


def host_enabled() -> bool:
    return (os.environ.get("GROAN_INTERACTIVE_DEVICE", "cpu") == "cpu"
            and _cpu() is not None)


def host():
    """Context manager placing eager jnp ops on the local CPU backend.

    For interactive call sites that don't warrant a jit cache (System
    mutation methods, one-off fits).  No-op when the host path is
    disabled."""
    if host_enabled():
        import jax

        return jax.default_device(_cpu())
    from contextlib import nullcontext

    return nullcontext()


_JITS: dict = {}


def _jitted(key, make):
    fn = _JITS.get(key)
    if fn is None:
        import jax

        fn = _JITS[key] = jax.jit(make())
    return fn


def _run(key, make, *args):
    """Run `make()`'s function jitted on the CPU device (or eagerly on the
    default device when the host path is disabled)."""
    import jax

    if host_enabled():
        with jax.default_device(_cpu()):
            return np.asarray(_jitted(key, make)(*args))
    return np.asarray(make()(*args))


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _pad_rows(a: np.ndarray, p: int) -> np.ndarray:
    a = np.asarray(a)
    if a.shape[0] == p:
        return a
    out = np.zeros((p,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _mask(n: int, p: int) -> np.ndarray:
    m = np.zeros(p, dtype=bool)
    m[:n] = True
    return m


# ------------------------------------------------------------------ centers
def _center_args(pos, weights):
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    n = pos.shape[0]
    p = _pow2(n)
    padded = _pad_rows(pos, p)
    m = _mask(n, p)
    w = None if weights is None else _pad_rows(
        np.ascontiguousarray(weights, dtype=np.float32), p)
    return padded, m, w


def estimate_center(pos, box, weights=None):
    from . import center as C

    pos, m, w = _center_args(pos, weights)
    box = np.asarray(box, np.float32)
    if w is None:
        return _run(("est", False),
                    lambda: lambda p, b, mk: C.estimate_center(p, b, mask=mk),
                    pos, box, m)
    return _run(("est", True),
                lambda: lambda p, b, mk, ww: C.estimate_center(
                    p, b, mask=mk, weights=ww),
                pos, box, m, w)


def center(pos, box, weights=None):
    from . import center as C

    pos, m, w = _center_args(pos, weights)
    box = np.asarray(box, np.float32)
    if w is None:
        return _run(("ctr", False),
                    lambda: lambda p, b, mk: C.center(p, b, mask=mk),
                    pos, box, m)
    return _run(("ctr", True),
                lambda: lambda p, b, mk, ww: C.center(p, b, mask=mk, weights=ww),
                pos, box, m, w)


def center_naive(pos, weights=None):
    from . import center as C

    pos, m, w = _center_args(pos, weights)
    if w is None:
        return _run(("nav", False),
                    lambda: lambda p, mk: C.center_naive(p, mask=mk), pos, m)
    return _run(("nav", True),
                lambda: lambda p, mk, ww: C.center_naive(p, mask=mk, weights=ww),
                pos, m, w)


def center_triclinic(pos, box_matrix, weights=None):
    from . import center as C

    pos, m, w = _center_args(pos, weights)
    h = np.asarray(box_matrix, np.float32)
    if w is None:
        return _run(("tri", False),
                    lambda: lambda p, hh, mk: C.center_triclinic(p, hh, mask=mk),
                    pos, h, m)
    return _run(("tri", True),
                lambda: lambda p, hh, mk, ww: C.center_triclinic(
                    p, hh, mask=mk, weights=ww),
                pos, h, m, w)


# ---------------------------------------------------------------- distances
def distance(a, b, box, dim_mask=(True, True, True)):
    from . import pbc

    dm = tuple(bool(v) for v in dim_mask)
    return _run(("dst", dm),
                lambda: partial(pbc.distance, dim_mask=dm),
                np.asarray(a, np.float32), np.asarray(b, np.float32),
                np.asarray(box, np.float32))


def distance_triclinic(a, b, box_matrix):
    from . import pbc

    return _run(("dtt",), lambda: pbc.distance_triclinic,
                np.asarray(a, np.float32), np.asarray(b, np.float32),
                np.asarray(box_matrix, np.float32))


def distance_matrix(a, b, box, dim_mask=(True, True, True)):
    from . import distances as D

    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    n, mm = a.shape[0], b.shape[0]
    pa, pb = _pow2(n), _pow2(mm)
    dm = tuple(bool(v) for v in dim_mask)
    out = _run(("dmx", dm),
               lambda: partial(D.distance_matrix, dim_mask=dm),
               _pad_rows(a, pa), _pad_rows(b, pb),
               np.asarray(box, np.float32))
    return out[:n, :mm]
