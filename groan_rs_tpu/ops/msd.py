"""Mean-squared displacement on device (surpass feature).

The reference has no MSD analysis; this is the classic `gmx msd`
observable computed on device from a device-resident trajectory:

  1. unwrap: consecutive-frame displacements taken through the minimum
     image (orthorhombic boxes; frame-to-frame motion is assumed smaller
     than half a box vector — the same sampling assumption `gmx msd`
     makes), then an (associative, parallel) cumulative sum rebuilds
     continuous paths.
  2. MSD(tau) = mean over time origins t and atoms of
     |u(t+tau) - u(t)|^2, evaluated for every requested lag inside ONE
     jitted `lax.map` (differences first — no large-sum cancellation,
     unlike the FFT S1/S2 decomposition, which is why the direct form is
     used; each lag is O(F*K) so the full all-lag sweep is O(F^2*K)
     streaming work the device does from memory at full bandwidth).

All math is float32 on device; tests pin it against a float64 host
recomputation.
"""

from __future__ import annotations

import numpy as np


def unwrap_orthorhombic(pos, boxes):
    """Remove periodic jumps from a trajectory.

    pos [F, K, 3] f32 wrapped coordinates, boxes [F, 3] f32 per-frame box
    lengths -> [F, K, 3] continuous coordinates with u[0] = pos[0].
    Frame t's displacement uses frame t's box (the box the step was
    wrapped into).
    """
    import jax.numpy as jnp

    d = pos[1:] - pos[:-1]
    b = boxes[1:][:, None, :]
    d = d - b * jnp.round(d / b)
    return jnp.concatenate([pos[:1], pos[:1] + jnp.cumsum(d, axis=0)], axis=0)


def unwrap_triclinic(pos, boxes):
    """Triclinic-exact unwrap: consecutive-frame displacements are taken
    through the exact triclinic minimum image (27-image search,
    `ops.pbc.min_image_triclinic_frames`), then cumulatively summed.

    pos [F, K, 3] f32; boxes [F, 3, 3] per-frame box matrices (rows are
    box vectors, Gromacs lower-triangular).  Same sampling assumption as
    the orthorhombic form: true frame-to-frame motion smaller than half
    the smallest box extent.
    """
    import jax.numpy as jnp

    from .pbc import min_image_triclinic_frames

    d = min_image_triclinic_frames(pos[1:] - pos[:-1], boxes[1:])
    return jnp.concatenate([pos[:1], pos[:1] + jnp.cumsum(d, axis=0)], axis=0)


def unwrap(pos, boxes):
    """Dispatch on the box representation: [F, 3] lengths -> orthorhombic
    unwrap; [F, 3, 3] matrices -> exact triclinic unwrap."""
    import jax.numpy as jnp

    boxes = jnp.asarray(boxes)
    if boxes.ndim == 3:
        return unwrap_triclinic(pos, boxes)
    return unwrap_orthorhombic(pos, boxes)


def msd_lags(unwrapped, lags, axis_mask=None):
    """MSD over the given frame lags.

    unwrapped [F, K, 3] f32 (from `unwrap_orthorhombic`), lags [L] int32
    -> [L] f32: mean over the F-lag time origins and K atoms of the
    squared displacement.  Evaluated as one `lax.map` over lags — a
    single device dispatch for the whole curve.

    `axis_mask` [3] (optional) restricts the displacement to selected
    axes — the `gmx msd -lateral/-type` dimension filter.
    """
    import jax
    import jax.numpy as jnp

    u = jnp.asarray(unwrapped)
    f = u.shape[0]
    k = max(1, u.shape[1])
    t = jnp.arange(f)
    am = None if axis_mask is None else jnp.asarray(axis_mask, u.dtype)

    def one(lag):
        disp = jnp.roll(u, -lag, axis=0) - u
        if am is not None:
            disp = disp * am
        sq = jnp.sum(disp * disp, axis=-1)  # [F, K]
        valid = (t < f - lag)[:, None]
        n = jnp.maximum(f - lag, 1)
        return jnp.sum(jnp.where(valid, sq, 0.0)) / (n * k)

    return jax.lax.map(one, jnp.asarray(lags, jnp.int32))


def msd_host_f64(pos, boxes, lags):
    """Float64 host reference of unwrap + MSD (test oracle)."""
    p = np.asarray(pos, np.float64)
    b = np.asarray(boxes, np.float64)
    d = p[1:] - p[:-1]
    bb = b[1:][:, None, :]
    d -= bb * np.round(d / bb)
    u = np.concatenate([p[:1], p[:1] + np.cumsum(d, axis=0)], axis=0)
    out = []
    f, k = u.shape[0], max(1, u.shape[1])
    for lag in np.asarray(lags, np.int64):
        if lag >= f:
            out.append(np.nan)
            continue
        if lag == 0:
            out.append(0.0)
            continue
        disp = u[lag:] - u[:-lag]
        out.append(float((disp**2).sum() / ((f - lag) * k)))
    return np.asarray(out)


def lag_correlation(series, lags, weights=None):
    """Time autocorrelation of a per-atom vector series over frame lags.

    series [F, K, 3] f32 (e.g. velocities), lags [L] int32,
    weights [K] or None -> [L] f32:
    C(tau) = mean over the F-tau time origins of the (weighted) atom
    mean of dot(series(t), series(t+tau)) — `gmx velacc` semantics
    (unweighted by default; pass masses for the -m form).  One `lax.map`
    dispatch for the whole curve, like `msd_lags`.
    """
    import jax
    import jax.numpy as jnp

    s = jnp.asarray(series)
    f = s.shape[0]
    t = jnp.arange(f)
    if weights is None:
        w = jnp.ones(s.shape[1], jnp.float32)
    else:
        w = jnp.asarray(weights, jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1e-30)

    def one(lag):
        dot = jnp.sum(jnp.roll(s, -lag, axis=0) * s, axis=-1)  # [F, K]
        per_origin = jnp.sum(dot * w[None, :], axis=-1) / wsum  # [F]
        valid = t < f - lag
        n = jnp.maximum(f - lag, 1)
        return jnp.sum(jnp.where(valid, per_origin, 0.0)) / n

    return jax.lax.map(one, jnp.asarray(lags, jnp.int32))


def lag_correlation_host_f64(series, lags, weights=None):
    """Float64 host reference of `lag_correlation` (test oracle)."""
    s = np.asarray(series, np.float64)
    f = s.shape[0]
    w = (np.ones(s.shape[1]) if weights is None
         else np.asarray(weights, np.float64))
    out = []
    for lag in np.asarray(lags, np.int64):
        if lag >= f:
            out.append(np.nan)
            continue
        dot = np.sum(s[lag:] * s[: f - lag], axis=-1)  # [F-lag, K]
        out.append(float((dot @ w).sum() / (w.sum() * (f - lag))))
    return np.asarray(out)


def legendre_lag_correlation(series, lags, order: int = 2):
    """Legendre-polynomial rotational autocorrelation over frame lags.

    series [F, K, 3] UNIT vectors, lags [L] int32, order 1 or 2 ->
    [L] f32: C_n(tau) = mean over time origins and vectors of
    P_n(u(t) . u(t+tau)) — `gmx rotacf -P n` semantics.  One `lax.map`
    dispatch for the whole curve, like `lag_correlation`.
    """
    import jax
    import jax.numpy as jnp

    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    s = jnp.asarray(series)
    f = s.shape[0]
    t = jnp.arange(f)

    def one(lag):
        dot = jnp.sum(jnp.roll(s, -lag, axis=0) * s, axis=-1)  # [F, K]
        p = dot if order == 1 else 1.5 * dot * dot - 0.5
        per_origin = jnp.mean(p, axis=-1)                      # [F]
        valid = t < f - lag
        n = jnp.maximum(f - lag, 1)
        return jnp.sum(jnp.where(valid, per_origin, 0.0)) / n

    return jax.lax.map(one, jnp.asarray(lags, jnp.int32))


def msd_lags_per_entity(unwrapped, lags, axis_mask=None):
    """Per-entity MSD over the given frame lags.

    Like `msd_lags`, but the K axis holds independent entities (e.g.
    molecule COMs) whose curves stay separate: returns `[L, K]` — the
    mean over time origins only.  One `lax.map` dispatch for the whole
    family of curves (the `gmx msd -mol` kernel).
    """
    import jax
    import jax.numpy as jnp

    u = jnp.asarray(unwrapped)
    f = u.shape[0]
    t = jnp.arange(f)
    am = None if axis_mask is None else jnp.asarray(axis_mask, u.dtype)

    def one(lag):
        disp = jnp.roll(u, -lag, axis=0) - u
        if am is not None:
            disp = disp * am
        sq = jnp.sum(disp * disp, axis=-1)            # [F, K]
        valid = (t < f - lag)[:, None]
        n = jnp.maximum(f - lag, 1)
        return jnp.sum(jnp.where(valid, sq, 0.0), axis=0) / n

    return jax.lax.map(one, jnp.asarray(lags, jnp.int32))
