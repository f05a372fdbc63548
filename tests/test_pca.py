"""Positional PCA (surpass — gmx covar + anaeig; the reference has none).

Pins `models.pca` against exact single-mode constructions, a rigid-body
zero property, a float64 host oracle (Kabsch fit + covariance + eigh),
and the DeviceTrajectory layout paths.  The covariance build is one
[F,3K]^T @ [F,3K] matmul.
"""

import os

import numpy as np
import pytest

from groan_rs_tpu import models
from groan_rs_tpu.errors import ParallelError
from groan_rs_tpu.models import TrajectoryAnalysis
from groan_rs_tpu.system import System

from test_rmsf import _frames, _system, _write_xtc

pytestmark = pytest.mark.device_parity

TF = "/root/reference/test_files"


def test_pca_single_mode_exact(tmp_path):
    # x(t) = base + a(t) * M with one unit-norm mode M: the covariance is
    # rank one, eigenvalue = population var(a), eigenvector = +-M,
    # projections = centered a(t)
    rng = np.random.default_rng(5)
    k, f = 30, 24
    base = rng.uniform(4.0, 8.0, size=(k, 3))
    mode = rng.normal(size=(k, 3))
    # COM-free mode: even fit=False removes the per-frame COM (gmx covar
    # semantics), so a mode with net translation would lose that part
    mode -= mode.mean(0)
    mode /= np.linalg.norm(mode)
    amp = rng.uniform(-0.5, 0.5, size=f)
    frames = (base[None] + amp[:, None, None] * mode[None]).astype(np.float32)
    path = str(tmp_path / "mode.xtc")
    _write_xtc(path, frames)
    s = _system(k, np.ones(k, np.float32), base)

    out = models.pca(s, path, "All", fit=False, mass_weighted=False)
    # file quantization (1e-4 nm) perturbs amp slightly; recompute from it
    q = np.round(np.asarray(frames, np.float64) * 1e4) / 1e4
    a_eff = np.einsum("fki,ki->f", q - q.mean(0), mode)
    var = a_eff.var()
    assert abs(out["eigenvalues"][0] - var) < 1e-4 + 1e-2 * var
    assert float(np.abs(out["eigenvalues"][1:]).max()) < 1e-6
    got_mode = out["eigenvectors"][0]
    assert abs(abs(np.sum(got_mode * mode)) - 1.0) < 1e-4
    # projections match centered amplitudes up to the eigenvector's sign
    sgn = np.sign(np.sum(got_mode * mode))
    np.testing.assert_allclose(out["projections"][:, 0],
                               sgn * (a_eff - a_eff.mean()), atol=5e-4)


def test_pca_rigid_body_is_zero(tmp_path):
    frames, masses = _frames(noise=0.0, seed=13)
    path = str(tmp_path / "rigid.xtc")
    _write_xtc(path, frames)
    s = _system(frames.shape[1], masses, frames[0])
    out = models.pca(s, path, "All")
    # only XTC quantization survives the fit; eigenvalues are amu nm^2
    assert float(out["eigenvalues"][0]) < 1e-4
    assert out["trace"] < 1e-3


def _host_fit(frames, masses, ref, ref_com):
    """float64 Kabsch fit of every frame onto ref: mass-weighted
    centroids, unweighted covariance (rmsd.rs:547-604 semantics, same as
    the rmsf oracle)."""
    w = np.asarray(masses, np.float64)
    pc = np.asarray(ref, np.float64)
    pc = pc - (w[:, None] * pc).sum(0) / w.sum()
    fitted = np.empty_like(np.asarray(frames, np.float64))
    for f in range(frames.shape[0]):
        q = np.asarray(frames[f], np.float64)
        qc = q - (w[:, None] * q).sum(0) / w.sum()
        h = pc.T @ qc
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(u @ vt))
        m = u @ np.diag([1.0, 1.0, d]) @ vt
        fitted[f] = qc @ m.T + ref_com
    return fitted


def test_pca_matches_host_oracle(tmp_path):
    frames, masses = _frames(n_frames=20, noise=0.08, seed=17)
    path = str(tmp_path / "noisy.xtc")
    _write_xtc(path, frames)
    s = _system(frames.shape[1], masses, frames[0])
    out = models.pca(s, path, "All")

    q = np.round(np.asarray(frames, np.float64) * 1e4) / 1e4
    fitted = _host_fit(q, masses, s.positions, s.group_get_com("All"))
    sw = np.sqrt(np.asarray(masses, np.float64))
    x = ((fitted - fitted.mean(0)) * sw[None, :, None]).reshape(
        frames.shape[0], -1)
    cov = x.T @ x / frames.shape[0]
    evals = np.linalg.eigvalsh(cov)[::-1]

    np.testing.assert_allclose(out["eigenvalues"], evals,
                               rtol=2e-2, atol=2e-4)
    assert abs(out["trace"] - np.trace(cov)) < 2e-2 * np.trace(cov)
    # trace == sum of all eigenvalues
    assert abs(out["trace"] - out["eigenvalues"].sum()) < \
        1e-3 * out["trace"]
    # per-mode projection variance equals the eigenvalue
    pv = out["projections"].var(axis=0)
    np.testing.assert_allclose(pv[:10], out["eigenvalues"][:10],
                               rtol=2e-2, atol=2e-4)
    # eigenvectors orthonormal
    v = out["eigenvectors"].reshape(out["eigenvectors"].shape[0], -1)
    g = v @ v.T
    np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=2e-3)


def test_pca_device_trajectory_layouts_and_options(tmp_path):
    frames, masses = _frames(n_frames=12, noise=0.05, seed=3)
    path = str(tmp_path / "layout.xtc")
    _write_xtc(path, frames)
    s = _system(frames.shape[1], masses, frames[0])
    s.group_create_from_ranges("Half", [(0, frames.shape[1] // 2 - 1)])

    by_file = models.pca(s, path, "Half", n_components=5)
    dt_group = TrajectoryAnalysis(s).runner(group="Half").load_device(path)
    by_dt = models.pca(s, dt_group, "Half", n_components=5)
    np.testing.assert_allclose(by_dt["eigenvalues"], by_file["eigenvalues"],
                               rtol=1e-5, atol=1e-7)
    dt_all = TrajectoryAnalysis(s).runner(ship="all").load_device(path)
    by_all = models.pca(s, dt_all, "Half", n_components=5)
    np.testing.assert_allclose(by_all["eigenvalues"], by_file["eigenvalues"],
                               rtol=1e-5, atol=1e-7)

    assert by_file["eigenvalues"].shape == (5,)
    assert by_file["eigenvectors"].shape == (5, frames.shape[1] // 2, 3)
    assert by_file["projections"].shape == (frames.shape[0], 5)

    # unweighted differs from mass-weighted (masses are non-uniform)
    uw = models.pca(s, path, "Half", n_components=5, mass_weighted=False)
    assert abs(uw["trace"] - by_file["trace"]) > 1e-6

    # deterministic across runs (eigenvector sign fixing)
    again = models.pca(s, path, "Half", n_components=5)
    np.testing.assert_array_equal(again["eigenvectors"],
                                  by_file["eigenvectors"])


def test_pca_needs_two_frames(tmp_path):
    frames, masses = _frames(n_frames=1, seed=9)
    path = str(tmp_path / "one.xtc")
    _write_xtc(path, frames)
    s = _system(frames.shape[1], masses, frames[0])
    with pytest.raises(ParallelError, match="2 frames"):
        models.pca(s, path, "All")


def test_pca_fixture_protein():
    s = System.from_file(os.path.join(TF, "example.tpr"))
    s.group_create("Protein", "@protein")
    xtc = os.path.join(TF, "short_trajectory.xtc")
    out = models.pca(s, xtc, "Protein", n_components=8)
    ev = out["eigenvalues"]
    assert ev.shape == (8,) and np.isfinite(ev).all()
    # descending, non-negative (within eigh noise)
    assert (np.diff(ev) <= 1e-5).all() and ev[0] > 0
    assert out["eigenvectors"].shape == (8, 61, 3)
    assert np.isfinite(out["projections"]).all()
    # a handful of collective modes dominate a short protein trajectory
    assert ev[:8].sum() > 0.5 * out["trace"]


def test_pca_frame_sharded_mesh_equality(tmp_path):
    """The frame-sharded shard_map path (partial mean / X^T X psum over
    the 'frames' axis) must match the single-device path, including a
    frame count that does NOT divide the mesh axis (zero-mask padding)."""
    import jax

    from groan_rs_tpu.parallel.engine import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    frames, masses = _frames(n_frames=13, noise=0.06, seed=21)  # 13 % 8 != 0
    path = str(tmp_path / "mesh.xtc")
    _write_xtc(path, frames)
    s = _system(frames.shape[1], masses, frames[0])

    single = models.pca(s, path, "All", n_components=6)
    mesh = make_mesh(8, 1)
    sharded = models.pca(s, path, "All", n_components=6, mesh=mesh)
    np.testing.assert_allclose(sharded["eigenvalues"],
                               single["eigenvalues"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sharded["trace"], single["trace"], rtol=1e-4)
    np.testing.assert_allclose(sharded["mean"], single["mean"], atol=1e-5)
    # eigenvectors and projections agree up to f32 reduction order
    np.testing.assert_allclose(np.abs(sharded["eigenvectors"]),
                               np.abs(single["eigenvectors"]), atol=5e-3)
    np.testing.assert_allclose(sharded["projections"],
                               single["projections"], atol=5e-3)
    assert sharded["projections"].shape == (13, 6)
