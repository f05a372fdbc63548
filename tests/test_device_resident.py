"""Device-resident trajectories (`DeviceTrajectory`): decode + ship once,
re-analyze at pure compute speed.  Surpass feature — the reference's
closest analogue is the OS page cache over the XTC file
(comparison/xdrfile_vs_molly/info.md), which still pays decode per pass.
Resident passes must be BIT-IDENTICAL to the streamed wire."""

import os

import numpy as np
import pytest

from groan_rs_tpu.errors import ParallelError
from groan_rs_tpu.models import TrajectoryAnalysis
from groan_rs_tpu.system import System

pytestmark = pytest.mark.device_parity

TF = "/root/reference/test_files"


@pytest.fixture(scope="module")
def tpr_sys():
    s = System.from_file(os.path.join(TF, "example.tpr"))
    s.group_create("Protein", "@protein")
    return s


def _mesh1():
    import jax

    from groan_rs_tpu.parallel.engine import make_mesh

    return make_mesh(1, 1, devices=jax.devices()[:1])


def _pipe(s, mesh="1dev"):
    mesh = _mesh1() if mesh == "1dev" else mesh
    return (TrajectoryAnalysis(s, mesh=mesh)
            .add_com("Protein", name="com")
            .add_distance("Protein", "all", com=(True, False), name="dist")
            .add_rmsd("Protein", reference=s, name="rmsd"))


def test_resident_equals_streamed(tpr_sys, monkeypatch):
    # bit-identity needs IDENTICAL dispatch tiling on both sides: disable
    # the one-shot small-pass path so the streamed side runs the same
    # [4, K, 3] batches the resident side does (one-shot vs batched is a
    # different XLA compilation — ulp differences; the cross-tiling
    # tolerance contract is test_resident_batch_boundaries)
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")
    xtc = os.path.join(TF, "short_trajectory.xtc")
    runner = _pipe(tpr_sys.copy()).runner()
    streamed = runner.run(xtc, batch_size=4)
    dt = runner.load_device(xtc, batch_size=4)
    assert dt.kind == "q16"
    assert dt.n_frames == 11
    resident = runner.run(dt, batch_size=4)
    for k in ("com", "dist", "rmsd"):
        np.testing.assert_array_equal(np.asarray(streamed[k]),
                                      np.asarray(resident[k]))
    np.testing.assert_array_equal(streamed["times"], resident["times"])
    np.testing.assert_array_equal(streamed["steps"], resident["steps"])


def test_resident_batch_boundaries(tpr_sys):
    """Load/run batch tiling never changes results beyond f32 ulps (a
    different [B, K, 3] shape is a different XLA compilation, so exact
    bit-equality only holds for identical tiling — covered above)."""
    xtc = os.path.join(TF, "short_trajectory.xtc")
    runner = _pipe(tpr_sys.copy()).runner()
    base = runner.run(xtc, batch_size=11)
    dt = runner.load_device(xtc, batch_size=3)
    for bs in (1, 5, 32):
        out = runner.run(dt, batch_size=bs)
        for k in ("com", "dist", "rmsd"):
            np.testing.assert_allclose(np.asarray(base[k]),
                                       np.asarray(out[k]),
                                       rtol=0, atol=2e-5)


def test_resident_f32_wire(tpr_sys, monkeypatch):
    """The f32 wire materializes too (kind='f32'), still exact."""
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")  # match tiling (see above)
    xtc = os.path.join(TF, "short_trajectory.xtc")
    runner = _pipe(tpr_sys.copy()).runner(wire="f32")
    streamed = runner.run(xtc, batch_size=4)
    dt = runner.load_device(xtc, batch_size=4)
    assert dt.kind == "f32"
    resident = runner.run(dt, batch_size=4)
    for k in ("com", "dist", "rmsd"):
        np.testing.assert_array_equal(np.asarray(streamed[k]),
                                      np.asarray(resident[k]))


def test_resident_from_sharded_runner(tpr_sys):
    """A frames-sharded runner materializes via a single-device sibling
    engine; per-frame results agree with the sharded stream to f32 ulps
    (different XLA compilations -> reduction-order differences only)."""
    xtc = os.path.join(TF, "short_trajectory.xtc")
    runner = _pipe(tpr_sys.copy(), mesh=None).runner()
    streamed = runner.run(xtc, batch_size=8)
    dt = runner.load_device(xtc, batch_size=8)
    resident = runner.run(dt, batch_size=8)
    for k in ("com", "dist", "rmsd"):
        np.testing.assert_allclose(np.asarray(streamed[k]),
                                   np.asarray(resident[k]),
                                   rtol=0, atol=2e-5)


def test_resident_dense_hbonds(tpr_sys):
    """The in-step dense hbond counter runs device-resident too: exact
    reference counts [4675, 4644, 4629] with zero host assistance."""
    from groan_rs_tpu.system.hbonds import HBondChain

    s = System.from_file(os.path.join(TF, "aa_membrane_peptide.tpr"))
    xtc = os.path.join(TF, "aa_membrane_peptide.xtc")
    chain = HBondChain("resname SOL and name OW", "resname SOL and name OW",
                       "resname SOL and name HW1 HW2")
    pipe = TrajectoryAnalysis(s, mesh=_mesh1()).add_hbonds(
        [chain], [(0, 0)], 0.3, 150.0, name="hb", method="dense")
    runner = pipe.runner()
    # first 3 frames: the exact counts are the assertion, and the dense
    # counter is O(ND*NA) per frame on the CPU backend (~20 s/frame)
    dt = runner.load_device(xtc, end_time=70100.0)
    out = runner.run(dt)
    key = [k for k in out if k.startswith("hb")][0]
    assert np.asarray(out[key])[:3].tolist() == [4675, 4644, 4629]


def test_run_many_sweep_equals_individual(tpr_sys):
    """`run_many`: M analysis passes over ONE DeviceTrajectory share a
    single packed fetch; results are bit-identical to the per-pass
    `runner.run(dt)` calls (the packing is pure data movement)."""
    from groan_rs_tpu.models.pipeline import run_many

    xtc = os.path.join(TF, "short_trajectory.xtc")
    s = tpr_sys.copy()
    runners = [
        TrajectoryAnalysis(s, mesh=_mesh1())
        .add_com("Protein", name="com").runner(ship="all"),
        TrajectoryAnalysis(s, mesh=_mesh1())
        .add_distance("Protein", "all", com=(True, False), name="dist")
        .runner(ship="all"),
        TrajectoryAnalysis(s, mesh=_mesh1())
        .add_rmsd("Protein", reference=s, name="rmsd").runner(ship="all"),
    ]
    dt = runners[0].load_device(xtc, batch_size=4)
    many = run_many(runners, dt, batch_size=4)
    assert len(many) == 3
    for r, out in zip(runners, many):
        solo = r.run(dt, batch_size=4)
        assert set(solo) == set(out)
        for k in solo:
            np.testing.assert_array_equal(
                np.asarray(solo[k]), np.asarray(out[k]), err_msg=k)


def test_run_many_accepts_analyses(tpr_sys):
    """TrajectoryAnalysis instances compile inside run_many (ship='all'
    against a full-layout trajectory)."""
    from groan_rs_tpu.models.pipeline import run_many

    xtc = os.path.join(TF, "short_trajectory.xtc")
    s = tpr_sys.copy()
    loader = (TrajectoryAnalysis(s, mesh=_mesh1())
              .add_com("Protein", name="com").runner(ship="all"))
    dt = loader.load_device(xtc)
    outs = run_many(
        [TrajectoryAnalysis(s, mesh=_mesh1()).add_com("Protein", name="com"),
         TrajectoryAnalysis(s, mesh=_mesh1()).add_center("Protein",
                                                         name="cog")],
        dt)
    ref = loader.run(dt)
    np.testing.assert_array_equal(np.asarray(outs[0]["com"]),
                                  np.asarray(ref["com"]))
    assert outs[1]["cog"].shape == (11, 3)


def test_resident_layout_guard(tpr_sys):
    """A runner compiled for a different shipped-atom layout must refuse
    the DeviceTrajectory: same-width mismatches raise no shape error and
    would silently read the wrong atoms' coordinates."""
    xtc = os.path.join(TF, "short_trajectory.xtc")
    s = tpr_sys.copy()
    r_used = (TrajectoryAnalysis(s, mesh=_mesh1())
              .add_com("Protein", name="com").runner())  # protein-only ship
    r_all = (TrajectoryAnalysis(s, mesh=_mesh1())
             .add_com("Protein", name="com").runner(ship="all"))
    dt_used = r_used.load_device(xtc)
    assert r_used.run(dt_used)["com"].shape == (11, 3)
    with pytest.raises(ParallelError):
        r_all.run(dt_used)


def test_resident_rejects_host_assisted_hbonds(tpr_sys):
    """method='cells' scores candidates host-side per frame; a resident
    pass has no host coordinates, so it must refuse."""
    from groan_rs_tpu.system.hbonds import HBondChain

    s = System.from_file(os.path.join(TF, "aa_membrane_peptide.tpr"))
    chain = HBondChain("resname SOL and name OW", "resname SOL and name OW",
                       "resname SOL and name HW1 HW2")
    pipe = TrajectoryAnalysis(s, mesh=_mesh1()).add_com("all").add_hbonds(
        [chain], [(0, 0)], 0.3, 150.0, name="hb", method="cells")
    runner = pipe.runner()
    dt = _pipe(tpr_sys.copy()).runner().load_device(
        os.path.join(TF, "short_trajectory.xtc"))
    with pytest.raises(ParallelError):
        runner.run(dt)


def test_run_many_hbond_threshold_sweep(tpr_sys):
    """THE sweep use case: dense hbond counts at several thresholds over
    one resident trajectory — also exercises int leaves through the
    packed sweep fetch (non-f32 leaves fetch via the rest path)."""
    from groan_rs_tpu.models.pipeline import run_many
    from groan_rs_tpu.system.hbonds import HBondChain

    s = System.from_file(os.path.join(TF, "aa_membrane_peptide.tpr"))
    xtc = os.path.join(TF, "aa_membrane_peptide.xtc")
    chain = HBondChain("resname SOL and name OW", "resname SOL and name OW",
                       "resname SOL and name HW1 HW2")

    def build(dist):
        return (TrajectoryAnalysis(s, mesh=_mesh1())
                .add_hbonds([chain], [(0, 0)], dist, 150.0, name="hb",
                            method="dense").runner(ship="all"))

    runners = [build(0.3), build(0.25)]
    # first 2 frames only: the dense counter is O(ND*NA) and the CPU
    # suite pays ~4x the pass count here (sweep + solo re-run)
    dt = runners[0].load_device(xtc, end_time=70050.0)
    many = run_many(runners, dt)
    key = [k for k in many[0] if k.startswith("hb")][0]
    assert np.asarray(many[0][key])[:2].tolist() == [4675, 4644]
    solo = runners[1].run(dt)
    np.testing.assert_array_equal(np.asarray(many[1][key]),
                                  np.asarray(solo[key]))
    # tighter threshold finds strictly fewer bonds
    assert (np.asarray(many[1][key]) < np.asarray(many[0][key])).all()
