"""The one-shot path (`FrameEngine.run_oneshot`) on a synthetic
trajectory: it runs on the engine's own device and equals the streamed
pass."""

import numpy as np
import pytest

from groan_rs_tpu import synthetic


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    from groan_rs_tpu.io import native

    xtc = synthetic.ensure_trajectory(
        str(tmp_path_factory.mktemp("oneshot")), 3000, 6)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offs[:1], nat)
    system, _ = synthetic.build_system(3000, coords[0], b9[0][[0, 4, 8]])
    return xtc, system


@pytest.mark.parametrize("wire", ["q16", "f32"])
def test_oneshot_equals_streamed_on_default_device(traj, wire, monkeypatch):
    import jax

    from groan_rs_tpu.models import TrajectoryAnalysis
    from groan_rs_tpu.parallel.engine import make_mesh

    xtc, system = traj
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])

    def runner():
        return (TrajectoryAnalysis(system, mesh=mesh)
                .add_com("Peptide", name="com")
                .add_rmsd("Peptide", reference=system, name="rmsd")
                .runner(wire=wire))

    one = runner()
    out = one.run(xtc, batch_size=2)
    assert len(one.engine.last_batch_walls) == 1  # one dispatch
    assert [d for d in one.engine.mesh.devices.flat] == [jax.devices()[0]]
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")
    streamed = runner()
    ref = streamed.run(xtc, batch_size=2)
    assert len(streamed.engine.last_batch_walls) == 3
    for k in ("com", "rmsd"):
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]),
                                   rtol=0, atol=2e-6)
