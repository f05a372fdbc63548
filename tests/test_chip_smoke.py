"""`chip_smoke.py`: its phases at tiny sizes on the CPU mesh, and its
refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    return chip_smoke.prepare(n_atoms=3000, n_frames=8,
                              cache_dir=str(tmp_path_factory.mktemp("smoke")))


@pytest.fixture(scope="module")
def streamed(ctx):
    return chip_smoke.phase_streamed(ctx, batch=2)


def test_prepare_builds_the_system_and_reference(ctx):
    assert ctx.n_prot == 300 and ctx.n_mem == 1000
    assert ctx.system.get_n_atoms() == 3000
    assert ctx.ref["com"].shape == (8, 3)
    assert ctx.ref["dist"].shape == (8,) and ctx.ref["rmsd"].shape == (8,)
    assert ctx.reach.shape == (8,) and np.isfinite(ctx.reach).all()
    # the frame-0 self-RMSD of the float64 reference is zero
    assert ctx.ref["rmsd"][0] == pytest.approx(0.0, abs=1e-9)


def test_phase_streamed(ctx, streamed):
    _, out = streamed
    assert np.asarray(out["com"]).shape == (8, 3)
    errs = chip_smoke.series_errors(out, ctx.ref)
    assert set(errs) == {"com", "dist", "rmsd"}
    for err in errs.values():
        assert err.shape == (8,)
        assert (err <= chip_smoke.TOL_REF_NM + ctx.reach).all()


def test_phase_resident(ctx, streamed):
    runner, out = streamed
    outs = chip_smoke.phase_resident(ctx, runner, out, batch=2)
    assert set(outs) == {"fused", "per-batch"}
    assert "GROAN_RESIDENT_FUSED" not in os.environ


def test_phase_resident_needs_four_batches(ctx, streamed):
    runner, out = streamed
    with pytest.raises(AssertionError, match=">= 4 batches"):
        chip_smoke.phase_resident(ctx, runner, out, batch=4)


def test_phase_small_group(ctx):
    out = chip_smoke.phase_small_group(ctx, batch=2)
    assert np.asarray(out["rmsd"]).shape == (8,)


def test_phase_pairs(ctx):
    out = chip_smoke.phase_pairs(ctx, n_frames=2, subset=(200, 300))
    assert np.asarray(out["contacts"]).shape == (2,)


def test_phase_four_on_four_cpu_devices(ctx):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    chip_smoke.phase_four(ctx, batch=4)


def _series(rmsd):
    return {"dist": np.zeros(4), "rmsd": np.asarray(rmsd, np.float64)}


def test_check_series_widens_each_frame_by_its_reach():
    """A frame whose float32 reach is 2e-3 nm accepts a wrap-plane flip
    of that size; every other frame keeps the bare tolerance."""
    reach = np.array([0.0, 0.0, 2e-3, 0.0])
    ref = _series([0.0, 0.1, 0.2, 0.3])
    ok = _series([1e-5, 0.1, 0.2 + 1.9e-3, 0.3])
    chip_smoke.check_series("ok", ok, ref, reach, 1e-4)
    with pytest.raises(AssertionError, match="rmsd"):
        chip_smoke.check_series("firm", _series([0.0, 0.1002, 0.2, 0.3]),
                                ref, reach, 1e-4)


def test_check_series_fails_a_gross_error_on_a_wide_frame():
    """The widened bound is no skip: an error far past the reach of the
    frame still fails, and so does a non-finite value."""
    reach = np.array([0.0, 0.0, 2e-3, 0.0])
    ref = _series([0.0, 0.1, 0.2, 0.3])
    with pytest.raises(AssertionError, match="rmsd"):
        chip_smoke.check_series("gross", _series([0.0, 0.1, 0.25, 0.3]),
                                ref, reach, 1e-4)
    with pytest.raises(AssertionError, match="rmsd"):
        chip_smoke.check_series("nan", _series([0.0, 0.1, np.nan, 0.3]),
                                ref, reach, 1e-4)


def test_stage_report_prints_the_stage_clocks(capsys):
    from types import SimpleNamespace

    engine = SimpleNamespace(
        last_stage_seconds={"decode_wait": [0.5, 1.5], "h2d": [0.1, 0.1],
                            "dispatch": [0.2, 0.2]},
        last_fetch_seconds=0.4)
    chip_smoke.stage_report("warm pass", engine, 3.5)
    line = capsys.readouterr().out
    assert "decode_wait 2.0000 s" in line and "fetch 0.4000 s" in line
    assert "rest 0.5000 s" in line and "2 batches" in line
    assert "longest decode wait 1.5000 s" in line


def test_wrap_fraction_counts_atoms_on_the_wrap_plane():
    from groan_rs_tpu import synthetic

    box = np.array([10.0, 10.0, 10.0])
    p = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0], [6.0, 2.0, 2.0],
                  [3.0, 3.0, 3.0]])
    assert synthetic.wrap_fraction(p, box, np.array([1.0, 5.0, 5.0]),
                                   1e-5) == 0.25
    assert synthetic.wrap_fraction(p, box, np.array([2.5, 5.0, 5.0]),
                                   1e-5) == 0.0


def test_center_spread_flags_an_evenly_spread_group():
    """A compact blob's center is firm; a slab spread evenly over the box
    along x has an estimate float32 cannot pin down."""
    from groan_rs_tpu import synthetic

    rng = np.random.default_rng(0)
    box = np.array([10.0, 10.0, 10.0])
    blob = 5.0 + rng.normal(size=(2000, 3)) * 0.5
    _, spread = synthetic.center_spread(blob, box)
    assert spread.max() < 1e-6
    slab = np.column_stack([np.linspace(0, 10, 2000, endpoint=False),
                            5.0 + rng.normal(size=(2000, 2)) * 0.5])
    _, spread = synthetic.center_spread(slab, box)
    assert spread[0] > 1e-4 and spread[1:].max() < 1e-6


def test_host_kabsch_follows_the_library_convention():
    """The float64 RMSD reference uses the unweighted covariance of
    `ops.rmsd.kabsch` (rmsd.rs:547-604): on a poorly fitting, unevenly
    weighted group the mass-weighted covariance would pick another
    rotation, ~1e-3 nm away."""
    import jax.numpy as jnp

    from groan_rs_tpu import synthetic
    from groan_rs_tpu.ops import rmsd

    rng = np.random.default_rng(5)
    box = np.array([21.0, 21.0, 21.0])
    ref = rng.normal(size=(60, 3)) * np.array([3.0, 1.0, 0.3])
    w = rng.uniform(1.0, 16.0, size=60)
    theta = 0.4
    rot = np.array([[np.cos(theta), -np.sin(theta), 0.0],
                    [np.sin(theta), np.cos(theta), 0.0], [0.0, 0.0, 1.0]])
    p = ref @ rot.T + rng.normal(size=(60, 3)) * 0.5 + box / 2
    com = synthetic.host_refined_center(p, box, w)
    want = synthetic.host_kabsch_rmsd(ref, np.zeros(3), p, box, w)
    qc = np.mod(p + (box / 2 - com), box) - box / 2
    _, _, got = rmsd.kabsch(jnp.asarray(ref, jnp.float32),
                            jnp.asarray(qc, jnp.float32),
                            jnp.asarray(w, jnp.float32),
                            jnp.zeros(3, jnp.float32),
                            jnp.zeros(3, jnp.float32))
    assert float(got) == pytest.approx(want, abs=1e-5)


def test_check_raises_beyond_tolerance():
    chip_smoke.check("ok", 1e-6, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke.check("bad", 2e-5, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke.check("nan", float("nan"), 1e-5)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "needs a GPU" in captured.err


def test_script_alone_fails_without_the_library(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
