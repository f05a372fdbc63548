"""Interactive-API latency guard: per-call System analysis methods warn
once after N dispatches, pointing at the batched pipeline (the reference's
per-call methods are CPU-local, analysis.rs:105)."""

import os
import warnings

import numpy as np
import pytest

from groan_rs_tpu.errors import PerformanceWarning
from groan_rs_tpu.system import System
from groan_rs_tpu.system.analysis import _reset_dispatch_guard

TF = "/root/reference/test_files"


@pytest.fixture(autouse=True)
def _restore_guard():
    yield
    _reset_dispatch_guard(int(os.environ.get("GROAN_DISPATCH_WARN_AT",
                                             "256")))


def test_warns_once_after_threshold():
    s = System.from_file(os.path.join(TF, "example.gro"))
    s.group_create("P", "@protein")
    _reset_dispatch_guard(5)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(8):
            s.group_get_center("P")
    perf = [w for w in rec if issubclass(w.category, PerformanceWarning)]
    assert len(perf) == 1
    assert "TrajectoryAnalysis" in str(perf[0].message)


def test_batched_pipeline_does_not_tick():
    from groan_rs_tpu.models import TrajectoryAnalysis
    from groan_rs_tpu.system.analysis import _dispatch_state

    s = System.from_file(os.path.join(TF, "example.tpr"))
    s.group_create("Protein", "@protein")
    _reset_dispatch_guard(5)
    pipe = TrajectoryAnalysis(s).add_com("Protein", name="com")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = pipe.runner().run(os.path.join(TF, "short_trajectory.xtc"),
                                batch_size=4)
    assert out["com"].shape[0] == 11
    assert _dispatch_state["count"] == 0
    assert not [w for w in rec if issubclass(w.category, PerformanceWarning)]


def test_guard_disabled_by_env():
    s = System.from_file(os.path.join(TF, "example.gro"))
    s.group_create("P", "@protein")
    _reset_dispatch_guard(0)   # 0 = off
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(10):
            s.group_get_center("P")
    assert not [w for w in rec if issubclass(w.category, PerformanceWarning)]
