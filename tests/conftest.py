"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device tests replace the reference's multithread tests
(SURVEY.md §4): sharding is validated on host CPU devices via
``xla_force_host_platform_device_count`` exactly as the driver's
``dryrun_multichip`` does.

Backend matrix (SURVEY §4, the reference's feature-matrix CI analogue):
by default the whole suite runs on the CPU mesh.  On a machine with an
NVIDIA GPU, the numeric-parity subset runs on the card with

    GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity

Modules marked ``device_parity`` assert reference numerics (vecmath,
centers, RMSD, PBC, triclinic, pair reductions) with tolerances that a
TF32 contraction would fail.  Tests marked ``gpu`` need the card: they
skip, with a reason, when the default JAX device is not a GPU.
"""

import os
import sys

_PLATFORM = os.environ.get("GROAN_TEST_PLATFORM", "cpu")

# the CPU backend stays available beside the card: ops.interactive runs
# per-call System methods on it
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _PLATFORM == "gpu" else _PLATFORM
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
flags = os.environ.get("XLA_FLAGS", "")
if _PLATFORM == "cpu" and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# a plugin may have imported jax before the environment was set
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from groan_rs_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402

REFERENCE_FILES = "/root/reference/test_files"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "device_parity: numeric-parity tests that also run on the GPU "
        "(GROAN_TEST_PLATFORM=gpu pytest -m device_parity)",
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test unless the default JAX device is a GPU
    (decided here, when the test runs, never at collection)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU; the default JAX device is {platform}")


@pytest.fixture(scope="session")
def test_files():
    """Path to the reference fixture corpus (read-only)."""
    if not os.path.isdir(REFERENCE_FILES):
        pytest.skip("reference test_files corpus not available")
    return REFERENCE_FILES
