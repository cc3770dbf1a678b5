"""Test configuration.

Tests run on the CPU with 8 virtual devices so multi-device sharding logic
is exercised without a GPU (SURVEY.md section 4 test plan, item d).  The
env vars must be set before jax is imported anywhere.

Tests marked ``gpu`` need an NVIDIA GPU; the ``gpu_platform`` fixture
skips them elsewhere.  Run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:cacheprovider``:
an explicit ``JAX_PLATFORMS`` is kept, and the CPU is only the default.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from tsta_tpu.utils.cache import enable_compile_cache  # noqa: E402

# the row-scan kernels recompile per (shape, params) bucket
enable_compile_cache()

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="run slow (multi-minute) golden tests")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow") or os.environ.get("TSTA_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow; use --run-slow or TSTA_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def golden_dir():
    return GOLDEN


@pytest.fixture
def gpu_platform():
    """Skip unless JAX runs on an NVIDIA GPU (decided when the test runs,
    never at import: every xdist worker must collect the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run with JAX_PLATFORMS=cuda "
                    "-m gpu on the card")
