"""Test harness config: run the suite on an 8-device virtual CPU platform.

The tests run on the host CPU with 8 virtual devices so the sharding and
collective paths are exercised as on a multi-card mesh (SNIPPETS.md [3]
pattern). The default device is pinned to the CPU explicitly as well.

PYSVIHMM_GPU_TESTS=1 leaves the platform alone instead: that is how the
test cases marked `gpu` run on a CUDA device (chip_smoke.py runs them in
its own process; `PYSVIHMM_GPU_TESTS=1 python -m pytest -m gpu
tests/test_gpu_kernels.py` runs them alone). Without a GPU they skip.
"""

import os

ON_GPU = os.environ.get("PYSVIHMM_GPU_TESTS") == "1"
if not ON_GPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

# Build the C forward-backward oracle extension in place if it is missing
# (the reference's `setup.py build_ext --inplace` workflow, SURVEY.md §2.2)
# so tests/test_native_ext.py exercises the C path instead of skipping.
# Opt out with PYSVIHMM_NO_EXT_BUILD=1.
if not os.environ.get("PYSVIHMM_NO_EXT_BUILD"):
    import glob as _glob
    import subprocess as _sp
    import sys as _sys

    _repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not _glob.glob(os.path.join(_repo, "pysvihmm_tpu", "oracle", "_fb_ext*.so")):
        try:  # best-effort: the suite passes (with 4 skips) without it
            _sp.run(
                [_sys.executable, "setup.py", "build_ext", "--inplace"],
                cwd=_repo, timeout=240, capture_output=True, check=False,
            )
        except Exception:
            pass

import jax  # noqa: E402

try:
    _cpus = jax.devices("cpu")
except RuntimeError:  # pragma: no cover
    _cpus = jax.devices()
if not ON_GPU:
    jax.config.update("jax_default_device", _cpus[0])

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (see module doc)"
    )


@pytest.fixture
def cuda_device():
    """The CUDA device a `gpu` test runs on; skips the test without one."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a CUDA device (run through chip_smoke.py)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The suite accumulates ~300 compiled XLA:CPU programs; past a threshold
    the CPU client's JIT aborts the process mid-compile (observed
    deterministically in test_svi after the full preceding suite — a
    segfault/abort inside backend_compile_and_load, not a Python error).
    Dropping executables between modules keeps the resident JIT footprint
    bounded; per-module recompiles cost far less than the crash.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def cpu_devices():
    return _cpus


@pytest.fixture
def enable_x64():
    """Run a test in float64 (oracle-parity tests)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
