"""The top-level entry points' environment contract: the compile-cache
location, and chip_smoke.py refusing to run (or to report success) without
a GPU or without the package beside it.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from pysvihmm_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir(monkeypatch, tmp_path, restore_cache_dir, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    checkout's .jax_cache (never a temporary or per-process name)."""
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    assert cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.pop("PYTHONPATH", None)
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240,
    )


def _claims_ok(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


def test_chip_smoke_refuses_cpu():
    p = _run(["chip_smoke.py"], cwd=REPO)
    assert p.returncode != 0
    assert "needs 1 GPU" in p.stderr
    assert not _claims_ok(p.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    fails at the package import even once past the device check."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = (
        "import runpy\n"
        "g = runpy.run_path('chip_smoke.py')\n"
        "g['main'].__globals__['phase_device'] = lambda n: None\n"
        "g['main']([])\n"
    )
    p = _run(["-c", code], cwd=str(tmp_path))
    assert p.returncode != 0
    assert "ModuleNotFoundError" in p.stderr
    assert not _claims_ok(p.stdout)
