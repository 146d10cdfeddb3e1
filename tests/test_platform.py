"""Platform rules: impl='auto' per backend, the compile-cache location, and
chip_smoke.py's refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from ocdp_tpu import profiling
from ocdp_tpu.ops import default_impl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,want", [("gpu", "rowlane"),
                                          ("cpu", "stencil"),
                                          ("metal", "stencil")])
def test_default_impl_per_platform(monkeypatch, backend, want):
    """A GPU backend gets the accelerator choice; every other backend the
    portable XLA stencil."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert default_impl("rowlane") == want


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (the cache
    must not switch on in the test worker)."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path,
                                               config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no directory is set in code
    assert "jax_compilation_cache_dir" not in config_updates
    assert config_updates["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_compile_cache_defaults_inside_the_checkout(monkeypatch,
                                                    config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert config_updates["jax_compilation_cache_dir"] == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_chip_smoke_refuses_a_cpu_backend():
    proc = _run_smoke(REPO)
    _assert_refused(proc)
    assert "gpu" in (proc.stdout + proc.stderr).lower()


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_refused(_run_smoke(tmp_path))
