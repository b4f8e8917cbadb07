"""Process set-up: compile-cache location, the GPU requirement of the
measuring entry points, and the device record they print."""

import os
import subprocess
import sys

import jax
import pytest

from bmfr_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path,
                                           restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is overridden in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_the_checkout(monkeypatch,
                                                   restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.configure_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def test_device_record():
    devices = jax.devices()
    assert runtime.device_record(devices) == {
        "platform": "cpu", "kind": devices[0].device_kind,
        "count": len(devices)}


def test_bench_refuses_a_non_gpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_FRAMES="2",
               BENCH_WIDTH="64", BENCH_HEIGHT="48")
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"metric"' not in r.stdout
