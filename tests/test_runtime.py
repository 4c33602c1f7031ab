"""Process set-up helpers (utils/runtime.py): the compile-cache path, the
device check that refuses a CPU, and the chip-test gate."""
import os
import subprocess
import sys

import jax
import pytest

from ieee80211_phy.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_is_fixed(monkeypatch):
    """No temporary name, pid or time in the path: two processes agree."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    code = ("from ieee80211_phy.utils import runtime; "
            "print(runtime.compile_cache_dir())")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    outs = {subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, check=True,
                           timeout=120).stdout.strip() for _ in range(2)}
    assert outs == {runtime.compile_cache_dir()}


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert set(runtime.cache_stats()) == {"hits", "misses"}
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_importing_the_package_sets_no_cache():
    """Nothing configures the cache at import time."""
    code = ("import jax, ieee80211_phy, ieee80211_phy.rx, "
            "ieee80211_phy.utils.runtime, bench, chip_smoke; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.strip()
    assert out == "None"


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_require_gpu_accepts_gpu(monkeypatch):
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    assert len(runtime.require_gpu()) == 1
    assert runtime.device_info() == {"platform": "gpu",
                                     "kind": "NVIDIA H100 80GB HBM3",
                                     "count": 1}


def test_chip_smoke_refuses_cpu():
    """No accelerator: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py", "8", "1"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr


@pytest.mark.chip
def test_chip_marker_runs_only_on_a_gpu():
    assert jax.default_backend() == "gpu"
