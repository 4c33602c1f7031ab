"""Process set-up for the entry points that run on a GPU: the persistent
compile cache, the device check, and the device description every result
is printed with. Nothing here runs at import time."""
from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the monitoring listener is process-wide, so its counts are too
_cache_events = {"hits": 0, "misses": 0}
_listening = False


def _count_cache_event(event: str, **_) -> None:
    if event == "/jax/compilation_cache/cache_hits":
        _cache_events["hits"] += 1
    elif event == "/jax/compilation_cache/cache_misses":
        _cache_events["misses"] += 1


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else the fixed path
    <checkout>/.jax_cache (git-ignored). The path is part of the cache's
    key, so it is never built from a temporary name, a pid or the time."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Keep every compiled program in compile_cache_dir(); returns it.
    Hits and misses are counted from then on (cache_stats)."""
    global _listening
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    if not _listening:
        jax.monitoring.register_event_listener(_count_cache_event)
        _listening = True
    return path


def cache_stats() -> dict:
    """Persistent-cache hits and misses counted since enable_compile_cache."""
    return {"hits": _cache_events["hits"], "misses": _cache_events["misses"]}


def require_gpu() -> list:
    """The devices JAX found, or RuntimeError when they are not GPUs: a
    measurement that falls back to the CPU would be mislabelled."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devs[0].platform} devices only")
    return devs


def device_info() -> dict:
    """platform, device_kind and count, as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit from nvidia-smi (a child process
    that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
