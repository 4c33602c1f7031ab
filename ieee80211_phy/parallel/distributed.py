"""Multi-host launch scaffolding: `jax.distributed` across hosts.

The reference's multi-host story is multiple OS processes on separate PCs
coordinated over UDP sockets and USRP RF (SURVEY.md §2.5; e.g. the AP/STA
ladders in the reference's tools/cmu_v3/). The device-mesh equivalent is
one JAX process per host joined into a single global runtime: collectives
ride NVLink within a host and the network across hosts, replacing both the
GR ring buffers and the UDP sockets.

Mesh layout rule: the *sp* (time-shard, halo-exchange) axis must stay
inside a host so `ppermute` halos ride NVLink; the *dp* (batch of
captures/packets) axis is the one to stretch across hosts, since it needs
no per-step communication (decoded-bit regroup is one all_gather at the
end). `make_global_phy_mesh` encodes that rule.

Usage (one process per host):

    from ieee80211_phy.parallel import distributed as dist
    dist.init_distributed(coordinator_address="host0:9876",
                          num_processes=N, process_id=i)
    mesh = dist.make_global_phy_mesh(sp=4)
    run = sharded_capture_decode(mesh, mod, n_sym, window_len)
    ...

On clusters whose launcher JAX auto-detects (e.g. SLURM), call
``init_distributed()`` with no arguments — cluster auto-detection fills in
the coordinator. Single-process runs skip initialization entirely and fall
back to the local mesh, so the same program runs anywhere.
"""
from __future__ import annotations

import os

import jax
import numpy as np

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> bool:
    """Join this process into a multi-host JAX runtime.

    Arguments may come explicitly, from the environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID — our
    names, resolved here), or from cluster auto-detection (no arguments on
    a supported launcher). Returns True if a multi-process runtime was
    initialized, False for the single-process fallback. Idempotent.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False                       # single-process fallback
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _initialized = True
    return jax.process_count() > 1


def make_global_phy_mesh(sp: int = 1, devices=None):
    """Mesh over every device of every process, axes (dp, sp).

    The device matrix is laid out [process-major, local-minor] and the sp
    axis is carved out of the *local* (fast, NVLink) dimension: sp must divide
    the per-process device count so halo ppermutes never leave the host. dp
    spans the rest, including the cross-host direction.
    """
    devs = devices if devices is not None else jax.devices()
    n_local = max(1, len([d for d in devs
                          if d.process_index == jax.process_index()]))
    if sp > 1:
        assert n_local % sp == 0, (
            f"sp={sp} must divide local device count {n_local} so halo "
            f"exchange stays inside one host")
    n = len(devs)
    assert n % sp == 0
    # order devices process-major so reshape puts sp within a process;
    # build the Mesh DIRECTLY from the ordered grid — jax.make_mesh would
    # remap devices by physical topology (ignoring caller order), which
    # breaks the sp-inside-a-host guarantee on multi-host targets.
    devs = sorted(devs, key=lambda d: (d.process_index, d.id))
    grid = np.asarray(devs).reshape(n // sp, sp)
    mesh = jax.sharding.Mesh(grid, ("dp", "sp"))
    # enforce the documented invariant: every sp row lives in ONE process
    for row in grid:
        procs = {d.process_index for d in row}
        assert len(procs) == 1, (
            f"sp row spans processes {procs}; halo would cross hosts")
    return mesh


def process_summary() -> dict:
    """Small observability record for launch logs."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "backend": jax.default_backend(),
    }
