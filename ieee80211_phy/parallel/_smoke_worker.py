"""Worker process for the multi-host (multi-process) mesh smoke test.

Launched N times by tests/test_distributed.py (and usable by hand for a
real multi-host bring-up dry run):

    JAX_COORDINATOR_ADDRESS=localhost:9876 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=0 python -m ieee80211_phy.parallel._smoke_worker

Each process exposes 4 virtual CPU devices, joins the distributed runtime,
builds the global (dp x sp) mesh, and proves on it:
  1. a psum over both mesh axes crosses the process boundary (multi-host analog),
  2. the halo-exchange front-end on a globally-sharded capture matches the
     single-device reference computed locally from the same numpy input.
Prints one "SMOKE OK ..." line on success; any mismatch raises.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=4").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
from functools import partial

from ieee80211_phy.parallel import distributed as dist


def main():
    multi = dist.init_distributed()
    info = dist.process_summary()
    assert multi and info["process_count"] >= 2, f"not multi-process: {info}"
    mesh = dist.make_global_phy_mesh(sp=2)
    assert mesh.shape["sp"] == 2
    assert mesh.shape["dp"] == info["global_devices"] // 2

    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    # 1. cross-process collective
    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp", "sp"),
             out_specs=P())
    def total(x):
        return jax.lax.psum(jnp.sum(x), ("dp", "sp"))[None]

    b, t = mesh.shape["dp"] * 2, 4096
    rng = np.random.default_rng(0)
    host = rng.standard_normal((b, t, 2)).astype(np.float32) * 0.1
    ones = np.ones((mesh.shape["dp"], mesh.shape["sp"]), np.float32)
    sharding = NamedSharding(mesh, P("dp", "sp"))
    g1 = jax.make_array_from_callback(ones.shape, sharding,
                                      lambda idx: ones[idx])
    s = float(np.asarray(total(g1).addressable_shards[0].data)[0])
    want = float(ones.sum())
    assert abs(s - want) < 1e-6, f"psum {s} != {want}"

    # 2. halo-exchange front-end parity on a process-spanning capture
    from ieee80211_phy.ops import sync
    from ieee80211_phy.parallel.sharded import sharded_frontend, HALO
    from ieee80211_phy.utils.riq import r2c

    cap_sh = NamedSharding(mesh, P("dp", "sp", None))
    gcap = jax.make_array_from_callback(host.shape, cap_sh,
                                        lambda idx: host[idx])
    ac = sharded_frontend(mesh, gcap)
    # reference on the local (unsharded) copy of the same data, zero-padded
    # by HALO so the output covers all T samples like the sharded version
    padded = np.concatenate([host, np.zeros((b, HALO, 2), np.float32)],
                            axis=1)
    want_ac = np.array(sync.stf_autocorr(r2c(jnp.asarray(padded))))[:, :t]
    want_ac[:, -HALO:] = 0.0
    for sh in ac.addressable_shards:
        got = np.asarray(sh.data)
        rows = sh.index[0]
        cols = sh.index[1]
        np.testing.assert_allclose(got, want_ac[rows, cols], atol=1e-4,
                                   rtol=1e-3)

    print(f"SMOKE OK process {info['process_index']}/"
          f"{info['process_count']} mesh dp={mesh.shape['dp']} sp=2",
          flush=True)


if __name__ == "__main__":
    main()
