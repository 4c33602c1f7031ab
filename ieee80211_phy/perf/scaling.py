"""Multi-device scaling-efficiency harness.

Measures batched RX decode throughput over a (dp, sp) mesh at increasing
device counts and reports efficiency vs the single-device rate — the
framework's analog of the reference's multi-host USRP processes
(SURVEY.md §2.5) and the BASELINE north-star scaling metric (>=0.8 at
N>=2). On real devices this exercises the collectives (halo exchange +
reduction); under --xla_force_host_platform_device_count it smoke-tests the
same program on virtual devices.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel import make_phy_mesh, sharded_rx
from ..specs import F, Mod
from ..specs.modulation import ppdu_params_nonaggregate


def _packet_batch(batch: int):
    from ..mac import MacConfig, build_udp_mpdu
    from ..models import RxPipeline
    from ..tx import finalize, gen_mpdu
    from ..utils import c2r
    cfg = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
    mpdu = build_udp_mpdu(b"123456789012345678901234567890" * 4, cfg)
    mod = Mod(F.L, 7)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    pipe = RxPipeline(mod, pp.n_sym, pp.psdu_len)
    wave = finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                    cfo_hz=9000.0, gap=True, gap_len=64)[0]
    w = pipe.window_len()
    seg = wave[64 - 8:]
    x = np.zeros((batch, w), dtype=np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    return mod, pp, c2r(x), np.zeros(batch, dtype=np.int32)


def measure_scaling(device_counts: Optional[Sequence[int]] = None,
                    batch_per_device: int = 256, iters: int = 5
                    ) -> Dict[int, float]:
    """Returns {n_devices: samples/sec} for the sharded RX step."""
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= n_avail]
    mod, pp, x2_one, t0_one = _packet_batch(batch_per_device)
    out: Dict[int, float] = {}
    for n in device_counts:
        mesh = make_phy_mesh(n, sp=1)
        run = jax.jit(sharded_rx(mesh, mod, pp.n_sym))
        b = batch_per_device * n
        x2 = np.tile(x2_one, (n, 1, 1))
        t0 = np.tile(t0_one, n)
        xd = jax.device_put(x2)
        td = jax.device_put(t0)

        def scalar(x, t):
            o = run(x, t)
            return jnp.sum(o["bits"][:, :4]).astype(jnp.float32)

        f = jax.jit(scalar)
        np.asarray(f(xd, td))
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            np.asarray(f(xd, td))
            ts.append(time.perf_counter() - t)
        dt = float(np.median(ts))
        out[n] = b * x2_one.shape[1] / dt
    return out


def main():
    rates = measure_scaling()
    base = rates.get(1)
    eff = {n: (r / (base * n) if base else None) for n, r in rates.items()}
    print(json.dumps({"samples_per_sec": rates, "efficiency": eff}))


if __name__ == "__main__":
    main()
