#!/usr/bin/env python
"""Inspect/decode a capture bin (analog of tools/drawGrBin.py +
tools/pktRxExample.py __main__): prints triggers and decoded packets."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ieee80211_phy.ops.sync import find_triggers_np
from ieee80211_phy.rx import SisoReceiver
from ieee80211_phy.utils import load_complex_bin


def main(path, fs_hz=20e6):
    cap = load_complex_bin(path)
    print(f"{path}: {len(cap)} samples @ {fs_hz/1e6:.0f} MHz, "
          f"peak {np.abs(cap).max():.3f}")
    rx = SisoReceiver(sample_rate_hz=fs_hz)
    t0s = find_triggers_np(cap, q=rx.q)
    print(f"triggers at {list(t0s)}")
    for r in rx.decode_capture(cap):
        print(f"  {r.fmt.name} mcs{r.mcs} fcs_ok={r.fcs_ok} "
              f"cfo={r.cfo_hz:.0f}Hz evm_snr={r.evm_snr_db:.1f}dB "
              f"mpdus={[len(m) for m in r.mpdus]}")
    print("stats:", rx.stats.summary())


if __name__ == "__main__":
    from ieee80211_phy.utils.runtime import enable_compile_cache
    enable_compile_cache()
    main(sys.argv[1] if len(sys.argv) > 1
         else "/root/reference/tools/sig80211GenMultipleSiso_1x1_0.bin")
