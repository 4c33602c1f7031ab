"""Native C++ runtime equals the Python reference implementations."""
import zlib

import numpy as np
import pytest

from ieee80211_phy import native
from ieee80211_phy.mac import (MacConfig, aggregate_ht, aggregate_vht,
                               build_udp_mpdu, deaggregate_vht)

CFG = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                seq=2704)


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def test_crc32():
    rng = np.random.default_rng(0)
    for n in (1, 7, 100, 4096):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert native.crc32(data) == (zlib.crc32(data) & 0xFFFFFFFF)


def test_pack_bits():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 256).astype(np.uint8)
    assert native.pack_bits(bits) == np.packbits(
        bits, bitorder="little").tobytes()


def test_find_triggers_matches_python():
    """Native trigger scan finds the same packet starts on a real capture."""
    from ieee80211_phy.ops import sync
    from ieee80211_phy.specs import F, Mod
    from ieee80211_phy.tx import finalize, gen_mpdu
    mpdu = build_udp_mpdu(b"0123456789" * 3, CFG)
    w = gen_mpdu(mpdu, Mod(F.L, 0)).waveform
    cap = np.concatenate([
        finalize(w, multiplier=0.2, gap=True, gap_len=1200)[0]
        for _ in range(3)]).astype(np.complex64)
    got = native.find_triggers(cap)
    # python fallback path (bypass native)
    import importlib
    prod = cap[:-16] * np.conj(cap[16:])
    kern = np.ones(16)
    num = np.abs(np.convolve(prod, kern, mode="valid"))
    p1 = np.convolve(np.abs(cap[:-16]) ** 2, kern, mode="valid")
    p2 = np.convolve(np.abs(cap[16:]) ** 2, kern, mode="valid")
    ac = num / (np.sqrt(p1 * p2) + 1e-12)
    assert len(got) == 3
    for t in got:
        assert np.all(ac[t:t + 20] > 0.4)


def test_deagg_matches_python():
    frames = [build_udp_mpdu(bytes([i]) * (25 + 3 * i), CFG)
              for i in range(3)]
    psdu = aggregate_vht(frames)
    subs_py = deaggregate_vht(psdu)
    subs_c = native.deagg(psdu, vht=True)
    assert len(subs_c) == len(subs_py) == 3
    for (off, ln, ok), py in zip(subs_c, subs_py):
        assert psdu[off:off + ln] == py.mpdu
        assert ok == py.fcs_ok
    # HT variant
    psdu = aggregate_ht(frames)
    subs_c = native.deagg(psdu, vht=False)
    assert len(subs_c) == 3
    assert all(ok for _, _, ok in subs_c)
