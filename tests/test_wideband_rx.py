"""40/80 MHz RX loopback: golden TX -> SisoReceiver at the matching rate.

BEYOND the reference envelope: the reference RX rejects 40 MHz outright
(signalCheckHt, /root/reference/lib/cloud80211phy.cc:744-748) and its golden
RX is 20 MHz-only; only its TX tables cover 40/80 MHz
(tools/phy80211header.py:250-434). Here the same receiver architecture
decodes 40/80 MHz HT/VHT SISO packets bit-exactly: wide legacy-band SIG
fields are equal-gain combined across the duplicated 20 MHz subbands, and
all preamble geometry scales with the oversample factor q.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.rx import SisoReceiver
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=7)
PAYLOAD = b"wideband RX beyond the reference envelope " * 2
Q = {BW.BW20: 1, BW.BW40: 2, BW.BW80: 4}


def _capture(mod: Mod, mpdu: bytes, seed: int, snr_db: float = 30.0):
    if mod.fmt == F.VHT:
        wave = gen_ampdu(aggregate_vht([mpdu]), mod).waveform[0]
    else:
        wave = gen_mpdu(mpdu, mod).waveform[0]
    q = Q[mod.bw]
    cap = finalize(wave[None], multiplier=0.18, cfo_hz=7000.0 * q,
                   gap=True, gap_len=256 * q)[0].astype(np.complex64)
    rng = np.random.default_rng(seed)
    rms = np.sqrt(np.mean(np.abs(cap[cap != 0]) ** 2))
    sigma = rms / (10 ** (snr_db / 20)) / np.sqrt(2)
    cap = cap + (rng.normal(0, sigma, len(cap))
                 + 1j * rng.normal(0, sigma, len(cap))).astype(np.complex64)
    return cap


@pytest.mark.parametrize("fmt,mcs,bw", [
    (F.VHT, 0, BW.BW40), (F.VHT, 4, BW.BW40), (F.VHT, 9, BW.BW40),
    (F.VHT, 0, BW.BW80), (F.VHT, 7, BW.BW80), (F.VHT, 9, BW.BW80),
    (F.HT, 0, BW.BW40), (F.HT, 3, BW.BW40), (F.HT, 7, BW.BW40),
])
def test_wideband_loopback_bitexact(fmt, mcs, bw):
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    mod = Mod(fmt, mcs, bw, 1)
    cap = _capture(mod, mpdu, seed=mcs + 10 * bw.value)
    rx = SisoReceiver(sample_rate_hz=20e6 * Q[bw])
    res = rx.decode_capture(cap)
    assert res, f"no decode for {fmt} mcs{mcs} {bw}"
    r = res[0]
    assert r.fcs_ok and r.fmt == fmt and r.mcs == mcs
    assert r.mpdus[0] == mpdu


def test_wideband_rejects_mismatched_rate():
    """A 40 MHz packet in a 20 MHz-rate capture context is rejected by the
    bw==capture-rate guard, not mis-decoded."""
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    mod = Mod(F.VHT, 4, BW.BW40, 1)
    cap = _capture(mod, mpdu, seed=1)
    # decode the 40 MHz capture with a receiver configured for 80 MHz:
    # triggers may fire, but no packet may be produced
    rx = SisoReceiver(sample_rate_hz=80e6)
    assert rx.decode_capture(cap) == []


def test_multi_packet_wideband_capture():
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    mod = Mod(F.VHT, 5, BW.BW40, 1)
    wave = gen_ampdu(aggregate_vht([mpdu]), mod).waveform[0]
    cap = finalize(wave[None], multiplier=0.18, cfo_hz=11000.0, gap=True,
                   gap_len=512, num=3)[0].astype(np.complex64)
    rx = SisoReceiver(sample_rate_hz=40e6)
    res = rx.decode_capture(cap)
    ok = [r for r in res if r.fcs_ok]
    assert len(ok) == 3
    assert all(r.mpdus[0] == mpdu for r in ok)


def test_wideband_rx_pipeline_jit():
    """The fixed-config jit RxPipeline (flagship graph) decodes 40/80 MHz."""
    import jax.numpy as jnp
    from ieee80211_phy.mac import deaggregate_vht
    from ieee80211_phy.models import RxPipeline
    from ieee80211_phy.specs.modulation import ppdu_params_aggregate
    from ieee80211_phy.utils import c2r
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    for bw in (BW.BW40, BW.BW80):
        q = Q[bw]
        mod = Mod(F.VHT, 7, bw, 1)
        ampdu = aggregate_vht([mpdu])
        pp = ppdu_params_aggregate(mod, len(ampdu))
        wave = finalize(gen_ampdu(ampdu, mod).waveform, multiplier=0.2,
                        cfo_hz=15000.0 * q, gap=True, gap_len=64 * q)[0]
        pipe = RxPipeline(mod, pp.n_sym, pp.psdu_len)
        w = pipe.window_len()
        seg = wave[(64 - 8) * q:]
        x = np.zeros((2, w), np.complex64)
        x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
        out = pipe.step(jnp.asarray(c2r(x)), jnp.zeros(2, jnp.int32))
        bits = np.asarray(out["bits"][1]).astype(np.uint8)
        psdu = np.packbits(bits[16:16 + pp.psdu_len * 8],
                           bitorder="little").tobytes()
        subs = deaggregate_vht(psdu)
        assert subs and subs[0].fcs_ok and subs[0].mpdu == mpdu


@pytest.mark.parametrize("fmt,mcs,bw", [
    (F.VHT, 4, BW.BW40), (F.VHT, 9, BW.BW40),
    (F.HT, 11, BW.BW40),
    (F.VHT, 7, BW.BW80),   # nES=2: per-encoder Viterbi lanes
    (F.VHT, 9, BW.BW80),
])
def test_wideband_mimo_2x2_loopback(fmt, mcs, bw):
    """2x2 SU-MIMO at 40/80 MHz through a random mixing channel — also
    beyond the reference envelope (its MIMO RX is 20 MHz-only), including
    nES=2 configs the reference's stream parser never reaches."""
    from ieee80211_phy.rx.mimo import MimoReceiver
    from ieee80211_phy.tx import gen_mpdu
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    mod = Mod(fmt, mcs, bw, 2)
    q = Q[bw]
    if fmt == F.VHT:
        wave = gen_ampdu(aggregate_vht([mpdu]), mod).waveform
    else:
        wave = gen_mpdu(mpdu, mod).waveform
    rng = np.random.default_rng(mcs)
    h = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
         + 2.2 * np.eye(2))
    cap = finalize(wave, multiplier=0.2, cfo_hz=6000.0 * q, gap=True,
                   gap_len=300 * q)
    y = (h @ cap).astype(np.complex64)
    y += (rng.normal(0, 1e-5, y.shape)
          + 1j * rng.normal(0, 1e-5, y.shape)).astype(np.complex64)
    res = MimoReceiver(sample_rate_hz=20e6 * q).decode_capture(y)
    assert res and res[0].fcs_ok and res[0].mpdus[0] == mpdu
    assert res[0].fmt == fmt and res[0].mcs == mcs
