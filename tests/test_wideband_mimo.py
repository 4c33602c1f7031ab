"""2x2 SU-MIMO RX at 40/80 MHz: golden TX -> MimoReceiver at the matching
rate, bit-exact through a random mixing channel.

BEYOND the reference envelope twice over: its RX rejects 40 MHz
(signalCheckHt, /root/reference/lib/cloud80211phy.cc:744-748) and its
2x2 chain (demod2) is 20 MHz-only; here the same wideband geometry that
carries SISO 40/80 MHz (tests/test_wideband_rx.py) also carries the
P-matrix MIMO channel estimate, ZF equalizer and stream deparser.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.rx.mimo import MimoReceiver
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)
CFG_QOS = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
PAYLOAD = b"wideband 2x2 MIMO beyond the reference envelope!"
Q = {BW.BW20: 1, BW.BW40: 2, BW.BW80: 4}


def _mix(wave: np.ndarray, seed: int = 0, namp: float = 1e-5) -> np.ndarray:
    """Random 2x2 mixing + AWGN.

    namp is per time-domain sample; the per-TONE SNR this buys falls with
    bandwidth (fixed total signal power spread over 2x/4x the tones while
    the FFT accumulates the same noise density). At namp=1e-4 the dense
    wideband constellations (64/256-QAM at 40/80 MHz) sit BELOW the 2x2
    channel capacity of the harsher seeds (e.g. seed 15: cond(H)=11.1,
    ~22 dB/tone, capacity ~8 bits/tone < the 10 needed by HT MCS15) — no
    receiver can pass. namp=1e-5 keeps every config feasible; the
    max-log ML detector (ops/demod.ml_detect_llr_2x2) then decodes all of
    them, including cond-11 channels whose ZF noise enhancement would
    still fail (see test_ml_beats_zf_on_hard_channel)."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))
    h = h + 2.5 * np.eye(2)
    out = h @ wave
    out += (rng.standard_normal(out.shape)
            + 1j * rng.standard_normal(out.shape)) * namp
    return out


@pytest.mark.parametrize("mcs,bw", [(8, BW.BW40), (12, BW.BW40),
                                    (15, BW.BW40)])
def test_ht_2x2_wideband(mcs, bw):
    q = Q[bw]
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    tx = gen_mpdu(mpdu, Mod(F.HT, mcs, bw, 2))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=9000.0 * q, num=1,
                   gap=True, gap_len=400 * q)
    cap = _mix(cap, seed=mcs)
    res = MimoReceiver(sample_rate_hz=20e6 * q).decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.HT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu


def test_ml_beats_zf_on_hard_channel():
    """Max-log ML detection decodes where the reference's ZF cannot.

    Seed-15's cond-11 mixing channel at namp=4e-5: the ZF Gram-inverse
    equalizer (reference parity, lib/demod2_impl.cc:410-428) loses
    ~20*log10(cond) = 21 dB to noise enhancement and fails the FCS on
    64-QAM r5/6; exact max-log ML (ops/demod.ml_detect_llr_2x2) decodes
    bit-exact. This is the capability that makes the wideband matrix above
    channel-robust, not just high-SNR."""
    import jax.numpy as jnp

    from ieee80211_phy.ops import sync
    from ieee80211_phy.rx.mimo import MimoDataDecoder
    from ieee80211_phy.specs.modulation import ppdu_params_nonaggregate

    q = 2
    mpdu = build_udp_mpdu(PAYLOAD * 4, CFG)
    psdu_bits = np.unpackbits(np.frombuffer(mpdu, np.uint8),
                              bitorder="little")
    exp = np.concatenate([np.zeros(16, np.uint8), psdu_bits])
    mod = Mod(F.HT, 15, BW.BW40, 2)
    tx = gen_mpdu(mpdu, mod)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    mrng = np.random.default_rng(15)
    hm = (mrng.standard_normal((2, 2))
          + 1j * mrng.standard_normal((2, 2))) + 2.5 * np.eye(2)
    assert np.linalg.cond(hm) > 10
    errs = {}
    for det in ("ml", "zf"):
        cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=9000.0 * q,
                       num=1, gap=True, gap_len=400 * q)
        nrng = np.random.default_rng(7777)
        cap = hm @ cap
        cap += (nrng.standard_normal(cap.shape)
                + 1j * nrng.standard_normal(cap.shape)) * 4e-5
        cap = cap.astype(np.complex64)
        t = int(sync.find_triggers_np(cap[0], q=q)[0])
        need = 500 + (448 + 160 + 160 + pp.n_sym * 80) * q + 100
        w = np.zeros((1, 2, need, 2), np.float32)
        seg = cap[:, t:t + need]
        w[0, :, :seg.shape[1], 0] = seg.real
        w[0, :, :seg.shape[1], 1] = seg.imag
        ls, cfo, _ = sync.sync_front_iq(jnp.asarray(w[:, 0]),
                                        jnp.zeros(1, jnp.int32), q=q)
        bits, _ = MimoDataDecoder(mod, pp.n_sym, detector=det).decode(
            jnp.asarray(w), ls, cfo)
        errs[det] = int(np.sum(np.asarray(bits)[0, :len(exp)] != exp))
    assert errs["ml"] == 0, f"ML should be bit-exact, got {errs['ml']} errors"
    assert errs["zf"] > 0, "ZF unexpectedly decoded the hard channel"


@pytest.mark.parametrize("mcs,bw", [(0, BW.BW40), (5, BW.BW40),
                                    (9, BW.BW40), (0, BW.BW80),
                                    (7, BW.BW80), (9, BW.BW80)])
def test_vht_2x2_wideband(mcs, bw):
    q = Q[bw]
    mpdu = build_udp_mpdu(PAYLOAD, CFG_QOS)
    tx = gen_ampdu(aggregate_vht([mpdu]), Mod(F.VHT, mcs, bw, 2))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=-7000.0 * q, num=1,
                   gap=True, gap_len=400 * q)
    cap = _mix(cap, seed=10 * mcs + q)
    res = MimoReceiver(sample_rate_hz=20e6 * q).decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.VHT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu


@pytest.mark.parametrize("mcs,bw", [(4, BW.BW40), (9, BW.BW40),
                                    (7, BW.BW80), (9, BW.BW80)])
def test_siso_mrc_wideband_dual_chain(mcs, bw):
    """SISO VHT at 40/80 MHz arriving on the DUAL-chain receiver decodes
    via MRC combining — the universal-receiver envelope at wideband rates
    (the reference's 2-chain RX is 20 MHz-only AND chain-0-only for SISO,
    lib/demod2_impl.cc:213-276)."""
    q = Q[bw]
    mpdu = build_udp_mpdu(PAYLOAD, CFG_QOS)
    tx = gen_ampdu(aggregate_vht([mpdu]), Mod(F.VHT, mcs, bw, 1))
    wave = finalize(tx.waveform, multiplier=0.2, cfo_hz=7000.0 * q, num=1,
                    gap=True, gap_len=400 * q)[0]
    rng = np.random.default_rng(mcs + 3)
    h = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    h /= np.abs(h).max()
    cap = np.stack([h[0] * wave, h[1] * wave])
    cap += (rng.standard_normal(cap.shape)
            + 1j * rng.standard_normal(cap.shape)) * 1e-5
    res = MimoReceiver(sample_rate_hz=20e6 * q).decode_capture(
        cap.astype(np.complex64))
    assert len(res) == 1
    assert res[0].fmt == F.VHT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu
    assert res[0].sigb_ok is True
