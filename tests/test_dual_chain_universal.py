"""Universal 2-chain receiver: one dual-antenna capture mixing legacy,
SISO HT/VHT, 2x2 MIMO and a VHT NDP — everything decodes.

The reference's 2-chain RX covers this envelope but decodes legacy/SISO
from chain 0 only (/root/reference/lib/demod2_impl.cc:213-276
DEMOD_S_LEGACY, legacyChanUpdate :761) and emits the NDP type-20 channel
blob through the same path (/root/reference/lib/decode_impl.cc:100-121).
Here SISO packets get MRC combining across both chains — including when
chain 0 is in a deep fade, which the reference path cannot survive.
"""
import numpy as np
import pytest

from ieee80211_phy.api.service import PhyService
from ieee80211_phy.api import descriptors as d
from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.rx.mimo import MimoReceiver
from ieee80211_phy.specs import BW, F, GRF, Mod
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu

MAC_CFG = MacConfig(ftype=2, subtype=0, to_ds=1, from_ds=0, retry=0,
                    protected=0, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
MAC_CFG_QOS = MacConfig(ftype=2, subtype=8, to_ds=1, from_ds=0, retry=0,
                        protected=0, addr1="f4:69:d5:80:0f:a0",
                        addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                        seq=2704)


def _siso_on_two_chains(wave, h0, h1, rng, noise=2e-4):
    out = np.stack([h0 * wave, h1 * wave])
    out += (rng.standard_normal(out.shape)
            + 1j * rng.standard_normal(out.shape)) * noise
    return out.astype(np.complex64)


def _mixed_capture(dead_chain0=False, noise=2e-4):
    """Build the mixed dual-chain capture + expected MPDUs."""
    rng = np.random.default_rng(11)
    mpdu_l = build_udp_mpdu(b"legacy-payload-0123456789", MAC_CFG)
    mpdu_ht = build_udp_mpdu(b"ht-siso-payload-xyz", MAC_CFG)
    mpdu_vht = build_udp_mpdu(b"vht-siso-payload-abcdef", MAC_CFG_QOS)
    mpdu_2x2 = build_udp_mpdu(b"two-stream-payload-2x2!!", MAC_CFG_QOS)

    w_l = finalize(gen_mpdu(mpdu_l, Mod(F.L, 3)).waveform,
                   multiplier=0.2, cfo_hz=11000.0, gap=False)[0]
    w_ht = finalize(gen_mpdu(mpdu_ht, Mod(F.HT, 5)).waveform,
                    multiplier=0.2, cfo_hz=-8000.0, gap=False)[0]
    w_vht = finalize(gen_ampdu(aggregate_vht([mpdu_vht]),
                               Mod(F.VHT, 7)).waveform,
                     multiplier=0.2, cfo_hz=5000.0, gap=False)[0]
    w_22 = finalize(gen_ampdu(aggregate_vht([mpdu_2x2]),
                              Mod(F.VHT, 4, BW.BW20, 2)).waveform,
                    multiplier=0.2, cfo_hz=-3000.0, gap=False)
    w_ndp = finalize(gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform,
                     multiplier=0.2, cfo_hz=2000.0, gap=False)

    # per-packet flat channels (distinct per chain)
    h0 = 1e-3 if dead_chain0 else (0.9 - 0.3j)
    parts = []
    gap = np.zeros((2, 900), np.complex64)
    for w in (w_l, w_ht, w_vht):
        parts += [gap, _siso_on_two_chains(w, h0, 0.5 + 0.8j, rng,
                                           noise=noise)]
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j], [-0.4 + 0.6j, 0.9 + 0.1j]])
    mixed = (h22 @ w_22).astype(np.complex64)
    mixed += (rng.standard_normal(mixed.shape)
              + 1j * rng.standard_normal(mixed.shape)).astype(
                  np.complex64) * 2e-4
    parts += [gap, mixed]
    ndp2 = (h22 @ w_ndp).astype(np.complex64)
    parts += [gap, ndp2, gap]
    cap = np.concatenate(parts, axis=1)
    want = {(F.L, 3): mpdu_l, (F.HT, 5): mpdu_ht,
            (F.VHT, 7): mpdu_vht, (F.VHT, 4): mpdu_2x2}
    return cap, want


def test_mixed_dual_chain_capture_decodes_everything():
    cap, want = _mixed_capture()
    rx = MimoReceiver()
    pkts, ndps = rx.decode_capture_full(cap)
    got = {(r.fmt, r.mcs): r for r in pkts if r.fcs_ok}
    assert set(got) == set(want), f"decoded {set(got)}"
    for key, mpdu in want.items():
        assert got[key].mpdus[0] == mpdu
    # VHT-SIG-B CRC verified against the SERVICE field; per-stream sssnr
    assert got[(F.VHT, 7)].sigb_ok is True
    assert got[(F.VHT, 4)].sigb_ok is True       # 2x2, MRC-combined SIG-B
    assert got[(F.HT, 5)].sigb_ok is None        # no SIG-B outside VHT
    assert len(got[(F.VHT, 4)].sssnr) == 2       # sssnr0/sssnr1 (2 streams)
    assert all(s > 8.0 for s in got[(F.VHT, 4)].sssnr)
    assert len(got[(F.L, 3)].sssnr) == 1
    # one NDP, one channel capture per RX chain
    assert len(ndps) == 1 and len(ndps[0]) == 2
    for nd in ndps[0]:
        assert nd.ltf_iq.shape == (128,)
        assert np.all(np.isfinite(nd.ltf_iq))


def test_mrc_survives_dead_chain0():
    """SISO packets decode even when chain 0 is faded to nothing — the
    envelope the reference's chain-0-only legacy path cannot cover.
    (Noise halved vs the 2-chain test: one dead chain legitimately costs
    the 3 dB array gain, and VHT7's 64-QAM 5/6 sits right at the 2e-4
    operating point's margin.)"""
    cap, want = _mixed_capture(dead_chain0=True, noise=1e-4)
    pkts, _ = MimoReceiver().decode_capture_full(cap)
    got = {(r.fmt, r.mcs): r for r in pkts if r.fcs_ok}
    for key in [(F.L, 3), (F.HT, 5), (F.VHT, 7)]:
        assert key in got and got[key].mpdus[0] == want[key], \
            f"SISO {key} lost with dead chain 0"


def test_service_dual_chain_emits_channel_reports():
    cap, want = _mixed_capture()
    svc = PhyService()
    records = svc.rx_capture(cap)
    kinds = [d.unpack_rx_record(r) for r in records]
    reports = [k for k in kinds if isinstance(k, d.ChannelReport)]
    data = [k for k in kinds if isinstance(k, d.RxRecord)]
    assert len(reports) == 2          # one per RX chain
    assert len(data) == len(want)
    for rep in reports:
        assert rep.ltf_iq.shape == (128,)


def test_mimo_decode_captures_stream():
    """Pipelined dual-chain streaming (the rx2.grc real-time analog):
    a stream of captures through MimoReceiver.decode_captures matches
    per-capture decode_capture results, on both ingest paths."""
    cap, want = _mixed_capture()
    caps = [np.concatenate([np.zeros((2, 64 + 32 * k), np.complex64), cap],
                           axis=1) for k in range(3)]
    for ingest in ("f32", "int8"):
        rx = MimoReceiver(ingest=ingest)
        stream = rx.decode_captures(caps)
        assert len(stream) == 3
        for res in stream:
            got = {(r.fmt, r.mcs): r for r in res if r.fcs_ok}
            assert set(got) == set(want), (ingest, set(got))
            for key, mpdu in want.items():
                assert got[key].mpdus[0] == mpdu


def test_mimo_plan_batch_matches_plan_one():
    """The vectorized dual-chain planner returns exactly what the
    single-window reference implementation returns on a capture mixing
    every branch (L/HT-SISO/VHT-SISO/2x2/NDP)."""
    cap, _ = _mixed_capture()
    rx = MimoReceiver()
    t0s, cap_dev, scale, npad = rx._ingest(np.asarray(cap, np.complex64))
    meta = rx._parse_sigs(cap_dev, scale, npad, t0s)
    cap_len = cap.shape[1]
    plans_b, ndps_b = rx._plan_batch(cap_len, meta, len(t0s))
    plans_s, ndps_s = [], []
    for i in range(len(t0s)):
        p = rx._plan_one(cap_len, meta, i)
        if p is None:
            continue
        (ndps_s if p.ndp else plans_s).append((i, p))
    assert [i for i, _ in plans_b] == [i for i, _ in plans_s]
    for (_, pb), (_, ps) in zip(plans_b, plans_s):
        assert pb == ps, (pb, ps)
    assert len(ndps_b) == len(ndps_s)
    for pb, (_, ps) in zip(ndps_b, ndps_s):
        assert pb == ps


def test_stream_surfaces_ndps():
    """decode_captures_full emits NDP channel captures inline with the
    stream, for both the SISO and the dual-chain receiver."""
    from ieee80211_phy.rx import SisoReceiver
    cap, want = _mixed_capture()
    caps2 = [cap, cap]
    stream, ndps = MimoReceiver().decode_captures_full(caps2)
    assert len(stream) == 2 and len(ndps) == 2
    for res, nd in zip(stream, ndps):
        assert sum(1 for r in res if r.fcs_ok) == len(want)
        assert len(nd) == 1 and len(nd[0]) == 2   # one NDP, 2 chains
    # SISO stream: plant an NDP between data packets on one chain
    from ieee80211_phy.tx import finalize, gen_ampdu
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    mpdu = build_udp_mpdu(b"data-around-the-ndp", MAC_CFG_QOS)
    w_d = finalize(gen_ampdu(aggregate_vht([mpdu]),
                             Mod(F.VHT, 5)).waveform,
                   multiplier=0.2, cfo_hz=4e3, gap=True, gap_len=800)[0]
    w_n = finalize(gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform,
                   multiplier=0.2, cfo_hz=2e3, gap=True, gap_len=800)[0]
    c1 = np.concatenate([w_d, w_n, w_d]).astype(np.complex64)
    stream, ndps = SisoReceiver().decode_captures_full([c1, c1])
    for res, nd in zip(stream, ndps):
        assert sum(1 for r in res if r.fcs_ok) == 2
        assert len(nd) == 1 and nd[0].ltf_iq.shape == (128,)


def test_dual_chain_ndp_feeds_2rx_feedback():
    """Both chains' NDP captures stack into a [nSD, nSTS, nRx=2] feedback
    matrix (beyond-reference: the reference STA is single-antenna)."""
    from ieee80211_phy.mu.feedback import ndp_ltf_channel, \
        vht_channel_feedback
    cap, _ = _mixed_capture()
    _, ndps = MimoReceiver().decode_capture_full(cap)
    syms = np.concatenate([ndp_ltf_channel(nd.ltf_iq, n_sts=2)
                           for nd in ndps[0]], axis=0)   # [nRx*nLtf, nSD]
    v = vht_channel_feedback(syms, BW.BW20, n_sts=2, n_rx=2)
    assert v.shape == (56, 2, 2)
    assert np.all(np.isfinite(v))
