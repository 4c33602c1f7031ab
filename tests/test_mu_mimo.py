"""Closed-loop MU-MIMO sounding: NDP -> feedback -> ZF Q -> MU TX -> decode.

In-memory re-creation of the reference cmu_v3 demo (SURVEY.md §3.3):
an AP with 2 TX antennas sounds two 1-antenna STAs with a VHT NDP, each STA
estimates the channel from the VHT-LTFs, the AP computes per-tone SVD
feedback, a ZF spatial mapping Q, and sends a 2-user MU PPDU; each STA must
recover exactly its own MPDU.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.mu import (compress_v, map_q_to_grid, ndp_ltf_channel,
                              recover_v, vht_channel_feedback, zf_q)
from ieee80211_phy.mu.sounding import sta_capture_ndp, sta_decode_mu
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.tx import finalize, gen_ampdu, gen_ampdu_mu

MAC_CFG_QOS = MacConfig(ftype=2, subtype=8, to_ds=1, from_ds=0, retry=0,
                        protected=0, addr1="f4:69:d5:80:0f:a0",
                        addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                        seq=2704)


def _channel():
    """A fixed, well-conditioned flat 2x2 channel (rows = STA antennas)."""
    rng = np.random.default_rng(42)
    h = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    h += 2.0 * np.eye(2)
    return h


def _apply(h_row, wave2, noise=1e-4, seed=0):
    rng = np.random.default_rng(seed)
    y = h_row @ wave2
    y += (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)
          ) * noise
    return y.astype(np.complex64)


def _sound(h, use_compression: bool):
    """Run NDP sounding and return the per-tone Q grid [64, 2, 2]."""
    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2))
    cap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                   gap_len=1200)
    v_users = []
    for u in range(2):
        rx = _apply(h[u], cap, seed=u)
        nc = sta_capture_ndp(rx, n_sts=2)
        assert nc is not None, f"STA{u} failed to capture NDP"
        ltf_sym = ndp_ltf_channel(nc.ltf_iq, n_sts=2)
        v = vht_channel_feedback(ltf_sym, BW.BW20, n_sts=2, n_rx=1)
        if use_compression:
            v = np.stack([recover_v(2, 1, compress_v(vk)[0]) for vk in v])
        v_users.append(v)
    q56 = zf_q(v_users)
    return map_q_to_grid(q56)


@pytest.mark.parametrize("compressed", [False, True])
def test_mu_mimo_closed_loop(compressed):
    h = _channel()
    q = _sound(h, compressed)

    mpdu0 = build_udp_mpdu(b"1234567 packet for station 000", MAC_CFG_QOS)
    mpdu1 = build_udp_mpdu(b"7654321 packet for station 111", MAC_CFG_QOS)
    a0 = aggregate_vht([mpdu0])
    a1 = aggregate_vht([mpdu1])
    tx = gen_ampdu_mu([a0, a1],
                      [Mod(F.VHT, 0, BW.BW20, 1), Mod(F.VHT, 0, BW.BW20, 1)],
                      bfq=q, group_id=2)
    cap = finalize(tx.waveform, multiplier=0.3, cfo_hz=-3000.0, gap=True,
                   gap_len=1200)

    for u, want in ((0, mpdu0), (1, mpdu1)):
        rx = _apply(h[u], cap, seed=10 + u)
        res = sta_decode_mu(rx, mupos=u)
        assert len(res) == 1, f"STA{u} decoded {len(res)} packets"
        assert res[0].fcs_ok
        assert res[0].mpdus[0] == want


def test_mu_mimo_4user_closed_loop():
    """4-user MU-MIMO sounding loop: a 4-antenna AP sounds four 1-antenna
    STAs, computes a 4x4 ZF Q and sends a 4-user MU PPDU with per-user
    MCS; every STA recovers exactly its own MPDU (reference genAmpduMu
    supports <=4 users, tools/phy80211.py:183)."""
    rng = np.random.default_rng(77)
    h = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    h += 2.5 * np.eye(4)               # well-conditioned

    # sounding: 4-stream NDP
    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 4))
    cap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                   gap_len=1200)
    v_users = []
    for u in range(4):
        rx = _apply(h[u], cap, seed=u)
        nc = sta_capture_ndp(rx, n_sts=4)
        assert nc is not None, f"STA{u} failed to capture the 4-STS NDP"
        ltf_sym = ndp_ltf_channel(nc.ltf_iq, n_sts=4)
        v_users.append(vht_channel_feedback(ltf_sym, BW.BW20, n_sts=4,
                                            n_rx=1))
    q = map_q_to_grid(zf_q(v_users))

    payloads = [build_udp_mpdu(f"packet for STA {u} {'x' * (10 + 7 * u)}"
                               .encode(), MAC_CFG_QOS) for u in range(4)]
    ampdus = [aggregate_vht([p]) for p in payloads]
    mcss = [0, 1, 2, 0]                # per-user MCS
    tx = gen_ampdu_mu(ampdus, [Mod(F.VHT, m, BW.BW20, 1) for m in mcss],
                      bfq=q, group_id=5)
    cap = finalize(tx.waveform, multiplier=0.3, cfo_hz=-3000.0, gap=True,
                   gap_len=1200)

    for u in range(4):
        rx = _apply(h[u], cap, seed=20 + u)
        res = sta_decode_mu(rx, mupos=u)
        assert len(res) == 1, f"STA{u} decoded {len(res)} packets"
        assert res[0].fcs_ok and res[0].mcs == mcss[u]
        assert res[0].mpdus[0] == payloads[u], f"STA{u} wrong MPDU"


def test_feedback_matches_reference():
    """SVD feedback numerically equal to the reference implementation."""
    import sys
    sys.path.insert(0, "/root/reference/tools")
    import contextlib, io, os
    if not os.path.isdir("/root/reference/tools"):
        pytest.skip("no reference")
    os.environ.setdefault("MPLBACKEND", "Agg")
    with contextlib.redirect_stdout(io.StringIO()):
        import phy80211header as p8h
    rng = np.random.default_rng(3)
    ltf_sym = rng.standard_normal((2, 52)) + 1j * rng.standard_normal((2, 52))
    with contextlib.redirect_stdout(io.StringIO()):
        ref = p8h.procVhtChannelFeedback([list(ltf_sym[0]), list(ltf_sym[1])],
                                         p8h.BW.BW20, 2, 1)
    mine = vht_channel_feedback(ltf_sym, BW.BW20, n_sts=2, n_rx=1)
    np.testing.assert_allclose(mine, np.asarray(ref), atol=1e-9)


def test_compress_recover_roundtrip():
    rng = np.random.default_rng(5)
    for _ in range(8):
        a = rng.standard_normal((2, 1)) + 1j * rng.standard_normal((2, 1))
        v, _, _ = np.linalg.svd(a, full_matrices=False)[0], None, None
        v = np.linalg.svd(a, full_matrices=False)[0][:, :1]
        angles, kinds = compress_v(v, codebook=1)
        vr = recover_v(2, 1, angles, codebook=1)
        # recovered V equals V up to the per-row phase removed by Dt
        ratio = v[:, 0] / vr[:, 0]
        mags = np.abs(ratio)
        np.testing.assert_allclose(np.abs(v), np.abs(vr), atol=0.02)


def test_bf_report_roundtrip():
    """Compressed BF action frame: build -> parse -> V recovered."""
    from ieee80211_phy.mac.bf_report import (build_vht_compressed_bf_action,
                                             parse_vht_compressed_bf_action)
    rng = np.random.default_rng(9)
    h = rng.standard_normal((56, 1, 2)) + 1j * rng.standard_normal((56, 1, 2))
    v = np.stack([np.linalg.svd(hk, full_matrices=False)[2].conj().T * -1
                  for hk in h])          # [56, 2, 1]
    body = build_vht_compressed_bf_action(v, [20.0], group=1, codebook=1,
                                          token=23)
    vr, info = parse_vht_compressed_bf_action(body)
    assert info["nr"] == 2 and info["nc"] == 1 and info["token"] == 23
    assert vr.shape == (52, 2, 1)
    # compare on the feedback tones, up to the column phase removed by Dt
    occ = [k for k in range(-28, 29) if k != 0]
    for i, k in enumerate(info["sc_idx"]):
        vk = v[occ.index(k)][:, 0]
        rk = vr[i][:, 0]
        phase = vk[-1] / abs(vk[-1])
        np.testing.assert_allclose(np.abs(np.vdot(vk / phase, rk)), 1.0,
                                   atol=0.03)


def test_ndp_report_via_unified_receiver():
    """The unified SisoReceiver surfaces NDP channel captures directly
    (decode_capture_full), like the reference RX chain emitting the
    type-20 blob (lib/decode_impl.cc:100-121) — no separate NDP entry
    point needed. The LTF windows must match sta_capture_ndp's."""
    from ieee80211_phy.rx import SisoReceiver

    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2))
    rng = np.random.default_rng(11)
    h = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    cap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                   gap_len=600)
    rx1 = (h @ cap).astype(np.complex64)
    pkts, ndps = SisoReceiver().decode_capture_full(rx1)
    assert pkts == [] and len(ndps) == 1
    legacy = sta_capture_ndp(rx1, n_sts=2)
    assert legacy is not None
    assert np.allclose(ndps[0].ltf_iq, legacy.ltf_iq, atol=1e-5)
    # and the channel estimate from it is usable
    ltf_sym = ndp_ltf_channel(ndps[0].ltf_iq, n_sts=2)
    assert ltf_sym.shape[0] == 2 and ltf_sym.shape[-1] >= 52
