"""End-to-end SISO loopback: golden TX -> batched JAX RX, bit-exact MPDUs.

SURVEY.md §7 step 3 (minimum end-to-end slice) + step 5 (format generality):
L / HT / VHT packets with CFO and gaps are recovered bit-exactly through
trigger, sync, SIG parse, demod, Viterbi, descramble and FCS/A-MPDU checks.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.rx import SisoReceiver
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu

MAC_CFG = MacConfig(ftype=2, subtype=0, to_ds=1, from_ds=0, retry=0,
                    protected=0, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
MAC_CFG_QOS = MacConfig(ftype=2, subtype=8, to_ds=1, from_ds=0, retry=0,
                        protected=0, addr1="f4:69:d5:80:0f:a0",
                        addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                        seq=2704)
PAYLOAD = b"123456789012345678901234567890"


@pytest.mark.parametrize("mcs,cfo", [(0, 0.0), (7, 232111.0)])
def test_legacy_loopback(mcs, cfo):
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG)
    tx = gen_mpdu(mpdu, Mod(F.L, mcs))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=cfo, num=1,
                   gap=True, gap_len=1200)[0]
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.L and res[0].mcs == mcs
    assert res[0].fcs_ok
    assert res[0].mpdus[0] == mpdu
    if cfo:
        assert abs(res[0].cfo_hz - cfo) < 3000


@pytest.mark.parametrize("mcs", [0, 7])
def test_ht_loopback(mcs):
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG)
    tx = gen_mpdu(mpdu, Mod(F.HT, mcs))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=11000.0, num=1,
                   gap=True, gap_len=1200)[0]
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.HT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu


@pytest.mark.parametrize("mcs", [0, 8])
def test_vht_loopback_ampdu(mcs):
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG_QOS)
    ampdu = aggregate_vht([mpdu])
    tx = gen_ampdu(ampdu, Mod(F.VHT, mcs))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=-21000.0, num=1,
                   gap=True, gap_len=1200)[0]
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.VHT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu


def test_multi_packet_capture():
    """Several formats back-to-back in one capture (reference
    pktGenExample-style multi-signal bin)."""
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG)
    mpdu_q = build_udp_mpdu(PAYLOAD, MAC_CFG_QOS)
    parts = [
        finalize(gen_mpdu(mpdu, Mod(F.L, 7)).waveform, 0.2, 232111.0,
                 gap_len=1200),
        finalize(gen_mpdu(mpdu, Mod(F.HT, 7)).waveform, 0.2, 212233.0,
                 gap_len=1200),
        finalize(gen_ampdu(aggregate_vht([mpdu_q]), Mod(F.VHT, 7)).waveform,
                 0.2, 21223.0, gap_len=1200),
    ]
    cap = np.concatenate([p[0] for p in parts])
    res = SisoReceiver().decode_capture(cap)
    assert [r.fmt for r in res] == [F.L, F.HT, F.VHT]
    assert all(r.fcs_ok for r in res)
    assert res[0].mpdus[0] == mpdu
    assert res[1].mpdus[0] == mpdu
    assert res[2].mpdus[0] == mpdu_q


def test_stats_and_evm_snr():
    """Decode counters and per-packet EVM SNR (sssnr analog)."""
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG)
    tx = gen_mpdu(mpdu, Mod(F.L, 7))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=0.0, num=1,
                   gap=True, gap_len=1200)[0]
    rx = SisoReceiver()
    res = rx.decode_capture(cap)
    assert res[0].evm_snr_db > 25.0      # clean loopback: high SNR
    s = rx.stats.summary()
    assert s["triggers"] >= 1 and s["fcs_ok"] == 1
    assert s["per_mcs_ok"].get("L7") == 1


def test_ht_ampdu_loopback():
    """HT A-MPDU (multiple subframes) through the auto receiver — the path
    the reference leaves 'to be added' (lib/decode_impl.cc:432-435)."""
    from ieee80211_phy.mac import aggregate_ht
    from ieee80211_phy.tx import gen_ampdu
    frames = [build_udp_mpdu(bytes([i]) * (25 + i), MAC_CFG_QOS)
              for i in range(3)]
    ampdu = aggregate_ht(frames)
    tx = gen_ampdu(ampdu, Mod(F.HT, 4))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=5000.0, num=1,
                   gap=True, gap_len=1200)[0]
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1 and res[0].fcs_ok
    assert res[0].mpdus == frames
