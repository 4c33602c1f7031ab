"""Bit-exact loopback across the full supported MCS envelope.

BASELINE.md target: bit-exact decoded MPDUs vs the golden model across
MCS0-9, SISO and 2x2 — every (format, mcs, streams) combination the
reference GR-TRX RX envelope supports.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.rx import SisoReceiver
from ieee80211_phy.rx.mimo import MimoReceiver
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)
CFG_QOS = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
PAYLOAD = b"matrix-test-payload-0123456789abcdef"

SISO_CONFIGS = ([(F.L, m, 1) for m in range(8)]
                + [(F.HT, m, 1) for m in range(8)]
                + [(F.VHT, m, 1) for m in range(9)])
MIMO_CONFIGS = ([(F.HT, m, 2) for m in range(8, 16)]
                + [(F.VHT, m, 2) for m in list(range(9)) if True])


@pytest.mark.parametrize("fmt,mcs,nsts", SISO_CONFIGS)
def test_siso_mcs_matrix(fmt, mcs, nsts):
    if fmt == F.VHT:
        mpdu = build_udp_mpdu(PAYLOAD, CFG_QOS)
        tx = gen_ampdu(aggregate_vht([mpdu]), Mod(fmt, mcs))
    else:
        mpdu = build_udp_mpdu(PAYLOAD, CFG)
        tx = gen_mpdu(mpdu, Mod(fmt, mcs))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=7500.0 * (mcs - 4),
                   gap=True, gap_len=1200)[0]
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1 and res[0].fcs_ok and res[0].mcs == mcs
    assert res[0].mpdus[0] == mpdu


@pytest.mark.parametrize("fmt,mcs,nsts", MIMO_CONFIGS)
def test_mimo_mcs_matrix(fmt, mcs, nsts):
    rng = np.random.default_rng(mcs)
    # mild, well-conditioned mixing: ZF noise enhancement scales with
    # cond(H)^2, and the top rates (64-QAM 5/6) need ~25 dB post-equalizer
    # SNR — same physics as the reference RX (pure ZF, demod2_impl.cc:410).
    h = 0.4 * (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))
    h += 2.5 * np.eye(2)
    if fmt == F.VHT:
        mpdu = build_udp_mpdu(PAYLOAD, CFG_QOS)
        tx = gen_ampdu(aggregate_vht([mpdu]), Mod(fmt, mcs, BW.BW20, 2))
    else:
        mpdu = build_udp_mpdu(PAYLOAD, CFG)
        tx = gen_mpdu(mpdu, Mod(fmt, mcs, BW.BW20, 2))
    cap = h @ finalize(tx.waveform, multiplier=0.2, cfo_hz=4000.0,
                       gap=True, gap_len=1200)
    cap += (rng.standard_normal(cap.shape)
            + 1j * rng.standard_normal(cap.shape)) * 1e-4
    res = MimoReceiver().decode_capture(cap.astype(np.complex64))
    assert len(res) == 1 and res[0].fcs_ok and res[0].mcs == mcs
    assert res[0].mpdus[0] == mpdu
