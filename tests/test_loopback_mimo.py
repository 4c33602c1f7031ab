"""2x2 SU-MIMO loopback: golden TX -> MIMO RX, bit-exact MPDUs.

SURVEY.md §7 step 5: dual-LTF channel estimation, 2x2 Gram-inverse ZF,
stream deparser — through an identity and a random mixing channel.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.rx.mimo import MimoReceiver
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


def _mix(wave: np.ndarray, seed: int = 0) -> np.ndarray:
    """Apply a random well-conditioned flat 2x2 channel + small noise."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))
    h = h + 2.5 * np.eye(2)              # keep it invertible
    out = h @ wave
    out += (rng.standard_normal(out.shape)
            + 1j * rng.standard_normal(out.shape)) * 1e-4
    return out


@pytest.mark.parametrize("mcs,mix", [(8, False), (8, True), (15, True)])
def test_ht_2x2_loopback(mcs, mix):
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG)
    tx = gen_mpdu(mpdu, Mod(F.HT, mcs, BW.BW20, 2))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=9000.0, num=1,
                   gap=True, gap_len=1200)
    if mix:
        cap = _mix(cap)
    res = MimoReceiver().decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.HT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu


@pytest.mark.parametrize("mcs,mix", [(0, True), (7, True), (8, True)])
def test_vht_2x2_loopback(mcs, mix):
    mpdu = build_udp_mpdu(PAYLOAD, MAC_CFG_QOS)
    ampdu = aggregate_vht([mpdu])
    tx = gen_ampdu(ampdu, Mod(F.VHT, mcs, BW.BW20, 2))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=-7000.0, num=1,
                   gap=True, gap_len=1200)
    if mix:
        cap = _mix(cap, seed=mcs)
    res = MimoReceiver().decode_capture(cap)
    assert len(res) == 1
    assert res[0].fmt == F.VHT and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu
