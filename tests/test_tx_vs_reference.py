"""Sample-exact comparison of our golden TX against the reference PY-TB TX.

SURVEY.md §7 step 2: the numpy golden model must reproduce the reference
transmitter's waveforms numerically for every supported format.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.tx import gen_ampdu, gen_ampdu_mu, gen_mpdu

from reference_oracle import get_oracle, quiet

UDP_PAYLOAD = b"123456789012345678901234567890"

MAC_CFG = MacConfig(ftype=2, subtype=0, to_ds=1, from_ds=0, retry=0,
                    protected=0, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
MAC_CFG_QOS = MacConfig(ftype=2, subtype=8, to_ds=1, from_ds=0, retry=0,
                        protected=0, addr1="f4:69:d5:80:0f:a0",
                        addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                        seq=2704)


@pytest.fixture(scope="module")
def ref():
    p8h = get_oracle("phy80211header")
    phy = get_oracle("phy80211")
    return p8h, phy


def _ref_tx_mpdu(ref, mpdu, fmt, mcs, nsts):
    p8h, phy = ref
    with quiet():
        ins = phy.phy80211(ifDebug=False)
        ins.genFromMpdu(mpdu, p8h.modulation(p8h.F(fmt.value), mcs,
                                             p8h.BW.BW20, nsts, False))
        return np.asarray(ins.ssPhySig, dtype=np.complex128)


def _ref_tx_ampdu(ref, ampdu, mcs, nsts):
    p8h, phy = ref
    with quiet():
        ins = phy.phy80211(ifDebug=False)
        ins.genFromAmpdu(ampdu, p8h.modulation(p8h.F.VHT, mcs, p8h.BW.BW20,
                                               nsts, False),
                         vhtPartialAid=0, vhtGroupId=0)
        return np.asarray(ins.ssPhySig, dtype=np.complex128)


@pytest.mark.parametrize("mcs", range(8))
def test_legacy_siso(ref, mcs):
    mpdu = build_udp_mpdu(UDP_PAYLOAD, MAC_CFG)
    mine = gen_mpdu(mpdu, Mod(F.L, mcs)).waveform
    want = _ref_tx_mpdu(ref, mpdu, F.L, mcs, 1)
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)


@pytest.mark.parametrize("mcs", [0, 3, 7])
def test_ht_siso(ref, mcs):
    mpdu = build_udp_mpdu(UDP_PAYLOAD, MAC_CFG)
    mine = gen_mpdu(mpdu, Mod(F.HT, mcs)).waveform
    want = _ref_tx_mpdu(ref, mpdu, F.HT, mcs, 1)
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)


@pytest.mark.parametrize("mcs", [8, 12, 15])
def test_ht_2x2(ref, mcs):
    mpdu = build_udp_mpdu(UDP_PAYLOAD, MAC_CFG)
    mine = gen_mpdu(mpdu, Mod(F.HT, mcs, BW.BW20, 2)).waveform
    want = _ref_tx_mpdu(ref, mpdu, F.HT, mcs, 2)
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)


@pytest.mark.parametrize("mcs", [0, 4, 8])
def test_vht_siso_ampdu(ref, mcs):
    ampdu = aggregate_vht([build_udp_mpdu(UDP_PAYLOAD, MAC_CFG_QOS)])
    mine = gen_ampdu(ampdu, Mod(F.VHT, mcs)).waveform
    want = _ref_tx_ampdu(ref, ampdu, mcs, 1)
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)


@pytest.mark.parametrize("mcs", [0, 7, 8])
def test_vht_2x2_ampdu(ref, mcs):
    ampdu = aggregate_vht([build_udp_mpdu(UDP_PAYLOAD, MAC_CFG_QOS)] * 2)
    mine = gen_ampdu(ampdu, Mod(F.VHT, mcs, BW.BW20, 2)).waveform
    want = _ref_tx_ampdu(ref, ampdu, mcs, 2)
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)


def test_vht_ndp_2x2(ref):
    mine = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform
    want = _ref_tx_ampdu(ref, b"", 0, 2)
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)


def test_mu_mimo_2user(ref):
    p8h, phy = ref
    ampdu0 = aggregate_vht([build_udp_mpdu(b"This is packet for station 001",
                                           MAC_CFG_QOS)])
    ampdu1 = aggregate_vht([build_udp_mpdu(b"This is packet for station 002",
                                           MAC_CFG_QOS)])
    rng = np.random.default_rng(7)
    q = rng.standard_normal((64, 2, 2)) + 1j * rng.standard_normal((64, 2, 2))
    with quiet():
        ins = phy.phy80211(ifDebug=False)
        ins.genAmpduMu(nUser=2, bfQ=list(q), groupId=2,
                       ampdu0=ampdu0,
                       mod0=p8h.modulation(p8h.F.VHT, 0, p8h.BW.BW20, 1, False),
                       ampdu1=ampdu1,
                       mod1=p8h.modulation(p8h.F.VHT, 0, p8h.BW.BW20, 1, False))
        want = np.asarray(ins.ssPhySig, dtype=np.complex128)
    mine = gen_ampdu_mu([ampdu0, ampdu1],
                        [Mod(F.VHT, 0, BW.BW20, 1), Mod(F.VHT, 0, BW.BW20, 1)],
                        bfq=q, group_id=2).waveform
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-9)
