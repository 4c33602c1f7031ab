"""40/80 MHz and 3/4-stream golden TX sanity (PY-TB envelope, SURVEY.md §6).

The reference toolbox carries 40/80 MHz tables but its own 40/80 TX paths
contain dormant bugs (procPilotInsert length mismatch; VHT80 SIG-B x2
repetition instead of the standard's x4+pad), so these are standalone
consistency checks rather than reference comparisons.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.specs import BW, F, Mod, tables
from ieee80211_phy.tx import gen_ampdu, gen_mpdu

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)
CFG_QOS = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)


@pytest.mark.parametrize("bw,nsts,mcs", [
    (BW.BW40, 1, 0), (BW.BW40, 2, 9), (BW.BW80, 2, 7), (BW.BW80, 4, 9)])
def test_vht_wideband_tx(bw, nsts, mcs):
    ampdu = aggregate_vht([build_udp_mpdu(b"y" * 60, CFG_QOS)])
    mod = Mod(F.VHT, mcs, bw, nsts)
    tx = gen_ampdu(ampdu, mod)
    w = tx.waveform
    nfft = tables.NFFT[bw]
    sym = nfft + nfft // 4
    assert w.shape[0] == nsts
    assert w.shape[1] % (sym // 4) == 0
    assert np.isfinite(w).all()
    # preamble+data occupies: 4 legacy syms + L-SIG + SIG-A(2) + STF +
    # nLTF + SIG-B + data, all in `sym`-sample units
    n_fields = 4 + 1 + 2 + 1 + mod.nLTF + 1 + tx.pp.n_sym
    assert w.shape[1] == n_fields * sym
    # energy present in every stream
    assert (np.abs(w).max(axis=1) > 1e-3).all()


@pytest.mark.parametrize("bw,nsts,mcs", [(BW.BW40, 2, 9), (BW.BW40, 3, 21)])
def test_ht_wideband_tx(bw, nsts, mcs):
    mpdu = build_udp_mpdu(b"y" * 60, CFG)
    mod = Mod(F.HT, mcs, bw, nsts)
    tx = gen_mpdu(mpdu, mod)
    w = tx.waveform
    nfft = tables.NFFT[bw]
    sym = nfft + nfft // 4
    n_fields = 4 + 1 + 2 + 1 + mod.nLTF + tx.pp.n_sym
    assert w.shape == (nsts, n_fields * sym)
    assert np.isfinite(w).all()
