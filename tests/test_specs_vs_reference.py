"""Validate the generated spec tables against the reference toolbox.

Every table in ieee80211_phy.specs is derived from the standard's formulas;
here we check numeric equality with the reference's literal tables
(tools/phy80211header.py) per SURVEY.md §7 step 1.
"""
import numpy as np
import pytest

from ieee80211_phy.specs import BW, CR, F, M, Mod, tables
from ieee80211_phy.specs import interleaver as ilv
from ieee80211_phy.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)

from reference_oracle import get_oracle, quiet


@pytest.fixture(scope="module")
def p8h():
    return get_oracle("phy80211header")


def test_qam_tables(p8h):
    for m, ref_idx in [(M.BPSK, 0), (M.QBPSK, 1), (M.QPSK, 2), (M.QAM16, 3),
                       (M.QAM64, 4), (M.QAM256, 5)]:
        ref = np.asarray(p8h.C_QAM_MODU_TAB[ref_idx], dtype=np.complex128)
        np.testing.assert_allclose(tables.QAM_TAB[m], ref, atol=1e-12)


def test_training_sequences(p8h):
    np.testing.assert_allclose(tables.STF_L[BW.BW20], np.asarray(p8h.C_STF_L_26))
    np.testing.assert_allclose(tables.STF_L[BW.BW40], np.asarray(p8h.C_STF_L_58))
    np.testing.assert_allclose(tables.LTF_L[BW.BW20], np.asarray(p8h.C_LTF_L_26))
    np.testing.assert_allclose(tables.LTF_L[BW.BW80], np.asarray(p8h.C_LTF_L_122))
    np.testing.assert_allclose(tables.LTF_HT[BW.BW20], np.asarray(p8h.C_LTF_HT_28))
    np.testing.assert_allclose(tables.LTF_HT[BW.BW40], np.asarray(p8h.C_LTF_HT_58))
    np.testing.assert_allclose(tables.LTF_VHT[BW.BW80], np.asarray(p8h.C_LTF_VHT_122))
    np.testing.assert_allclose(tables.STF_VHT[BW.BW80], np.asarray(p8h.C_STF_VHT_122))


def test_pilot_polarity(p8h):
    np.testing.assert_array_equal(tables.PILOT_POLARITY,
                                  np.asarray(p8h.C_PILOT_PS, dtype=np.float64))


def test_pilot_patterns(p8h):
    np.testing.assert_array_equal(tables.PILOT_L, np.asarray(p8h.C_PILOT_L))
    for bwi, bw in [(0, BW.BW20), (1, BW.BW40)]:
        for nsts in range(1, 5):
            np.testing.assert_array_equal(
                tables.PILOT_HT[bw][nsts - 1],
                np.asarray(p8h.C_PILOT_HT[bwi][nsts - 1]))
    for bwi, bw in [(0, BW.BW20), (1, BW.BW40), (2, BW.BW80)]:
        np.testing.assert_array_equal(tables.PILOT_VHT[bw],
                                      np.asarray(p8h.C_PILOT_VHT[bwi]))


def test_trellis_tables(p8h):
    np.testing.assert_array_equal(tables.SV_STATE_NEXT,
                                  np.asarray(p8h.C_SV_STATE_NEXT))
    np.testing.assert_array_equal(tables.SV_STATE_OUTPUT2,
                                  np.asarray(p8h.C_SV_STATE_OUTPUT))


def test_legacy_rate_bits(p8h):
    np.testing.assert_array_equal(tables.LEGACY_RATE_BITS,
                                  np.asarray(p8h.C_LEGACY_RATE_BIT))


def test_eof_pad_and_crc8(p8h):
    np.testing.assert_array_equal(tables.EOF_PAD_SUBFRAME,
                                  np.asarray(p8h.C_VHT_EOF))
    rng = np.random.default_rng(0)
    for n in (16, 20, 34):
        bits = rng.integers(0, 2, n).tolist()
        assert tables.crc8_bits(bits) == p8h.genBitBitCrc8(bits)


def test_scrambler_sequence(p8h):
    for seed in (1, 7, 93, 127):
        ref = p8h.procScramble([0] * 254, seed)
        mine = np.tile(tables.SCRAMBLE_SEQ[seed], 3)[:254]
        np.testing.assert_array_equal(np.asarray(ref), mine)


def test_csd_and_scales(p8h):
    np.testing.assert_array_equal(tables.CSD_LEGACY_NS,
                                  np.asarray(p8h.C_CYCLIC_SHIFT_L))
    np.testing.assert_array_equal(tables.CSD_NONLEGACY_NS,
                                  np.asarray(p8h.C_CYCLIC_SHIFT_NL))
    assert [tables.SCALE_LTF_VHT[b] for b in BW] == p8h.C_SCALENTF_LTF_VHT
    assert [tables.SCALE_DATA_VHT[b] for b in BW] == p8h.C_SCALENTF_DATA_VHT
    assert [tables.SCALE_SIG_L[b] for b in BW] == p8h.C_SCALENTF_SIG_L


def test_ndp_sigb_bits(p8h):
    for bwi, bw in [(0, BW.BW20), (1, BW.BW40), (2, BW.BW80)]:
        np.testing.assert_array_equal(tables.NDP_SIG_B[bw],
                                      np.asarray(p8h.C_NDP_SIG_B[bwi]))


def test_tone_layout_matches_pilot_insert(p8h):
    """Our index maps reproduce the reference's slice-based grid assembly."""
    rng = np.random.default_rng(1)
    # legacy 48 -> 64 grid
    data = rng.standard_normal(48) + 1j * rng.standard_normal(48)
    p = [1, 1, 1, -1]
    with quiet():
        ref_occ = p8h.procPilotInsert(list(data), p)
    ref_grid = p8h.procNonDataSC(p8h.procDcInsert(ref_occ))
    grid = np.zeros(64, dtype=complex)
    grid[tables.DATA_GRID[(BW.BW20, True)]] = data
    grid[tables.PILOT_GRID[(BW.BW20, True)]] = p
    np.testing.assert_allclose(grid, np.asarray(ref_grid))
    # non-legacy 52 -> 64 grid
    data = rng.standard_normal(52) + 1j * rng.standard_normal(52)
    with quiet():
        ref_occ = p8h.procPilotInsert(list(data), p)
    ref_grid = p8h.procNonDataSC(p8h.procDcInsert(ref_occ))
    grid = np.zeros(64, dtype=complex)
    grid[tables.DATA_GRID[(BW.BW20, False)]] = data
    grid[tables.PILOT_GRID[(BW.BW20, False)]] = p
    np.testing.assert_allclose(grid, np.asarray(ref_grid))
    # 40/80 MHz note: the reference's procPilotInsert 40 MHz branch expects a
    # 110-element input that cannot chain with its own procDcInsert (114) —
    # a dormant inconsistency (only 20 MHz is exercised end-to-end there).
    # Our 40/80 MHz maps follow the standard tone sets directly.
    assert len(tables.DATA_GRID[(BW.BW40, False)]) == 108
    assert len(tables.PILOT_GRID[(BW.BW40, False)]) == 6
    assert len(tables.DATA_GRID[(BW.BW80, False)]) == 234
    assert len(tables.PILOT_GRID[(BW.BW80, False)]) == 8


def test_interleaver_legacy(p8h):
    rng = np.random.default_rng(2)
    with quiet():
        for mcs in range(8):
            mod = Mod(F.L, mcs)
            refmod = p8h.modulation(p8h.F.L, mcs, p8h.BW.BW20, 1, False)
            refmod.nSym = 1
            bits = rng.integers(0, 2, mod.nCBPS).tolist()
            ref = p8h.procInterleaveLegacy([bits], refmod)[0]
            mine = np.asarray(bits)[ilv.tx_perm(mod)]
            np.testing.assert_array_equal(mine, np.asarray(ref))
            # round trip
            np.testing.assert_array_equal(mine[ilv.rx_perm(mod)], bits)


def test_interleaver_sig(p8h):
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 48).tolist()
    ref = p8h.procInterleaveSigL(bits)
    mine = np.asarray(bits)[ilv.sig_tx_perm()]
    np.testing.assert_array_equal(mine, np.asarray(ref))
    ref_d = p8h.procDeinterleaveSigL(bits)
    np.testing.assert_array_equal(np.asarray(bits)[ilv.sig_rx_perm()],
                                  np.asarray(ref_d))


@pytest.mark.parametrize("fmt,mcs,bw,nsts", [
    (F.HT, 0, BW.BW20, 1), (F.HT, 7, BW.BW20, 1), (F.HT, 12, BW.BW20, 2),
    (F.VHT, 0, BW.BW20, 1), (F.VHT, 8, BW.BW20, 1), (F.VHT, 9, BW.BW20, 3),
    (F.VHT, 7, BW.BW40, 2), (F.VHT, 9, BW.BW80, 2),
])
def test_interleaver_nonlegacy(p8h, fmt, mcs, bw, nsts):
    rng = np.random.default_rng(4)
    mod = Mod(fmt, mcs, bw, nsts)
    with quiet():
        refmod = p8h.modulation(p8h.F(fmt.value), mcs, p8h.BW(bw.value), nsts, False)
        refmod.nSym = 1
        ss_bits = [rng.integers(0, 2, mod.nCBPSS).tolist() for _ in range(nsts)]
        ref = p8h.procInterleaveNonLegacy(ss_bits, refmod)
    for iss in range(nsts):
        mine = np.asarray(ss_bits[iss])[ilv.tx_perm(mod, iss)]
        np.testing.assert_array_equal(mine, np.asarray(ref[iss]))
        np.testing.assert_array_equal(mine[ilv.rx_perm(mod, iss)], ss_bits[iss])


# nES==1 configs only: the reference parser indexes per-encoder arrays with
# an nCBPS symbol stride (tools/phy80211header.py:861), which is out of range
# for nES>=2 — dormant there (20 MHz always has nES==1). For nES>=2 our maps
# are checked by the bijectivity assertion in stream_deparser_maps.
@pytest.mark.parametrize("fmt,mcs,bw,nsts", [
    (F.HT, 12, BW.BW20, 2), (F.VHT, 7, BW.BW20, 2), (F.VHT, 4, BW.BW40, 3),
])
def test_stream_parser(p8h, fmt, mcs, bw, nsts):
    rng = np.random.default_rng(5)
    mod = Mod(fmt, mcs, bw, nsts)
    with quiet():
        refmod = p8h.modulation(p8h.F(fmt.value), mcs, p8h.BW(bw.value), nsts, False)
        refmod.nSym = 2
        es_bits = [rng.integers(0, 2, 2 * mod.nCBPS // mod.nES).tolist()
                   for _ in range(mod.nES)]
        ref = p8h.procStreamParserNonLegacy(es_bits, refmod)
    es_idx, bit_idx = ilv.stream_parser_maps(mod)
    es_arr = np.asarray(es_bits).reshape(mod.nES, 2, -1)
    for iss in range(nsts):
        for sym in range(2):
            mine = es_arr[es_idx[iss], sym, bit_idx[iss]]
            np.testing.assert_array_equal(
                mine, np.asarray(ref[iss][sym * mod.nCBPSS:(sym + 1) * mod.nCBPSS]))


@pytest.mark.parametrize("fmt,mcs,nsts,length", [
    (F.L, 0, 1, 110), (F.L, 7, 1, 110), (F.HT, 7, 1, 110), (F.HT, 15, 2, 500),
])
def test_ppdu_params_nonaggregate(p8h, fmt, mcs, nsts, length):
    mod = Mod(fmt, mcs, BW.BW20, nsts)
    with quiet():
        refmod = p8h.modulation(p8h.F(fmt.value), mcs, p8h.BW.BW20, nsts, False)
        refmod.procPktLenNonAggre(length)
    pp = ppdu_params_nonaggregate(mod, length)
    assert pp.n_sym == refmod.nSym
    assert pp.n_pad_bits == refmod.nPadBits
    assert pp.tx_time_us == refmod.txTime
    assert pp.legacy_len == refmod.legacyLen
    assert mod.nDBPS == refmod.nDBPS
    assert mod.nCBPS == refmod.nCBPS
    assert mod.nES == refmod.nES


@pytest.mark.parametrize("mcs,nsts,length", [(0, 1, 104), (7, 1, 104),
                                             (8, 1, 104), (9, 3, 500), (0, 2, 0)])
def test_ppdu_params_vht_aggregate(p8h, mcs, nsts, length):
    mod = Mod(F.VHT, mcs, BW.BW20, nsts)
    with quiet():
        refmod = p8h.modulation(p8h.F.VHT, mcs, p8h.BW.BW20, nsts, False)
        refmod.procPktLenAggre(length)
    pp = ppdu_params_aggregate(mod, length)
    assert pp.n_sym == refmod.nSym
    assert pp.psdu_len == refmod.psduLen
    assert pp.n_pad_eof == refmod.nPadEof
    assert pp.n_pad_octet == refmod.nPadOctet
    assert pp.n_pad_bits == refmod.nPadBits
    assert pp.tx_time_us == refmod.txTime
    assert pp.legacy_len == refmod.legacyLen
