"""Dual-chain sharded capture->decode loop (sharded_capture_decode_auto2):
the one-program mesh analog of the reference rx2 flowgraph
(/root/reference/examples/rx2.grc), on the virtual 8-device CPU mesh.

Covers: MRC SISO + 2x2 branches, in-graph NDP LTF extraction,
capacity-routed vs full-width branch execution parity, branch-overflow
flagging, and cross-shard trigger dedup.
"""
import numpy as np
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu, \
    deaggregate_vht
from ieee80211_phy.parallel import make_phy_mesh
from ieee80211_phy.parallel.sharded import sharded_capture_decode_auto2
from ieee80211_phy.rx.mimo import MrcDataDecoder
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.specs.crc import fcs_ok
from ieee80211_phy.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_phy.utils import c2r

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)


def _setup():
    mpdu = build_udp_mpdu(b"123456789012345678901234567890", CFG)
    ampdu = aggregate_vht([mpdu])
    mod_l, mod_vht = Mod(F.L, 7), Mod(F.VHT, 7)
    mod_22 = Mod(F.HT, 12, BW.BW20, 2)
    pp_l = ppdu_params_nonaggregate(mod_l, len(mpdu))
    pp_vht = ppdu_params_aggregate(mod_vht, len(ampdu))
    pp_22 = ppdu_params_nonaggregate(mod_22, len(mpdu))
    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j], [-0.4 + 0.6j, 0.9 + 0.1j]])
    w_l = np.stack([h1[0], h1[1]])[:, None] * finalize(
        gen_mpdu(mpdu, mod_l).waveform, multiplier=0.2, cfo_hz=12000.0,
        gap=False)[0][None, :]
    w_vht = np.stack([h1[0], h1[1]])[:, None] * finalize(
        gen_ampdu(ampdu, mod_vht).waveform, multiplier=0.2, cfo_hz=5000.0,
        gap=False)[0][None, :]
    w_22 = h22 @ finalize(gen_mpdu(mpdu, mod_22).waveform, multiplier=0.2,
                          cfo_hz=-8000.0, gap=False)
    w_ndp = h22 @ finalize(gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform,
                           multiplier=0.2, cfo_hz=3000.0, gap=False)
    branches = ((mod_l, pp_l.n_sym), (mod_vht, pp_vht.n_sym),
                (mod_22, pp_22.n_sym))
    w = max(MrcDataDecoder(mod_l, pp_l.n_sym).window_capacity(),
            MrcDataDecoder(Mod(F.VHT, 7), pp_vht.n_sym).window_capacity(),
            272 + 448 + 160 + 80 * pp_22.n_sym + 160)
    return mpdu, [w_l, w_vht, w_22, w_ndp], branches, w


def _capture(waves, w, dp, sp, seed=3):
    rng = np.random.default_rng(seed)
    max_wave = max(wv.shape[1] for wv in waves)
    t_len = -(-(4 * (max_wave + 900) + 2 * w) // (512 * sp)) * (512 * sp)
    tl = t_len // sp
    cap = np.zeros((dp, 2, t_len), dtype=np.complex64)
    for r in range(dp):
        order = [waves[(r + i) % 4] for i in range(4)]
        offs = [64 + 16 * r, 64 + max_wave + 900,
                (tl - 100) if sp > 1 else (64 + 2 * (max_wave + 900)),
                t_len - max_wave - w]
        for o, wv in zip(offs, order):
            cap[r, :, o:o + wv.shape[1]] += wv
    cap += (rng.standard_normal(cap.shape)
            + 1j * rng.standard_normal(cap.shape)) * 1e-4
    return cap


def _count(out, mpdu):
    ok = np.asarray(out["ok"])
    bits = np.asarray(out["bits"])
    fmt = np.asarray(out["fmt"])
    ndp = np.asarray(out["ndp"])
    psdu_len = np.asarray(out["psdu_len"])
    n_ok = n_ndp = 0
    for r in range(ok.shape[0]):
        for j in range(ok.shape[1]):
            if ndp[r, j]:
                n_ndp += 1
                continue
            if not ok[r, j]:
                continue
            psdu = np.packbits(
                bits[r, j, 16:16 + int(psdu_len[r, j]) * 8].astype(np.uint8),
                bitorder="little").tobytes()
            if fmt[r, j] == 2:
                subs = deaggregate_vht(psdu)
                if subs and subs[0].fcs_ok and subs[0].mpdu == mpdu:
                    n_ok += 1
            elif fcs_ok(psdu) and psdu == mpdu:
                n_ok += 1
    return n_ok, n_ndp


@pytest.mark.parametrize("branch_cap", [None, 8])
def test_dual_chain_sharded_auto(branch_cap):
    mpdu, waves, branches, w = _setup()
    mesh = make_phy_mesh(8, sp=2)
    dp, sp = 4, 2
    cap = _capture(waves, w, dp, sp)
    run = sharded_capture_decode_auto2(mesh, branches, w, k_per_shard=8,
                                       branch_cap=branch_cap)
    out = run(c2r(cap))
    assert not np.any(np.asarray(out["overflow"]))
    assert not np.any(np.asarray(out["branch_overflow"]))
    n_ok, n_ndp = _count(out, mpdu)
    assert n_ok == 3 * dp, f"{n_ok}/{3 * dp} packets"
    assert n_ndp == dp, f"{n_ndp}/{dp} NDPs"


def test_dual_chain_branch_overflow_flags():
    """A branch capacity smaller than its matching-window count must flag
    branch_overflow instead of silently truncating coverage claims."""
    mpdu, waves, branches, w = _setup()
    mesh = make_phy_mesh(8, sp=2)
    cap = _capture(waves, w, 4, 2)
    run = sharded_capture_decode_auto2(mesh, branches, w, k_per_shard=8,
                                       branch_cap=1)
    out = run(c2r(cap))
    assert np.any(np.asarray(out["branch_overflow"]))


def test_sharded_auto2_mu_branch():
    """Downlink MU decode INSIDE the one-program mesh loop: a mixed
    SU(MRC)+MU capture on 2 RX chains; the MU window's (mcs, len) resolve
    from the in-graph SIG-B pass and the own-stream decode (masked P-row
    combining over a dynamic group layout) recovers the exact MPDU with
    the SIG-B CRC verified in-graph."""
    from ieee80211_phy.mac import aggregate_vht, deaggregate_vht
    from ieee80211_phy.parallel.sharded import sharded_capture_decode_auto2
    from ieee80211_phy.rx.mimo import MrcDataDecoder
    from ieee80211_phy.specs.modulation import ppdu_params_aggregate
    from ieee80211_phy.tx import gen_ampdu_mu

    sp, dp = 2, 2
    mesh = make_phy_mesh(4, sp=sp)
    mpdu0 = build_udp_mpdu(b"sharded mu user zero exact pay", CFG)
    mpdu1 = build_udp_mpdu(b"sharded mu user one exact payl", CFG)
    mpdu_su = build_udp_mpdu(b"sharded su packet exact paylo", CFG)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    mu_tx = gen_ampdu_mu([aggregate_vht([mpdu0]), aggregate_vht([mpdu1])],
                         [Mod(F.VHT, 4, BW.BW20, 1),
                          Mod(F.VHT, 2, BW.BW20, 1)],
                         bfq=qi, group_id=2)
    mu_wave = finalize(mu_tx.waveform, 0.2, -6000.0, gap=False)
    # STA antennas hear only stream 0 (identity Q + nulled interferer,
    # as the AP's ZF precoding arranges); two gains = MRC diversity
    g = np.array([0.9 - 0.2j, 0.55 + 0.7j])
    rx_mu = np.stack([g[0] * mu_wave[0], g[1] * mu_wave[0]])
    mod_su = Mod(F.VHT, 7)
    pp_su = ppdu_params_aggregate(mod_su, len(aggregate_vht([mpdu_su])))
    from ieee80211_phy.tx import gen_ampdu
    su_wave = finalize(gen_ampdu(aggregate_vht([mpdu_su]),
                                 mod_su).waveform, 0.2, 9000.0,
                      gap=False)[0]
    rx_su = np.stack([0.8 * su_wave, (0.3 + 0.6j) * su_wave])

    mod_mu0 = Mod(F.VHT, 4, BW.BW20, 1)
    # the MU PPDU's symbol count is the GROUP max (the slower user's)
    n_sym_mu = max(
        ppdu_params_aggregate(Mod(F.VHT, 4, BW.BW20, 1),
                              len(aggregate_vht([mpdu0]))).n_sym,
        ppdu_params_aggregate(Mod(F.VHT, 2, BW.BW20, 1),
                              len(aggregate_vht([mpdu1]))).n_sym)
    branches = ((mod_su, pp_su.n_sym),)
    mu_branches = ((mod_mu0, n_sym_mu + 2),)
    w = max(MrcDataDecoder(mod_su, pp_su.n_sym).window_capacity(),
            272 + 448 + 4 * 80 + 160 + (n_sym_mu + 2) * 80 + 80)
    seg = np.concatenate([np.zeros((2, 700), np.complex64), rx_mu,
                          np.zeros((2, 700), np.complex64), rx_su],
                         axis=1).astype(np.complex64)
    t_len = -(-(seg.shape[1] + 2 * w) // (512 * sp)) * (512 * sp)
    cap = np.zeros((dp, 2, t_len), np.complex64)
    for r in range(dp):
        cap[r, :, 64 + 32 * r:64 + 32 * r + seg.shape[1]] += seg

    run = sharded_capture_decode_auto2(
        mesh, branches, w, k_per_shard=4, mu_branches=mu_branches,
        mu_pos=0, mu_gid=2)
    out = run(c2r(cap))
    ok = np.asarray(out["ok"])
    mu = np.asarray(out["mu"])
    bits = np.asarray(out["bits"])
    pl = np.asarray(out["psdu_len"])
    for r in range(dp):
        got_mu = got_su = 0
        for j in range(ok.shape[1]):
            if not ok[r, j]:
                continue
            psdu = np.packbits(bits[r, j, 16:16 + int(pl[r, j]) * 8]
                               .astype(np.uint8),
                               bitorder="little").tobytes()
            subs = deaggregate_vht(psdu)
            if mu[r, j]:
                assert any(s.fcs_ok and s.mpdu == mpdu0 for s in subs), r
                got_mu += 1
            elif any(s.fcs_ok and s.mpdu == mpdu_su for s in subs):
                got_su += 1
        assert got_mu == 1 and got_su == 1, f"row {r}: {got_mu}/{got_su}"
