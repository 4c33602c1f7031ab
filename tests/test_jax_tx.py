"""Batched JAX TX equals the golden numpy TX sample-for-sample."""
import numpy as np
import jax.numpy as jnp
import pytest

from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_phy.specs import BW, F, Mod
from ieee80211_phy.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_phy.tx import gen_ampdu, gen_mpdu
from ieee80211_phy.tx.jax_tx import TxPipeline

MAC_CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
MAC_CFG_QOS = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                        addr2="00:c0:ca:b1:5b:e1",
                        addr3="f4:69:d5:80:0f:a0", seq=2704)


def _as_c(w2):
    return w2[..., 0] + 1j * w2[..., 1]


@pytest.mark.parametrize("fmt,mcs,nsts", [
    (F.L, 0, 1), (F.L, 7, 1), (F.HT, 7, 1), (F.HT, 12, 2)])
def test_jax_tx_matches_golden_mpdu(fmt, mcs, nsts):
    mpdu = build_udp_mpdu(b"123456789012345678901234567890", MAC_CFG)
    mod = Mod(fmt, mcs, BW.BW20, nsts)
    want = gen_mpdu(mpdu, mod).waveform
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    pipe = TxPipeline(mod, pp)
    got = np.asarray(pipe.step(jnp.asarray(
        np.tile(np.frombuffer(mpdu, np.uint8), (3, 1)))))
    assert got.shape == (3, mod.nSS, want.shape[-1], 2)
    np.testing.assert_allclose(_as_c(got[0]), want, atol=2e-6)
    np.testing.assert_allclose(_as_c(got[2]), want, atol=2e-6)


@pytest.mark.parametrize("mcs,nsts", [(0, 1), (8, 1), (7, 2)])
def test_jax_tx_matches_golden_vht(mcs, nsts):
    ampdu = aggregate_vht([build_udp_mpdu(b"123456789012345678901234567890",
                                          MAC_CFG_QOS)])
    mod = Mod(F.VHT, mcs, BW.BW20, nsts)
    want = gen_ampdu(ampdu, mod).waveform
    pp = ppdu_params_aggregate(mod, len(ampdu))
    pipe = TxPipeline(mod, pp)
    got = np.asarray(pipe.step(jnp.asarray(
        np.frombuffer(ampdu, np.uint8)[None])))
    np.testing.assert_allclose(_as_c(got[0]), want, atol=2e-6)


def test_jax_tx_mu_matches_golden():
    """MU downlink: per-user MCS, runtime Q — sample-exact vs golden
    gen_ampdu_mu (which is itself sample-exact vs the reference PY-TB)."""
    from ieee80211_phy.tx.golden import gen_ampdu_mu
    from ieee80211_phy.tx.jax_tx import MuTxPipeline
    from ieee80211_phy.utils import c2r
    a0 = aggregate_vht([build_udp_mpdu(b"user zero payload 0123456789",
                                       MAC_CFG_QOS)])
    a1 = aggregate_vht([build_udp_mpdu(
        b"user one has a different, longer payload abcdefgh", MAC_CFG_QOS)])
    mods = [Mod(F.VHT, 3, BW.BW20, 1), Mod(F.VHT, 1, BW.BW20, 1)]
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(64, 2, 2))
                        + 1j * rng.normal(size=(64, 2, 2)))
    want = gen_ampdu_mu([a0, a1], mods, q).waveform
    mu = MuTxPipeline(mods, [len(a0), len(a1)])
    got = np.asarray(mu.step(
        (jnp.asarray(np.tile(np.frombuffer(a0, np.uint8), (2, 1))),
         jnp.asarray(np.tile(np.frombuffer(a1, np.uint8), (2, 1)))),
        jnp.asarray(c2r(q.astype(np.complex64)))))
    assert got.shape == (2, 2, want.shape[-1], 2)
    np.testing.assert_allclose(_as_c(got[0]), want, atol=2e-6)
    np.testing.assert_allclose(_as_c(got[1]), want, atol=2e-6)


def test_jax_tx_mu_decodes_at_stations():
    """Closed loop with the JAX MU TX in place of the golden one: NDP
    sounding -> ZF Q -> MuTxPipeline -> each STA recovers its own MPDU
    (in-memory cmu_v3, SURVEY.md §3.3)."""
    from ieee80211_phy.mu import (map_q_to_grid, ndp_ltf_channel,
                                  vht_channel_feedback, zf_q)
    from ieee80211_phy.mu.sounding import sta_capture_ndp, sta_decode_mu
    from ieee80211_phy.tx import finalize, gen_ampdu
    from ieee80211_phy.tx.jax_tx import MuTxPipeline
    from ieee80211_phy.utils import c2r

    rng = np.random.default_rng(42)
    h = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    h += 2.0 * np.eye(2)

    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2))
    ncap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                    gap_len=1200)
    v_users = []
    for u in range(2):
        rx = (h[u] @ ncap).astype(np.complex64)
        nc = sta_capture_ndp(rx, n_sts=2)
        assert nc is not None
        v_users.append(vht_channel_feedback(
            ndp_ltf_channel(nc.ltf_iq, n_sts=2), BW.BW20, n_sts=2, n_rx=1))
    q = map_q_to_grid(zf_q(v_users))

    m0 = build_udp_mpdu(b"station zero secret 000", MAC_CFG_QOS)
    m1 = build_udp_mpdu(b"station one secret 111", MAC_CFG_QOS)
    a0, a1 = aggregate_vht([m0]), aggregate_vht([m1])
    mods = [Mod(F.VHT, 2, BW.BW20, 1), Mod(F.VHT, 2, BW.BW20, 1)]
    mu = MuTxPipeline(mods, [len(a0), len(a1)], group_id=2)
    out = np.asarray(mu.step(
        (jnp.asarray(np.frombuffer(a0, np.uint8)[None]),
         jnp.asarray(np.frombuffer(a1, np.uint8)[None])),
        jnp.asarray(c2r(q.astype(np.complex64)))))
    wave = out[0, :, :, 0] + 1j * out[0, :, :, 1]      # [nTx=2, n]
    cap = finalize(wave, multiplier=0.3, cfo_hz=-3000.0, gap=True,
                   gap_len=1200)
    for u, want in ((0, m0), (1, m1)):
        res = sta_decode_mu((h[u] @ cap).astype(np.complex64), mupos=u)
        assert len(res) == 1 and res[0].fcs_ok
        assert res[0].mpdus[0] == want
