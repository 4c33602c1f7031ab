"""Table-driven generic decoder vs the per-config decoders (parity).

One program must decode EVERY 20 MHz SISO config (L0-7/HT0-7/VHT0-8) a
mixed capture can carry, byte-identically to the per-(fmt, mcs) compiled
SisoDataDecoder lanes that the streaming receiver uses.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from ieee80211_phy.mac import (MacConfig, aggregate_vht, build_udp_mpdu,
                               deaggregate_vht)
from ieee80211_phy.ops import sync
from ieee80211_phy.rx.generic import GenericSisoDecoder
from ieee80211_phy.specs import F, Mod
from ieee80211_phy.specs.crc import fcs_ok
from ieee80211_phy.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_phy.utils import c2r

CFG = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                seq=2704)

ALL_CONFIGS = tuple([(F.L, m) for m in range(8)]
                    + [(F.HT, m) for m in range(8)]
                    + [(F.VHT, m) for m in range(9)])


def _build(fmt, mcs, payload):
    mpdu = build_udp_mpdu(payload, CFG)
    mod = Mod(fmt, mcs)
    if fmt == F.VHT:
        am = aggregate_vht([mpdu])
        pp = ppdu_params_aggregate(mod, len(am))
        wave = gen_ampdu(am, mod).waveform
    else:
        pp = ppdu_params_nonaggregate(mod, len(mpdu))
        wave = gen_mpdu(mpdu, mod).waveform
    wave = finalize(wave, multiplier=0.25, cfo_hz=8000.0, gap=False)[0]
    return mod, pp, mpdu, wave


def test_generic_decodes_every_config():
    """All 25 configs, one program: FCS-exact MPDU recovery, plus parity
    of the raw decoded bits with the per-config SisoDataDecoder."""
    from ieee80211_phy.rx.receiver import SisoDataDecoder

    rng = np.random.default_rng(5)
    n_sym_cap = 40
    dec = GenericSisoDecoder(ALL_CONFIGS, n_sym_cap)
    built = []
    for fmt, mcs in ALL_CONFIGS:
        pl = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        mod, pp, mpdu, wave = _build(fmt, mcs, pl)
        assert pp.n_sym <= n_sym_cap, (fmt, mcs, pp.n_sym)
        built.append((mod, pp, mpdu, wave))

    w = 200 + dec.window_capacity()
    x = np.zeros((len(built), w), np.complex64)
    for i, (_, _, _, wave) in enumerate(built):
        seg = wave[64 - 8:]
        x[i, :min(w, len(seg))] = seg[:min(w, len(seg))]
    x2 = jnp.asarray(c2r(x))
    t0 = jnp.zeros(len(built), jnp.int32)
    ls, cfo, _ = sync.sync_front_iq(x2, t0)
    cfg_idx = jnp.arange(len(built), dtype=jnp.int32)
    nv = jnp.asarray([pp.n_sym for _, pp, _, _ in built], jnp.int32)
    bits = np.asarray(dec.decode(x2, ls, cfo, cfg_idx, nv))

    for i, ((fmt, mcs), (mod, pp, mpdu, _)) in enumerate(
            zip(ALL_CONFIGS, built)):
        row = bits[i]
        if fmt == F.VHT:
            psdu_len = (pp.n_sym * mod.nDBPS - 22) // 8
            psdu = np.packbits(row[16:16 + psdu_len * 8],
                               bitorder="little").tobytes()
            subs = deaggregate_vht(psdu)
            assert any(s.fcs_ok and s.mpdu == mpdu for s in subs), \
                f"{fmt.name}{mcs}"
        else:
            psdu = np.packbits(row[16:16 + pp.psdu_len * 8],
                               bitorder="little").tobytes()
            assert fcs_ok(psdu) and psdu == mpdu, f"{fmt.name}{mcs}"

        # bit parity vs the per-config lane (same window, same sync)
        lane = SisoDataDecoder(mod, n_sym_cap)
        lb, _ = lane.decode(x2[i:i + 1], ls[i:i + 1], cfo[i:i + 1],
                            nv[i:i + 1])
        nb = pp.n_sym * mod.nDBPS
        np.testing.assert_array_equal(row[:nb], lb[0][:nb],
                                      err_msg=f"{fmt.name}{mcs}")


def test_generic_mixed_noise():
    """A noisy mixed batch (same config set) still decodes: the shared
    n_bits_max trellis with zero-padded tails is path-neutral."""
    rng = np.random.default_rng(9)
    subset = ((F.L, 3), (F.HT, 5), (F.VHT, 7), (F.VHT, 2))
    dec = GenericSisoDecoder(subset, 24)
    rows, metas = [], []
    w = 200 + dec.window_capacity()
    for fmt, mcs in subset:
        pl = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        mod, pp, mpdu, wave = _build(fmt, mcs, pl)
        x = np.zeros(w, np.complex64)
        seg = wave[64 - 8:]
        x[:min(w, len(seg))] = seg[:min(w, len(seg))]
        rms = float(np.sqrt(np.mean(np.abs(wave[:320]) ** 2)))
        namp = rms * 10 ** (-30 / 20)      # 30 dB SNR
        x += ((rng.standard_normal(w) + 1j * rng.standard_normal(w))
              * namp / np.sqrt(2))
        rows.append(c2r(x.astype(np.complex64)))
        metas.append((mod, pp, mpdu))
    x2 = jnp.asarray(np.stack(rows))
    ls, cfo, _ = sync.sync_front_iq(x2, jnp.zeros(len(rows), jnp.int32))
    bits = np.asarray(dec.decode(
        x2, ls, cfo, jnp.arange(len(rows), dtype=jnp.int32),
        jnp.asarray([pp.n_sym for _, pp, _ in metas], jnp.int32)))
    for i, (mod, pp, mpdu) in enumerate(metas):
        if mod.fmt == F.VHT:
            psdu_len = (pp.n_sym * mod.nDBPS - 22) // 8
            psdu = np.packbits(bits[i, 16:16 + psdu_len * 8],
                               bitorder="little").tobytes()
            assert any(s.fcs_ok and s.mpdu == mpdu
                       for s in deaggregate_vht(psdu))
        else:
            psdu = np.packbits(bits[i, 16:16 + pp.psdu_len * 8],
                               bitorder="little").tobytes()
            assert fcs_ok(psdu) and psdu == mpdu
