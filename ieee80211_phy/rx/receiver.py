"""Batched SISO receiver: sync -> CFO -> SIG parse -> demod -> Viterbi -> MPDU.

Batched re-design of the reference RX stack (SURVEY.md §3.1: trigger ->
sync -> signal -> demod -> decode, lib/*_impl.cc): instead of streaming
blocks with tags, a capture is decoded as a batch of packet-aligned windows
through two jit programs:

  * `sig_parse` — config-independent: LTF sync, CFO, L-SIG + HT-SIG/VHT-SIG-A
    (and VHT-SIG-B) decode. Same shapes for every packet; one compilation.
  * `SisoDataDecoder` — specialized per (format, mcs, nSym): the DATA-field
    pipeline (FFT/equalize/track/demap/deinterleave/Viterbi/descramble) with
    static shapes so XLA fuses it into a few kernels.

Byte-level tail work (packing, FCS, A-MPDU walk) is host-side numpy
(parity: lib/decode_impl.cc:304-520).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mac import deaggregate_ht, deaggregate_vht
from ..specs import BW, CR, F, M, Mod, tables
from ..specs import interleaver as ilv
from ..specs.crc import fcs_ok
from ..specs.modulation import (ppdu_params_aggregate, ppdu_params_nonaggregate)
from ..specs.tables import crc8_bits
from ..ops import coding, demod, sync

# field offsets relative to the LTF data start (= STF start + 192 @20 MHz)
OFF_LSIG = 128
OFF_NLSIG = 208      # HT-SIG / VHT-SIG-A first symbol GI
OFF_NLSTF = 368
OFF_NLLTF = 448


def _bits_to_uint(bits: jnp.ndarray, lo: int, n: int) -> jnp.ndarray:
    w = (1 << jnp.arange(n, dtype=jnp.int32))
    return jnp.sum(bits[..., lo:lo + n].astype(jnp.int32) * w, axis=-1)


def _crc8_ok(bits48: jnp.ndarray) -> jnp.ndarray:
    """Batched SIG CRC-8 check: crc8(bits[0:34]) == bits[34:42].

    The bit-serial CRC is expressed as a GF(2) matrix product with a
    precomputed [34, 8] influence matrix (closed form, no scan).
    """
    mat, const = _crc8_matrix()
    calc = (bits48[..., :34].astype(jnp.int32) @ jnp.asarray(mat)
            + jnp.asarray(const)) % 2
    return jnp.all(calc == bits48[..., 34:42].astype(jnp.int32), axis=-1)


@lru_cache(maxsize=None)
def _crc8_matrix(n: int = 34):
    """CRC-8 of n bits as affine map over GF(2): out = M^T b + c."""
    base = np.asarray(crc8_bits([0] * n), dtype=np.int64)
    mat = np.zeros((n, 8), dtype=np.int64)
    for i in range(n):
        v = [0] * n
        v[i] = 1
        mat[i] = (np.asarray(crc8_bits(v)) + base) % 2
    return mat, base


# --- VHT-SIG-B (SU) decode + SERVICE-field CRC-8 verification -------------
# The reference decodes SIG-B and re-encodes it to measure per-stream SNR
# (lib/demod_impl.cc:449-505, demod2_impl.cc:664-757) and checks the CRC-8
# carried in the SERVICE field (signalParserVhtB). Dims per 21.3.8.3.6:
# pre-tail info bits (len+reserved), total info bits after the bandwidth
# repetition (the repetition is applied BEFORE BCC, tx/golden.py
# vhtsigb_bits).

SIGB_DIMS = {BW.BW20: (20, 26), BW.BW40: (21, 54), BW.BW80: (23, 117)}


def decode_vht_sigb(eq_sym: jnp.ndarray, bw: BW) -> jnp.ndarray:
    """Equalized, pilot-corrected SIG-B symbol grid [B, nfft] -> decoded
    SIG-B info bits [B, n_info]."""
    sigb_mod = Mod(F.VHT, 0, bw, 1)
    _, n_info = SIGB_DIMS[bw]
    llr = jnp.real(eq_sym[..., jnp.asarray(tables.DATA_GRID[(bw, False)])])
    llr = llr[..., jnp.asarray(ilv.rx_perm(sigb_mod))]
    return coding.viterbi_decode(llr, CR.CR12, n_info)


def sigb_service_crc_ok(sigb_bits: jnp.ndarray, scr_bits: jnp.ndarray,
                        bw: BW) -> jnp.ndarray:
    """CRC-8 of the decoded SIG-B pre-tail bits == SERVICE bits 8..15
    (parity: signalParserVhtB / vhtSigBDemod re-encode check). [B] bool."""
    n_pre, _ = SIGB_DIMS[bw]
    mat, const = _crc8_matrix(n_pre)
    calc = (sigb_bits[..., :n_pre].astype(jnp.int32) @ jnp.asarray(mat)
            + jnp.asarray(const)) % 2
    return jnp.all(calc == scr_bits[..., 8:16].astype(jnp.int32), axis=-1)


# ---------------------------------------------------------------------------
# SIG parsing (config-independent jit program)
# ---------------------------------------------------------------------------

SIGPARSE_WIN = 752   # samples consumed from t0 (x q): sync needs 448
# (80 + n_lag 176 + 192), the SIG region ends at ltf_start(<=270) +
# OFF_NLSIG(208) + 2 symbols(160) + window slack(~76) ~= 714; 752 adds
# margin. Every extra sample is gathered per window per chain — the SIG
# window gather is ~half the dual-chain SIG-parse cost (r5 measurement),
# so the old 1040 over-gathered ~30%.

MIN_TRIGGER_GAP = 600  # trigger dedup distance (20 MHz units). The
# non-legacy STF ~560 samples into every HT/VHT packet re-fires the STF
# correlator (the reference re-arms the same way, lib/trigger_impl.cc:
# 92-109) and at min_gap=400 those spurious windows DOUBLED the SIG-parse
# batch. Real consecutive packets are >= ~880 samples apart (SIFS 320 +
# shortest PPDU ~560), so 600 suppresses only the self-re-trigger.


@partial(jax.jit, static_argnames=("n_lag", "q"))
def sig_parse(x2: jnp.ndarray, t0: jnp.ndarray, n_lag: int = 176,
              q: int = 1):
    """Parse the preamble of packets at approximate STF starts t0.

    x2: [B, N, 2] float32 I/Q capture windows; t0: [B] int32.
    q: oversample factor vs 20 MHz (1/2/4 for a 20/40/80 MHz capture). The
    wide legacy-band fields are the 64-bin grid duplicated per 20 MHz
    subband (reference tools/phy80211.py:290-295); the duplicate data tones
    are equal-gain combined after per-subband ZF equalization, so SIG
    decode at 40/80 MHz gets a diversity gain the 20 MHz receiver lacks.
    Returns a dict of per-packet metadata (all [B]-shaped):
    ltf_start, cfo_rad, snr_db, lsig_ok, l_mcs, l_len, ht_ok, vht_ok,
    ht_sig_bits [B,48], vht_siga_bits [B,48].
    """
    from ..utils.riq import r2c
    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    x = r2c(x2)
    ltf_start, cfo, snr = sync.sync_front_iq(x2, t0, n_lag=n_lag, q=q)
    y = sync.apply_cfo_correction(x, cfo)
    nfft, gi, sh, sym = 64 * q, 16 * q, 8 * q, 80 * q

    ltf_t = demod.extract_symbol_windows(y, ltf_start - gi, 2, nfft=nfft,
                                         gi=gi, shift=sh, stride=nfft)
    ltf_f = demod.fft_syms(ltf_t)
    chan = demod.legacy_chan_est(ltf_f, bw)              # [B, 64q]

    d20 = np.asarray(tables.DATA_GRID[(BW.BW20, True)])
    p20 = np.asarray(tables.PILOT_GRID[(BW.BW20, True)])
    data_idx = np.concatenate([d20 + 64 * c for c in range(q)])
    pilot_idx = np.concatenate([p20 + 64 * c for c in range(q)])
    pil_l = np.tile(tables.PILOT_L, q)

    def sig_llr(start, n_sym, pidx0):
        g = demod.fft_syms(demod.extract_symbol_windows(
            y, start, n_sym, nfft=nfft, gi=gi, shift=sh))
        eq = demod.equalize(g, chan)
        pref = jnp.asarray(
            pil_l[None] * tables.PILOT_POLARITY[pidx0:pidx0 + n_sym, None])
        ph = demod.pilot_phase(eq, pref, pilot_idx)
        eq = eq / ph[..., None]
        tones = eq[..., jnp.asarray(data_idx)]           # [B, S, 48q]
        return tones.reshape(tones.shape[:-1] + (q, 48)).sum(axis=-2)

    lsig_eq = sig_llr(ltf_start + OFF_LSIG * q, 1, 0)[:, 0]  # [B, 48]
    # the two post-L-SIG symbols carry HT-SIG (QBPSK) or VHT-SIG-A (BPSK+QBPSK)
    nl_eq = sig_llr(ltf_start + OFF_NLSIG * q, 2, 1)         # [B, 2, 48]
    out = _sig_fields_from_eq(lsig_eq, nl_eq)
    out.update(ltf_start=ltf_start, cfo=cfo, snr=snr)
    return out


def _sig_fields_from_eq(lsig_eq: jnp.ndarray, nl_eq: jnp.ndarray) -> dict:
    """Decode L-SIG / HT-SIG / VHT-SIG-A bits from equalized SIG tones.

    lsig_eq: [B, 48] equalized L-SIG data tones; nl_eq: [B, 2, 48] the two
    post-L-SIG symbols. Shared tail of sig_parse / sig_parse_mimo.
    """
    perm = jnp.asarray(ilv.sig_rx_perm())
    lsig_llr = jnp.real(lsig_eq)[:, perm]
    lsig_bits = coding.viterbi_decode(lsig_llr, CR.CR12, 24)
    parity = jnp.sum(lsig_bits[:, :17], axis=-1) % 2
    lsig_ok = (parity == lsig_bits[:, 17]) & (lsig_bits[:, 3] == 1) \
        & (lsig_bits[:, 4] == 0)
    rate4 = lsig_bits[:, :4]
    rate_tab = jnp.asarray(tables.LEGACY_RATE_BITS)
    l_mcs = jnp.argmax(jnp.all(rate4[:, None, :] == rate_tab[None], axis=-1),
                       axis=-1)
    l_len = _bits_to_uint(lsig_bits, 5, 12)

    im = jnp.imag(nl_eq)
    re = jnp.real(nl_eq)
    # constellation-rotation discriminator for symbol 1: HT-SIG is QBPSK
    # (energy on imag), VHT-SIG-A1 is BPSK (energy on real). Resolves the
    # 1-in-256 case where both SIG CRCs pass (the reference is ambiguous
    # here too, lib/demod_impl.cc:106-148).
    imag_dom = jnp.sum(im[:, 0] ** 2, axis=-1) > jnp.sum(re[:, 0] ** 2,
                                                         axis=-1)
    ht_llr = jnp.concatenate([im[:, 0][:, perm], im[:, 1][:, perm]], axis=-1)
    vht_llr = jnp.concatenate([re[:, 0][:, perm], im[:, 1][:, perm]], axis=-1)
    ht_bits = coding.viterbi_decode(ht_llr, CR.CR12, 48)
    vht_bits = coding.viterbi_decode(vht_llr, CR.CR12, 48)
    ht_ok = _crc8_ok(ht_bits)
    vht_ok = _crc8_ok(vht_bits)

    return dict(lsig_ok=lsig_ok, l_mcs=l_mcs, l_len=l_len,
                lsig_bits=lsig_bits, ht_ok=ht_ok, vht_ok=vht_ok,
                ht_bits=ht_bits, vht_bits=vht_bits, nl1_imag_dom=imag_dom)


@partial(jax.jit, static_argnames=("n_lag", "q"))
def sig_parse_mimo(x2: jnp.ndarray, t0: jnp.ndarray, n_lag: int = 176,
                   q: int = 1):
    """Multi-chain SIG parse with maximal-ratio combining across RX chains.

    x2: [B, nRx, N, 2] float32 I/Q windows; t0: [B] int32.

    The reference decodes L-SIG from RX chain 0 only
    (lib/signal2_impl.cc:113-127) and drops recoverable packets whenever
    that chain's CSD-mixed legacy channel has deep nulls. Here every chain
    gets its own legacy channel estimate and the SIG tones are MRC-combined
    (eq = sum_r conj(H_r) Y_r / sum_r |H_r|^2) before demapping — a 2-chain
    diversity gain the reference never had. Timing and CFO come from the
    chain with the strongest LTF correlation (RX chains share one LO, so
    the CFO is common).

    Returns the same metadata dict as sig_parse.
    """
    from ..utils.riq import r2c
    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    b, nrx = x2.shape[0], x2.shape[1]
    xf = x2.reshape((b * nrx,) + x2.shape[2:])
    ls_c, cfo_c, snr_c = sync.sync_front_iq(xf, jnp.repeat(t0, nrx),
                                            n_lag=n_lag, q=q)
    ls_c = ls_c.reshape(b, nrx)
    cfo_c = cfo_c.reshape(b, nrx)
    snr_c = snr_c.reshape(b, nrx)
    best = jnp.argmax(snr_c, axis=1)
    ltf_start = jnp.take_along_axis(ls_c, best[:, None], axis=1)[:, 0]
    cfo = jnp.take_along_axis(cfo_c, best[:, None], axis=1)[:, 0]
    snr = jnp.max(snr_c, axis=1)

    nfft, gi, sh = 64 * q, 16 * q, 8 * q
    y = sync.apply_cfo_correction(r2c(xf), jnp.repeat(cfo, nrx))
    ls2 = jnp.repeat(ltf_start, nrx)
    ltf_t = demod.extract_symbol_windows(y, ls2 - gi, 2, nfft=nfft,
                                         gi=gi, shift=sh, stride=nfft)
    chan = demod.legacy_chan_est(demod.fft_syms(ltf_t), bw)
    chan = chan.reshape(b, nrx, nfft)                    # [B, nRx, nfft]
    wt = jnp.conj(chan)
    den = jnp.sum(jnp.abs(chan) ** 2, axis=1) + 1e-9     # [B, nfft]

    d20 = np.asarray(tables.DATA_GRID[(BW.BW20, True)])
    p20 = np.asarray(tables.PILOT_GRID[(BW.BW20, True)])
    data_idx = np.concatenate([d20 + 64 * c for c in range(q)])
    pilot_idx = np.concatenate([p20 + 64 * c for c in range(q)])
    pil_l = np.tile(tables.PILOT_L, q)

    def sig_llr(off, n_sym, pidx0):
        g = demod.fft_syms(demod.extract_symbol_windows(
            y, ls2 + off, n_sym, nfft=nfft, gi=gi, shift=sh))
        g = g.reshape(b, nrx, n_sym, nfft)
        eq = jnp.einsum("brsk,brk->bsk", g, wt) / den[:, None, :]
        pref = jnp.asarray(
            pil_l[None] * tables.PILOT_POLARITY[pidx0:pidx0 + n_sym, None])
        ph = demod.pilot_phase(eq, pref, pilot_idx)
        eq = eq / ph[..., None]
        tones = eq[..., jnp.asarray(data_idx)]           # [B, S, 48q]
        return tones.reshape(tones.shape[:-1] + (q, 48)).sum(axis=-2)

    lsig_eq = sig_llr(OFF_LSIG * q, 1, 0)[:, 0]
    nl_eq = sig_llr(OFF_NLSIG * q, 2, 1)
    out = _sig_fields_from_eq(lsig_eq, nl_eq)
    out.update(ltf_start=ltf_start, cfo=cfo, snr=snr)
    return out


def _pick_nl_format(meta, i) -> F:
    """HT vs VHT vs legacy-MCS0 from SIG CRCs + the QBPSK discriminator."""
    vht_ok = bool(meta["vht_ok"][i])
    ht_ok = bool(meta["ht_ok"][i])
    imag_dom = bool(meta["nl1_imag_dom"][i])
    if vht_ok and not imag_dom:
        return F.VHT
    if ht_ok and imag_dom:
        return F.HT
    if vht_ok:
        return F.VHT
    if ht_ok:
        return F.HT
    return F.L


def parse_ht_sig(bits: np.ndarray):
    mcs = int(np.sum(bits[0:7] << np.arange(7)))
    bw = BW.BW40 if bits[7] else BW.BW20
    length = int(np.sum(bits[8:24] << np.arange(16)))
    aggre = bool(bits[27])
    sgi = bool(bits[31])
    return mcs, bw, length, aggre, sgi


def parse_vht_siga(bits: np.ndarray):
    bw = BW(int(bits[0]) | (int(bits[1]) << 1))
    group_id = int(np.sum(bits[4:10] << np.arange(6)))
    su_nsts = int(np.sum(bits[10:13] << np.arange(3))) + 1
    partial_aid = int(np.sum(bits[13:22] << np.arange(9)))
    sgi = bool(bits[24])
    mcs = int(np.sum(bits[28:32] << np.arange(4)))
    return bw, group_id, su_nsts, partial_aid, sgi, mcs


# ---------------------------------------------------------------------------
# on-device capture windowing (batched receiver: the capture is uploaded
# ONCE — possibly int8-quantized — and every window is gathered in-graph,
# so the host<->device traffic is one upload + one small meta fetch + one
# packed-bytes fetch per (Mod, bucket) group)
# ---------------------------------------------------------------------------


def next_pow2(n: int, lo: int = 1) -> int:
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def group_pad(n: int) -> int:
    """Decode-group batch padding: pow2 below 256 (bounds compile shapes
    for sparse traffic), multiples of 256 above (a 720-window group padded
    to pow2 wasted 42% of its decode on replicated rows; 256-multiples cap
    the waste at <1/3 while keeping the shape set small)."""
    return next_pow2(n) if n <= 256 else -(-n // 256) * 256


@partial(jax.jit, static_argnames=("npad",))
def _pad_capture(x: jnp.ndarray, npad: int) -> jnp.ndarray:
    """Zero-pad an uploaded capture to its pow2 working length ON DEVICE.

    The host uploads the TIGHT buffer (rounded to 64k samples) and the
    pow2 tail is materialized here: the pow2 rounding inflates a capture
    by up to 2x, and device-side zeros cost a device-memory write, not
    host->device transfer bytes."""
    pad = [(0, 0)] * x.ndim
    pad[-2] = (0, npad - x.shape[-2])
    return jnp.pad(x, pad)


def _round_64k(n: int) -> int:
    return -(-n // 65536) * 65536


def capture_windows(cap: jnp.ndarray, start: jnp.ndarray, length: int
                    ) -> jnp.ndarray:
    """Gather per-packet windows from a device-resident capture.

    cap: [N, 2] (any real dtype); start: [G] sample indices, clamped by
    sync.window_starts. Returns [G, length, 2] in cap's dtype. Slices the
    FLAT view, like sync.batch_slice_iq.
    """
    flat = cap.reshape(-1)
    st = sync.window_starts(start, cap.shape[0], length)
    seg = jax.vmap(lambda s: jax.lax.dynamic_slice(
        flat, (2 * s,), (2 * length,)))(st)
    return seg.reshape(-1, length, 2)


def capture_windows_mimo(cap: jnp.ndarray, start: jnp.ndarray, length: int
                         ) -> jnp.ndarray:
    """capture_windows for an [nRx, N, 2] dual-chain capture.

    Returns [G, nRx, length, 2]."""
    nrx = cap.shape[0]
    flat = cap.reshape(nrx, -1)

    def take(s):
        return jax.vmap(lambda row: jax.lax.dynamic_slice(
            row, (2 * s,), (2 * length,)))(flat)
    seg = jax.vmap(take)(sync.window_starts(start, cap.shape[1], length))
    return seg.reshape(-1, nrx, length, 2)


def pack_bits_le(bits: jnp.ndarray) -> jnp.ndarray:
    """[B, n] 0/1 -> [B, ceil(n/8)] uint8, LSB-first (np.packbits
    bitorder='little' parity). Packing on-device shrinks the decoded-bits
    fetch 8x."""
    b, n = bits.shape
    n8 = -(-n // 8) * 8
    if n8 != n:
        bits = jnp.concatenate(
            [bits, jnp.zeros((b, n8 - n), bits.dtype)], axis=1)
    w = (1 << jnp.arange(8, dtype=jnp.int32))
    return jnp.sum(bits.reshape(b, -1, 8).astype(jnp.int32) * w,
                   axis=-1).astype(jnp.uint8)


# meta packing: every sig_parse field bit-packed into NINE int32 words per
# window so the host needs a single SMALL fetch per capture
#   w0: ltf_start | w1: flags/l_mcs/l_len | w2: lsig bits | w3-4: ht bits
#   w5-6: vht bits | w7: cfo (f32 bitcast) | w8: snr (f32 bitcast)


def _bits_to_words(bits: jnp.ndarray, n: int) -> list:
    """[B, n] 0/1 -> list of [B] int32 words, 24 bits per word LSB-first."""
    out = []
    for lo in range(0, n, 24):
        w = (1 << jnp.arange(min(24, n - lo), dtype=jnp.int32))
        out.append(jnp.sum(bits[:, lo:lo + 24].astype(jnp.int32) * w,
                           axis=-1))
    return out


def _pack_meta(meta: dict) -> jnp.ndarray:
    w1 = (meta["lsig_ok"].astype(jnp.int32)
          | (meta["ht_ok"].astype(jnp.int32) << 1)
          | (meta["vht_ok"].astype(jnp.int32) << 2)
          | (meta["nl1_imag_dom"].astype(jnp.int32) << 3)
          | (meta["l_mcs"].astype(jnp.int32) << 4)
          | (meta["l_len"].astype(jnp.int32) << 8))
    words = ([meta["ltf_start"].astype(jnp.int32), w1]
             + _bits_to_words(meta["lsig_bits"], 24)
             + _bits_to_words(meta["ht_bits"], 48)
             + _bits_to_words(meta["vht_bits"], 48))
    f32 = jnp.stack([meta["cfo"].astype(jnp.float32),
                     meta["snr"].astype(jnp.float32)], axis=1)
    fbits = jax.lax.bitcast_convert_type(f32, jnp.int32)
    return jnp.concatenate([jnp.stack(words, axis=1), fbits], axis=1)


def _words_to_bits(words: np.ndarray, n: int) -> np.ndarray:
    """[B, ceil(n/24)] int32 -> [B, n] 0/1 (LSB-first, 24 bits/word)."""
    cols = []
    for i in range(words.shape[1]):
        k = min(24, n - 24 * i)
        cols.append((words[:, i:i + 1] >> np.arange(k)) & 1)
    return np.concatenate(cols, axis=1)


def _unpack_meta(packed: np.ndarray) -> dict:
    packed = np.asarray(packed)
    w1 = packed[:, 1]
    out = {
        "ltf_start": packed[:, 0],
        "lsig_ok": w1 & 1,
        "ht_ok": (w1 >> 1) & 1,
        "vht_ok": (w1 >> 2) & 1,
        "nl1_imag_dom": (w1 >> 3) & 1,
        "l_mcs": (w1 >> 4) & 0xF,
        "l_len": (w1 >> 8) & 0xFFF,
        "lsig_bits": _words_to_bits(packed[:, 2:3], 24),
        "ht_bits": _words_to_bits(packed[:, 3:5], 48),
        "vht_bits": _words_to_bits(packed[:, 5:7], 48),
    }
    f32 = packed[:, 7:9].copy().view(np.float32)
    out["cfo"] = f32[:, 0]
    out["snr"] = f32[:, 1]
    return out


@partial(jax.jit, static_argnames=("wlen", "n_lag", "q"))
def sig_parse_capture(cap: jnp.ndarray, scale: jnp.ndarray,
                      t_clamp: jnp.ndarray, t0: jnp.ndarray, wlen: int,
                      n_lag: int = 176, q: int = 1) -> jnp.ndarray:
    """sig_parse over in-graph windows of a device-resident capture.

    cap: [Npad, 2] int8/float32; t_clamp: [B] window starts (host-clamped
    to Npad-wlen); t0: [B] STF-start offsets within each window. Returns
    the packed [B, K] int32 meta array (_unpack_meta reverses)."""
    x2 = capture_windows(cap, t_clamp, wlen).astype(jnp.float32) * scale
    return _pack_meta(sig_parse(x2, t0, n_lag=n_lag, q=q))


@partial(jax.jit, static_argnames=("wlen", "n_lag", "q"))
def sig_parse_mimo_capture(cap: jnp.ndarray, scale: jnp.ndarray,
                           t_clamp: jnp.ndarray, t0: jnp.ndarray, wlen: int,
                           n_lag: int = 176, q: int = 1) -> jnp.ndarray:
    """sig_parse_mimo over in-graph windows of an [nRx, Npad, 2] capture."""
    x2 = capture_windows_mimo(cap, t_clamp, wlen).astype(jnp.float32) * scale
    return _pack_meta(sig_parse_mimo(x2, t0, n_lag=n_lag, q=q))


# ---------------------------------------------------------------------------
# DATA-field decoding (config-specialized)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PacketResult:
    fmt: F
    mcs: int
    psdu: bytes
    fcs_ok: bool
    mpdus: List[bytes]
    cfo_hz: float
    snr_db: float
    evm_snr_db: float = 0.0   # EVM SNR (joint over streams)
    sssnr: tuple = ()         # per-stream EVM SNRs (reference sssnr0/1,
                              # lib/demod2_impl.cc:736-757)
    sigb_ok: Optional[bool] = None  # VHT-SIG-B CRC-8 vs SERVICE field
                                    # (None for non-VHT formats)
    mu: bool = False          # decoded as this STA's downlink MU stream


class SisoDataDecoder:
    """Batched DATA-field decoder for one static (Mod, nSym-bucket) config.

    n_sym is the compiled symbol capacity. Packets with fewer true symbols
    pass their count through `n_valid` (a traced array): LLRs past the true
    extent are zeroed (path-neutral in the Viterbi — the trailing survivor
    diffusion still tracebacks to the max-likelihood state) and excluded
    from the EVM. One compilation therefore serves every packet length in
    the bucket — the fix for a per-length compile storm."""

    def __init__(self, mod: Mod, n_sym: int, psdu_len: int = 0):
        self.mod = mod
        self.n_sym = n_sym
        self.psdu_len = psdu_len
        self.n_bits = n_sym * mod.nDBPS
        self.q = tables.NFFT[mod.bw] // 64
        self._fn = jax.jit(self._decode)

    def data_offset(self) -> int:
        """DATA field GI offset relative to the LTF data start (in samples
        at the capture rate: 20 MHz-unit offsets x q)."""
        if self.mod.fmt == F.L:
            off = OFF_LSIG + 80
        elif self.mod.fmt == F.HT:
            off = OFF_NLLTF + 80 * self.mod.nLTF
        else:
            off = OFF_NLLTF + 80 * self.mod.nLTF + 80   # VHT: + SIG-B
        return off * self.q

    def zlen(self) -> int:
        """Aligned-window length: index 0 == ltf_start - gi (RxPipeline's
        one-slice layout)."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _decode_z(self, z: jnp.ndarray, n_valid: jnp.ndarray = None):
        """ALIGNED decode: z [B, zlen] complex, CFO-corrected, with index
        0 == ltf_start - gi. Every symbol extraction is a STATIC slice —
        the per-packet dynamic gathers of the old layout cost 1-4 ms each
        at streaming batches (CLAUDE.md round-1 lesson; the alignment
        gather happens ONCE, in the caller). Returns (descrambled bits,
        evm_snr_db, sigb_ok)."""
        mod = self.mod
        q = self.q
        # data-window shift 4q, not 8q: re-centers the timing margin for
        # delay-spread tolerance (see models/pipeline.py make_rx_step)
        nfft, gi, sh = 64 * q, 16 * q, 4 * q
        b = z.shape[0]
        if mod.fmt == F.L:
            ltf_t = demod.static_symbol_windows(z, 0, 2, nfft=nfft, gi=gi,
                                                shift=sh, stride=nfft)
            chan = demod.legacy_chan_est(demod.fft_syms(ltf_t), mod.bw)
            pidx0 = 1
        else:
            # channel update from the first non-legacy LTF
            ltf_t = demod.static_symbol_windows(
                z, gi + OFF_NLLTF * q, 1, nfft=nfft, gi=gi, shift=sh)
            chan = demod.nonlegacy_chan_est_siso(
                demod.fft_syms(ltf_t)[:, 0], mod.bw)
            pidx0 = 3 if mod.fmt == F.HT else 4
        g = demod.fft_syms(demod.static_symbol_windows(
            z, gi + self.data_offset(), self.n_sym,
            nfft=nfft, gi=gi, shift=sh))
        llrs, evm = demod.demod_data_siso(g, chan, mod, self.n_sym, pidx0,
                                          with_snr=True,
                                          n_valid_sym=n_valid)
        bits = coding.viterbi_decode(llrs, mod.cr, self.n_bits)
        scr = coding.descramble(bits)
        if mod.fmt == F.VHT:
            # VHT-SIG-B decode + SERVICE CRC-8 check (demod_impl.cc:449-505)
            sb = demod.fft_syms(demod.static_symbol_windows(
                z, gi + self.data_offset() - 80 * q, 1,
                nfft=nfft, gi=gi, shift=sh))[:, 0]
            eq = sb / chan
            pil = jnp.asarray(tables.PILOT_GRID[(mod.bw, False)])
            pref = jnp.asarray(tables.PILOT_VHT[mod.bw]
                               * tables.PILOT_POLARITY[3])
            acc = jnp.sum(eq[:, pil] * jnp.conj(pref)[None], axis=-1)
            ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
            sigb_bits = decode_vht_sigb(eq / ph[:, None], mod.bw)
            sigb_ok = sigb_service_crc_ok(sigb_bits, scr, mod.bw)
        else:
            sigb_ok = jnp.ones(b, dtype=bool)
        return scr, evm, sigb_ok

    def _decode(self, x2: jnp.ndarray, ltf_start: jnp.ndarray,
                cfo: jnp.ndarray, n_valid: jnp.ndarray = None):
        """x2: [B, N, 2] float32 raw windows; ltf_start, cfo: [B].
        One aligned slice, then the static decode."""
        from ..utils.riq import r2c
        gi = 16 * self.q
        z2 = sync.batch_slice_iq(x2, ltf_start - gi, self.zlen())
        z = r2c(z2) * sync.cfo_ramp(cfo, self.zlen())
        return self._decode_z(z, n_valid)

    def decode(self, x2: jnp.ndarray, ltf_start: jnp.ndarray,
               cfo: jnp.ndarray, n_valid: jnp.ndarray = None):
        """Returns (descrambled bits [B, n_bits], evm_snr_db [B])."""
        bits, evm, _ = self._fn(x2, ltf_start, cfo, n_valid)
        return np.asarray(bits), np.asarray(evm)

    def window_capacity(self) -> int:
        """Static window length covering any in-bucket packet: max
        ltf_start (sync search span) + DATA offset + bucket extent."""
        return (272 * self.q + self.data_offset()
                + (self.n_sym * 80 + 80) * self.q)

    def _decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                             n_valid):
        """Batched decode with ONE aligned window gather from the
        device-resident capture (t_abs + ltf_start - gi is per-packet but
        known at gather time, so everything downstream is static slicing);
        returns (packed descrambled bytes [G, n_bits/8], evm [G],
        sigb_ok [G]) so the device->host fetch is bytes, not bit-planes."""
        from ..utils.riq import r2c
        gi = 16 * self.q
        zl = self.zlen()
        x2 = capture_windows(cap, t_abs + ltf_start - gi,
                             zl).astype(jnp.float32) * scale
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)
        bits, evm, sigb_ok = self._decode_z(z, n_valid)
        return pack_bits_le(bits), evm, sigb_ok

    def decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                            n_valid):
        """Async dispatch (device arrays back); np.asarray() to fetch."""
        if not hasattr(self, "_fn_cap"):
            self._fn_cap = jax.jit(self._decode_from_capture)
        return self._fn_cap(cap, scale, t_abs, ltf_start, cfo, n_valid)


N_SYM_BUCKET = 16   # decoder symbol-capacity granularity: a mixed-length
                    # capture compiles one program per (Mod, bucket), not
                    # per exact n_sym (VERDICT.md round-1 Weak #3)


def _bucket(n_sym: int) -> int:
    return -(-n_sym // N_SYM_BUCKET) * N_SYM_BUCKET


@lru_cache(maxsize=64)
def get_data_decoder(mod: Mod, n_sym_bucket: int) -> SisoDataDecoder:
    return SisoDataDecoder(mod, n_sym_bucket)


def assemble_packet(fmt: F, mod: Mod, psdu_len: int, scr_bits: np.ndarray,
                    ampdu: bool, cfo_hz: float = 0.0, snr_db: float = 0.0,
                    evm_snr_db: float = 0.0) -> PacketResult:
    """Service-strip + byte-pack + FCS / A-MPDU deaggregation (host side)."""
    psdu_bits = scr_bits[16:16 + psdu_len * 8].astype(np.uint8)
    psdu = np.packbits(psdu_bits, bitorder="little").tobytes()
    return assemble_psdu(fmt, mod, psdu, ampdu, cfo_hz, snr_db, evm_snr_db)


def assemble_psdu(fmt: F, mod: Mod, psdu: bytes, ampdu: bool,
                  cfo_hz: float = 0.0, snr_db: float = 0.0,
                  evm_snr_db: float = 0.0, sssnr: tuple = (),
                  sigb_ok=None) -> PacketResult:
    """FCS / A-MPDU deaggregation from already-packed PSDU bytes
    (parity: lib/decode_impl.cc:325-427 packetAssemble)."""
    if fmt == F.VHT:
        mpdus = [s.mpdu for s in deaggregate_vht(psdu) if s.fcs_ok]
        ok = len(mpdus) > 0
    elif ampdu:
        mpdus = [s.mpdu for s in deaggregate_ht(psdu) if s.fcs_ok]
        ok = len(mpdus) > 0
    else:
        ok = fcs_ok(psdu)
        mpdus = [psdu] if ok else []
    return PacketResult(fmt=fmt, mcs=mod.mcs, psdu=psdu, fcs_ok=ok,
                        mpdus=mpdus, cfo_hz=cfo_hz, snr_db=snr_db,
                        evm_snr_db=evm_snr_db,
                        sssnr=sssnr if sssnr else (evm_snr_db,),
                        sigb_ok=sigb_ok)


# ---------------------------------------------------------------------------
# capture-level receiver (auto-detecting)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Plan:
    """One detected packet's decode parameters (host-side planning)."""
    mod: Mod
    n_sym: int
    psdu_len: int
    ampdu: bool
    win_start: int       # absolute capture index of its SIG window start
    ltf_start: int       # LTF data start relative to win_start
    cfo: float
    cfo_hz: float
    snr: float
    ndp: bool = False
    mu: bool = False     # downlink MU PPDU (own-stream decode)
    stream_idx: int = 0  # this STA's space-time stream index in the group
    n_sts_tot: int = 0   # group total streams (sets nLTF / data offset)
    sigb_crc: int = 0    # expected CRC-8 of the SIG-B pre-tail bits


@dataclasses.dataclass
class _MuCand:
    """An MU candidate window awaiting its SIG-B (mcs, len) decode."""
    win_start: int
    ltf_start: int
    cfo: float
    cfo_hz: float
    snr: float
    n_sym: int
    stream_idx: int
    n_sts_tot: int


class SisoReceiver:
    """Decode packets from a capture with automatic format detection.

    Workflow parity with examples/rx.grc (trigger -> sync -> signal ->
    demod -> decode), restructured for batched device throughput: the
    capture is uploaded ONCE (optionally int8-quantized, `ingest="int8"` —
    radio front-ends deliver 8-12 bit I/Q anyway), all SIG parsing runs as one batched jit
    dispatch with a single packed-meta fetch, and the DATA pass groups
    packets by (Mod, nSym-bucket) with ONE dispatch per group and packed
    bytes fetched back. Per-capture device round trips: 1 upload + 1 meta
    fetch + 1 small fetch per group — instead of 2 per packet.
    """

    def __init__(self, sample_rate_hz: float = 20e6, stats=None,
                 ingest: str = "auto", trigger: str = "host",
                 mu_pos: int = 0, mu_gid: Optional[int] = None):
        """mu_pos/mu_gid: this station's MU-MIMO group position and group
        id (parity: the demod block's mupos/mugid parameters,
        grc/ieee80211_demod.block.yml). When mu_gid is set, downlink MU
        PPDUs addressed to that group decode in the same batched streaming
        passes as SU traffic (mu/sounding.MuStaDataDecoder lanes); when
        None (default), MU planning is skipped at zero cost."""
        self.fs = sample_rate_hz
        self.q = int(round(sample_rate_hz / 20e6))
        if self.q not in (1, 2, 4):
            raise ValueError("sample rate must be 20/40/80 MHz")
        if ingest not in ("auto", "f32", "int8"):
            raise ValueError("ingest must be 'auto', 'f32' or 'int8'")
        if trigger not in ("host", "device"):
            raise ValueError("trigger must be 'host' or 'device'")
        self.bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[self.q]
        self.ingest = ingest
        self.trigger = trigger
        self.mu_pos = mu_pos
        self.mu_gid = mu_gid
        from ..utils.metrics import DecodeStats
        self.stats = stats if stats is not None else DecodeStats()

    # -- upload ------------------------------------------------------------
    def _upload(self, capture: np.ndarray):
        """Quantize + zero-pad the capture to a pow2 length and ship it to
        the device once. Returns (cap_dev, dequant_scale, npad).

        ingest="auto" sends float32 for short captures and peak-normalized
        int8 beyond ~1M samples: 8-bit I/Q costs -48 dB quantization noise
        — far below any decodable operating point (radio front-ends
        deliver 8-12 bit I/Q to begin with) — and int8 quarters the
        host->device bytes and enables the fused native
        scan-and-quantize ingest pass (_ingest).

        Caveat of the peak normalization: a single strong impulse in a
        capture compresses everything else's dynamic range (e.g. one
        +30 dB spike costs the rest 5 effective bits). If the front-end
        does not already AGC-limit impulses, pass ingest="f32"."""
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = len(capture)
        npad = next_pow2(n + 4096, lo=1 << 15)
        mode = self.ingest
        if mode == "auto":
            mode = "int8" if npad > (1 << 20) else "f32"
        n_r = min(_round_64k(n), npad)
        if mode == "int8":
            buf = np.zeros((n_r, 2), np.int8)
            from .. import native
            s = native.quantize_int8(capture, buf[:n])
            if s is None:                        # no native toolchain
                peak = float(max(np.abs(capture.real).max(initial=0.0),
                                 np.abs(capture.imag).max(initial=0.0),
                                 1e-12))
                sc = 126.0 / peak
                buf[:n, 0] = np.clip(np.round(capture.real * sc), -127, 127)
                buf[:n, 1] = np.clip(np.round(capture.imag * sc), -127, 127)
                s = 1.0 / sc
            return (_pad_capture(jnp.asarray(buf), npad), jnp.float32(s),
                    npad)
        buf = np.zeros((n_r, 2), np.float32)
        buf[:n] = capture.view(np.float32).reshape(-1, 2)
        return _pad_capture(jnp.asarray(buf), npad), jnp.float32(1.0), npad

    def _ingest(self, capture: np.ndarray):
        """Trigger scan + quantize + upload with the fewest host passes.

        On the int8 path the native runtime fuses the STF trigger scan,
        peak tracking and int8 quantization into one call over the capture
        (native/phyrt.cc phyrt_scan_quantize); the upload is submitted
        before SIG parsing so the transfer overlaps host planning.
        Returns (t0s, cap_dev, scale, npad)."""
        from .. import native
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = len(capture)
        npad = next_pow2(n + 4096, lo=1 << 15)
        mode = self.ingest
        if mode == "auto":
            mode = "int8" if npad > (1 << 20) else "f32"
        if mode == "int8" and native.available():
            buf = np.zeros((min(_round_64k(n), npad), 2), np.int8)
            t0s, s = native.scan_quantize(
                capture, buf[:n], thresh=0.5, plateau=20 * self.q,
                min_gap=MIN_TRIGGER_GAP * self.q, lag=16 * self.q)
            return (np.asarray(t0s, dtype=np.int64),
                    _pad_capture(jnp.asarray(buf), npad),
                    jnp.float32(s), npad)
        t0s = np.asarray(sync.find_triggers_np(
            capture, q=self.q, min_gap=MIN_TRIGGER_GAP), dtype=np.int64)
        cap_dev, scale, npad = self._upload(capture)
        return t0s, cap_dev, scale, npad

    def _ingest_device(self, capture: np.ndarray, k_max: int = 4096):
        """Quantize + upload + dispatch the IN-GRAPH trigger scan (async).

        The host's only pass over the samples is the (vectorizable) int8
        quantization; the O(N) sliding-correlation trigger scan — the
        dominant host cost of the streaming receiver — runs on the device
        against the same upload the decode uses
        (ops/sync.trigger_scan_capture). Returns
        (trig_dev, ntrig_dev, cap_dev, scale, npad); the trigger fetch is
        already in flight (copy_to_host_async)."""
        from .. import native
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = len(capture)
        npad = next_pow2(n + 4096, lo=1 << 15)
        mode = self.ingest
        if mode == "auto":
            mode = "int8" if npad > (1 << 20) else "f32"
        n_r = min(_round_64k(n), npad)
        if mode == "int8":
            buf = np.zeros((n_r, 2), np.int8)
            s = native.quantize_int8(capture, buf[:n])
            if s is None:
                peak = float(max(np.abs(capture.real).max(initial=0.0),
                                 np.abs(capture.imag).max(initial=0.0),
                                 1e-12))
                sc = 126.0 / peak
                buf[:n, 0] = np.clip(np.round(capture.real * sc), -127, 127)
                buf[:n, 1] = np.clip(np.round(capture.imag * sc), -127, 127)
                s = 1.0 / sc
            cap_dev = _pad_capture(jnp.asarray(buf), npad)
            scale = jnp.float32(s)
        else:
            buf = np.zeros((n_r, 2), np.float32)
            buf[:n] = capture.view(np.float32).reshape(-1, 2)
            cap_dev = _pad_capture(jnp.asarray(buf), npad)
            scale = jnp.float32(1.0)
        trig, ntrig = sync.trigger_scan_capture(cap_dev, scale, k_max=k_max,
                                                q=self.q,
                                                min_gap=MIN_TRIGGER_GAP)
        trig.copy_to_host_async()
        ntrig.copy_to_host_async()
        return trig, ntrig, cap_dev, scale, npad

    def _decode_captures_device(self, caps) -> List[List[PacketResult]]:
        """decode_captures with the trigger scan ON DEVICE: a 2-deep
        software pipeline so every device fetch (trigger array, packed
        meta) has a full iteration of latency budget before the main
        thread needs it — the device round trip overlaps other captures'
        work instead of blocking."""
        from concurrent.futures import ThreadPoolExecutor
        n = len(caps)
        st1: list = [None] * n      # (trig, ntrig, cap_dev, scale, npad)
        st2: list = [None] * n      # (t0s, cap_dev, scale, npad, packed, tc)
        st3: list = [None] * n      # futs

        def stage_a(k):
            """Trigger fetch -> SIG dispatch."""
            trig, ntrig, cap_dev, scale, npad = st1[k]
            n_t = int(np.asarray(ntrig))
            t0s = np.asarray(trig)[:min(n_t, trig.shape[0])].astype(np.int64)
            if len(t0s) > 0:
                packed, t_clamp = self._dispatch_sigs(cap_dev, scale, npad,
                                                      t0s)
                packed.copy_to_host_async()
                st2[k] = (t0s, cap_dev, scale, npad, packed, t_clamp)
            st1[k] = None

        def stage_b(k):
            """Meta fetch -> plan -> DATA dispatch."""
            if st2[k] is None:
                return
            t0s, cap_dev, scale, npad, packed, t_clamp = st2[k]
            meta = self._finish_sigs(packed, t_clamp)
            self.stats.n_trigger += len(t0s)
            self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
            plans, ndp_plans = self._plan_batch(caps[k].shape[-1], meta,
                                               len(t0s))
            self._surface_stream_ndps(k, caps[k], ndp_plans)
            st3[k] = self._dispatch_with_mu(cap_dev, scale, npad, plans,
                                            caps[k].shape[-1], meta,
                                            len(t0s))
            st2[k] = None

        out: List[List[PacketResult]] = [[] for _ in range(n)]

        def stage_c(k):
            if st3[k] is None:
                return
            results = []
            for i, r in self._finish_plans(st3[k]):
                self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
                results.append(r)
            out[k] = results
            st3[k] = None

        ex = ThreadPoolExecutor(max_workers=1)
        try:
            fut = ex.submit(self._ingest_device, caps[0]) if n else None
            for k in range(n):
                st1[k] = fut.result()
                fut = ex.submit(self._ingest_device, caps[k + 1]) \
                    if k + 1 < n else None
                if k >= 1:
                    stage_a(k - 1)
                if k >= 2:
                    stage_b(k - 2)
                if k >= 4:
                    stage_c(k - 4)   # in-loop assembly (see decode_captures)
            if n:
                stage_a(n - 1)
                if n >= 2:
                    stage_b(n - 2)
                stage_b(n - 1)
        finally:
            ex.shutdown(wait=False)
        for k in range(n):
            stage_c(k)
        return out

    # -- main entry --------------------------------------------------------
    def decode_capture(self, capture: np.ndarray,
                       max_window: Optional[int] = None) -> List[PacketResult]:
        del max_window  # packet windows are sized from the decoded length
        return self.decode_capture_full(capture)[0]

    def decode_capture_full(self, capture: np.ndarray):
        """Decode data packets AND surface NDP channel reports.

        Returns (packets, ndp_captures): the reference's decode block emits
        a type-20 channel blob from the same RX chain that emits data
        (lib/decode_impl.cc:100-121); here an NDP detected during planning
        (VHT, nSym == 0) yields an mu.sounding.NdpCapture with the
        CFO-corrected VHT-LTF windows, ready for SVD feedback.
        """
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        t0s, cap_dev, scale, npad = self._ingest(capture)
        results: List[PacketResult] = []
        ndps = []
        if len(t0s) == 0:
            return results, ndps
        meta = self._parse_sigs(cap_dev, scale, npad, t0s)
        self.stats.n_trigger += len(t0s)
        self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
        plans, ndp_plans = self._plan_batch(len(capture), meta, len(t0s))
        for p in ndp_plans:
            ndps.append(self._extract_ndp(capture, p))
        futs = self._dispatch_with_mu(cap_dev, scale, npad, plans,
                                      len(capture), meta, len(t0s))
        self.stats.n_ndp += sum(n is not None for n in ndps)
        for i, r in self._finish_plans(futs):
            self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
            results.append(r)
        return results, [n for n in ndps if n is not None]

    def decode_captures(self, captures) -> List[List[PacketResult]]:
        """Pipelined decode of a STREAM of captures.

        Same per-capture results as decode_capture, but the three phases
        are software-pipelined across the whole stream so every device
        round trip and device<->host transfer overlaps work from the other
        captures: (1) ingest + async SIG dispatch for all captures, (2)
        meta fetch -> plan -> async DATA dispatch per capture, (3)
        overlapped result fetch + MAC assembly. This is the sustained-
        throughput entry the reference's streaming flowgraph corresponds
        to (examples/rx.grc runs at 20 Msps continuously); bench.py
        measures it as api_stream_samples_per_sec. Data packets only —
        decode_captures_full additionally surfaces NDP channel reports
        inline with the stream.
        """
        from concurrent.futures import ThreadPoolExecutor
        caps = [np.ascontiguousarray(c, dtype=np.complex64)
                for c in captures]
        if self.trigger == "device":
            return self._decode_captures_device(caps)
        n = len(caps)
        st2: list = [None] * n
        st3: list = [None] * n

        def phase2(k):
            """Meta fetch -> vectorized plan -> async DATA dispatch."""
            if st2[k] is None:
                return None
            t0s, cap_dev, scale, npad, packed, t_clamp = st2[k]
            meta = self._finish_sigs(packed, t_clamp)
            self.stats.n_trigger += len(t0s)
            self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
            plans, ndp_plans = self._plan_batch(caps[k].shape[-1], meta,
                                               len(t0s))
            self._surface_stream_ndps(k, caps[k], ndp_plans)
            return self._dispatch_with_mu(cap_dev, scale, npad, plans,
                                          caps[k].shape[-1], meta, len(t0s))

        # The ingest pass (native scan+quantize, releases the GIL) runs on
        # a worker thread one capture ahead, while the main thread plans
        # and dispatches the PREVIOUS capture — so host sweeps, device
        # compute and transfers all overlap (software pipeline,
        # depth 1). Run-ahead is BOUNDED: ingest k+1 is submitted only
        # once k has been consumed, and st2[k] is dropped as soon as
        # phase2(k) has dispatched its DATA programs — so device and host
        # buffers are freed as the stream advances instead of growing
        # linearly with its length (continuous-streaming safety).
        out: List[List[PacketResult]] = [[] for _ in range(n)]
        asm_futs: list = [None] * n

        def phase3(k, asm):
            """Hand result fetch + MAC assembly to the assembly worker:
            np.asarray blocks on the device round trip and the A-MPDU/FCS
            walks are host work — both overlap the main thread's planning
            and the ingest worker's scanning (second pipeline lane).
            assembly="worker" offloads to a thread; on a 2-core host the
            extra thread lost to contention with the ingest worker and the
            main thread. Default "inline"; the lane stays for wider
            hosts."""
            if st3[k] is None:
                return
            if getattr(self, "assembly", "inline") == "inline":
                from concurrent.futures import Future
                f = Future()
                f.set_result(self._finish_plans(st3[k]))
                asm_futs[k] = f
            else:
                asm_futs[k] = asm.submit(self._finish_plans, st3[k])
            st3[k] = None

        ex = ThreadPoolExecutor(max_workers=1)
        asm = ThreadPoolExecutor(max_workers=1)
        try:
            fut = ex.submit(self._ingest, caps[0]) if n else None
            for k in range(n):
                t0s, cap_dev, scale, npad = fut.result()
                fut = ex.submit(self._ingest, caps[k + 1]) \
                    if k + 1 < n else None
                if len(t0s) > 0:
                    packed, t_clamp = self._dispatch_sigs(
                        cap_dev, scale, npad, t0s)
                    packed.copy_to_host_async()
                    st2[k] = (t0s, cap_dev, scale, npad, packed, t_clamp)
                del cap_dev
                if k >= 2:
                    # plan k-2 (not k-1): the packed-meta fetch then has
                    # TWO ingests of latency cover, so a slow device
                    # round trip stays off the critical path
                    st3[k - 2] = phase2(k - 2)
                    st2[k - 2] = None
                if k >= 4:
                    # submit k-4's assembly INSIDE the loop: its decode
                    # dispatches have had two full iterations of device
                    # time, so the worker's fetch is a no-wait
                    phase3(k - 4, asm)
            for k in (n - 2, n - 1):
                if k >= 0:
                    st3[k] = phase2(k)
                    st2[k] = None
            for k in range(n):                          # drain the tail
                phase3(k, asm)
            for k in range(n):
                if asm_futs[k] is None:
                    continue
                results = []
                for i, r in asm_futs[k].result():
                    self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
                    results.append(r)
                out[k] = results
        finally:
            ex.shutdown(wait=False)
            asm.shutdown(wait=False)
        return out

    def decode_captures_full(self, captures):
        """decode_captures that ALSO surfaces NDP channel captures.

        Returns (results, ndps): per-capture packet lists plus per-capture
        lists of NDP channel captures — the streaming analog of
        decode_capture_full (the reference's continuous RX emits type-20
        channel reports inline with data, lib/decode_impl.cc:100-121).
        """
        self._stream_ndps = ndps = [[] for _ in captures]
        try:
            results = self.decode_captures(captures)
        finally:
            self._stream_ndps = None
        return results, ndps

    _stream_ndps = None

    def _surface_stream_ndps(self, k: int, capture: np.ndarray, ndp_plans):
        if self._stream_ndps is None:
            self.stats.n_ndp += len(ndp_plans)
            return
        for p in ndp_plans:
            nd = self._extract_ndp(capture, p)
            if nd is not None:
                self.stats.n_ndp += 1
                self._stream_ndps[k].append(nd)

    def _extract_ndp(self, capture: np.ndarray, p: _Plan):
        """CFO-corrected VHT-LTF windows of a detected NDP (host side —
        the LTFs are a few hundred samples; parity with the mu2x1chan tag
        path, lib/demod_impl.cc:238-271,396-399)."""
        from ..mu.sounding import NdpCapture
        n_ltf = p.mod.nLTF
        start = p.win_start + p.ltf_start
        wins = []
        for l in range(n_ltf):
            s = start + (OFF_NLLTF + 80 * l + 16 - 8) * self.q
            seg = capture[s:s + 64 * self.q]
            if len(seg) != 64 * self.q:
                return None
            ramp = np.exp(1j * p.cfo * (np.arange(len(seg)) + s))
            wins.append((seg * ramp).astype(np.complex64))
        return NdpCapture(ltf_iq=np.concatenate(wins), cfo_rad=p.cfo,
                          snr_db=p.snr)

    def _dispatch_sigs(self, cap_dev, scale, npad, t0s):
        """Submit the batched SIG parse (async); returns (packed_dev,
        t_clamp) for _finish_sigs.

        The non-legacy STF mid-packet also correlates at lag 16q and can
        re-fire the trigger (the reference re-arms the same way,
        lib/trigger_impl.cc:92-109); those spurious windows fail the SIG
        gates in _plan_batch.
        """
        wlen = (SIGPARSE_WIN + 320) * self.q
        bpad = -(-len(t0s) // 32) * 32
        t_clamp = np.zeros(bpad, np.int32)
        delta = np.zeros(bpad, np.int32)
        tc = np.minimum(t0s, npad - wlen)
        t_clamp[:len(t0s)] = tc
        delta[:len(t0s)] = t0s - tc
        packed = sig_parse_capture(cap_dev, scale, jnp.asarray(t_clamp),
                                   jnp.asarray(delta), wlen=wlen, q=self.q)
        return packed, t_clamp

    @staticmethod
    def _finish_sigs(packed, t_clamp) -> dict:
        meta = _unpack_meta(np.asarray(packed))
        meta["win_start"] = t_clamp
        return meta

    def _parse_sigs(self, cap_dev, scale, npad, t0s) -> dict:
        """Batched SIG parse of all trigger windows; one packed fetch."""
        return self._finish_sigs(*self._dispatch_sigs(cap_dev, scale, npad,
                                                      t0s))

    def _decoder_for(self, mod: Mod, n_sym_bucket: int):
        """Decoder factory hook (the dual-chain receiver overrides it to
        route nSS==2 plans to the MIMO detector and nSS==1/legacy plans to
        the MRC decoder)."""
        return get_data_decoder(mod, n_sym_bucket)

    def _dispatch_plans(self, cap_dev, scale, npad, plans,
                        decoder_for=None):
        """Group plans by (Mod, bucket) and submit one jit program per
        group (async). Returns futs for _finish_plans.

        decoder_for: optional decoder-factory override (the dual-chain
        receiver's exact-ML retry pass re-dispatches failed 2x2 plans
        through it)."""
        groups: dict = {}
        for i, p in plans:
            groups.setdefault((p.mod, _bucket(p.n_sym), p.mu, p.stream_idx,
                               p.n_sts_tot), []).append((i, p))
        futs = []
        for (mod, nb, mu, si, nt), items in groups.items():
            if mu:
                from ..mu.sounding import get_mu_sta_data_decoder
                dec = get_mu_sta_data_decoder(mod, nb, si, nt)
            else:
                dec = (decoder_for or self._decoder_for)(mod, nb)
            w = dec.window_capacity()
            g = len(items)
            gp = group_pad(g)
            t_abs = np.zeros(gp, np.int32)
            ltf = np.zeros(gp, np.int32)
            cfo = np.zeros(gp, np.float32)
            nv = np.ones(gp, np.int32)
            crc = np.zeros(gp, np.int32)
            for j, (i, p) in enumerate(items):
                tc = min(p.win_start, npad - w)
                t_abs[j] = tc
                ltf[j] = p.ltf_start + (p.win_start - tc)
                cfo[j] = p.cfo
                nv[j] = p.n_sym
                crc[j] = p.sigb_crc
            if gp > g:       # pad rows replicate row 0 (results ignored)
                t_abs[g:] = t_abs[0]
                ltf[g:] = ltf[0]
                cfo[g:] = cfo[0]
                nv[g:] = nv[0]
                crc[g:] = crc[0]
            args = (cap_dev, scale, jnp.asarray(t_abs), jnp.asarray(ltf),
                    jnp.asarray(cfo), jnp.asarray(nv))
            out = (dec.decode_from_capture(*args, jnp.asarray(crc))
                   if mu else dec.decode_from_capture(*args))
            # fetch only the bytes any packet in the group can use: the
            # packed rows are bucket-capacity sized, but the device->host
            # link runs ~25-35 MB/s, so a group of short packets in a big
            # bucket pays real milliseconds for padding bytes. 256-byte
            # shape buckets keep the slice-program count bounded.
            nb_need = 2 + max(p.psdu_len for _, p in items)
            nb_pad = min(-(-nb_need // 256) * 256, int(out[0].shape[1]))
            if nb_pad < out[0].shape[1]:
                out = (out[0][:, :nb_pad],) + tuple(out[1:])
            futs.append((items, out))
        # start ALL device->host copies before blocking on any: the round
        # trip is paid once for the whole capture instead of once per
        # group fetch
        for _, out in futs:
            for arr in out:
                arr.copy_to_host_async()
        return futs

    @staticmethod
    def _finish_plans(futs):
        collected = []
        for items, (packed_b, evm, sigb) in futs:
            pb = np.asarray(packed_b)
            # one bulk tolist() per group: per-packet np scalar indexing +
            # float()/bool() conversions cost ~8 us/packet at 1k packets
            ev = np.asarray(evm).tolist()
            sb = np.asarray(sigb).tolist()
            per_stream = ev and isinstance(ev[0], list)
            for j, (i, p) in enumerate(items):
                if p.mu and not sb[j]:
                    # MU SIG-B CRC-8 mismatch vs the SERVICE field: the
                    # (mcs, len) decode is unreliable — drop, as the
                    # reference does (signalParserVhtB)
                    continue
                psdu = pb[j, 2:2 + p.psdu_len].tobytes()
                if per_stream:
                    ev_j = ev[j]
                    evm_j = sum(ev_j) / len(ev_j)
                    sssnr = tuple(ev_j)
                else:
                    evm_j = ev[j]
                    sssnr = (evm_j,)
                r = assemble_psdu(
                    p.mod.fmt, p.mod, psdu, p.ampdu, p.cfo_hz, p.snr,
                    evm_j, sssnr=sssnr,
                    sigb_ok=(sb[j] if p.mod.fmt == F.VHT else None))
                r.mu = p.mu
                collected.append((i, r))
        collected.sort(key=lambda t: t[0])
        return collected

    def _run_plans(self, cap_dev, scale, npad, plans):
        """Dispatch all groups, fetch + assemble. Returns [(trigger_idx,
        PacketResult)] in trigger order."""
        return self._finish_plans(
            self._dispatch_plans(cap_dev, scale, npad, plans))

    def _dispatch_with_mu(self, cap_dev, scale, npad, plans, cap_len, meta,
                          n):
        """SU dispatch plus (when mu_gid is configured) the two-stage MU
        chain — the MU SIG-B round trip overlaps the SU decode dispatches.
        Returns futs for _finish_plans."""
        mu_cands = self._plan_mu_batch(cap_len, meta, n)
        sigb_futs = (self._dispatch_mu_sigb(cap_dev, scale, npad, mu_cands)
                     if mu_cands else [])
        futs = self._dispatch_plans(cap_dev, scale, npad, plans)
        if sigb_futs:
            futs += self._dispatch_plans(cap_dev, scale, npad,
                                         self._plan_mu_data(sigb_futs))
        return futs

    # -- downlink MU-STA decode (streaming, batched) -----------------------
    # The reference decodes the station's MU stream inside its demod state
    # machine (lib/demod_impl.cc:27-40 mupos/mugid, :347-378). Here MU
    # windows detected during planning go through a batched SIG-B lane
    # (one dispatch per (stream_idx, nSTS) group, one packed-scalar fetch)
    # to learn each packet's (mcs, len), then through bucketed
    # MuStaDataDecoder lanes exactly like every other decoder group.

    def _plan_mu_batch(self, cap_len: int, meta, n: int):
        """MU candidate windows: VHT SIG-A with gid == self.mu_gid whose
        group layout gives this station a single stream (any capture
        bandwidth — wideband MU is beyond the reference's 20 MHz GR-TRX
        but inside the PY-TB golden envelope). Returns [(i, _MuCand)]
        for _dispatch_mu_sigb."""
        if self.mu_gid is None:
            return []
        lsig_ok = np.asarray(meta["lsig_ok"][:n]).astype(bool)
        vht_ok = np.asarray(meta["vht_ok"][:n]).astype(bool)
        snr = np.asarray(meta["snr"][:n], np.float64)
        l_mcs = np.asarray(meta["l_mcs"][:n], np.int64)
        l_len = np.asarray(meta["l_len"][:n], np.int64)
        vb = np.asarray(meta["vht_bits"][:n], np.int64)
        gid = vb[:, 4:10] @ (1 << np.arange(6, dtype=np.int64))
        v_bw = vb[:, 0] + 2 * vb[:, 1]
        v_sgi = vb[:, 24].astype(bool)
        # per-user NSTS fields: 4 users x 3 bits at SIG-A bits 10..21
        nsts_u = np.stack([vb[:, 10 + 3 * u:13 + 3 * u]
                           @ (1 << np.arange(3, dtype=np.int64))
                           for u in range(4)], axis=1)      # [n, 4]
        n_tot = nsts_u.sum(axis=1)
        cand = (lsig_ok & vht_ok & (snr > 0.0) & (l_mcs == 0)
                & (gid == self.mu_gid) & (v_bw == int(self.bw)) & ~v_sgi
                & (nsts_u[:, self.mu_pos] == 1)
                & (n_tot >= 1) & (n_tot <= 4))
        if not np.any(cand):
            return []
        win_start = np.asarray(meta["win_start"][:n], np.int64)
        ltf_start = np.asarray(meta["ltf_start"][:n], np.int64)
        cfo = np.asarray(meta["cfo"][:n], np.float64)
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        n_ltf = np.asarray(tables.N_LTF)[np.minimum(n_tot, 4)]
        n_sym_l = -(-(l_len * 8 + 16 + 6) // 24)
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        stream_idx = np.concatenate(
            [np.zeros((n, 1), np.int64),
             np.cumsum(nsts_u, axis=1)[:, :-1]], axis=1)[:, self.mu_pos]
        out = []
        for i in np.flatnonzero(cand):
            if n_sym[i] <= 0:
                continue            # MU NDPs don't exist; gid'd NDP = junk
            # EXACT packet end (SIG-B + data; a packet whose last sample
            # is the capture's last sample is complete — the device
            # capture is zero-padded past cap_len)
            ext = (int(ltf_start[i])
                   + (448 + 80 * int(n_ltf[i]) + 80
                      + int(n_sym[i]) * 80) * self.q)
            if int(win_start[i]) + ext > cap_len:
                continue
            out.append((i, _MuCand(int(win_start[i]), int(ltf_start[i]),
                                   float(cfo[i]), float(cfo_hz[i]),
                                   float(snr[i]), int(n_sym[i]),
                                   int(stream_idx[i]), int(n_tot[i]))))
        return out

    def _dispatch_mu_sigb(self, cap_dev, scale, npad, mu_cands):
        """Batched SIG-B decode per (stream_idx, nSTS-total) group (async;
        copy_to_host_async already issued). Returns futs for _plan_mu_data."""
        from ..mu.sounding import mu_sigb_parse_capture
        groups: dict = {}
        for i, c in mu_cands:
            groups.setdefault((c.stream_idx, c.n_sts_tot), []).append((i, c))
        futs = []
        for (si, nt), items in groups.items():
            wlen = (272 + 448 + 80 * int(tables.N_LTF[nt]) + 160) * self.q
            g = len(items)
            gp = group_pad(g)
            t_abs = np.zeros(gp, np.int32)
            ltf = np.zeros(gp, np.int32)
            cfo = np.zeros(gp, np.float32)
            for j, (i, c) in enumerate(items):
                tc = min(c.win_start, npad - wlen)
                t_abs[j] = tc
                ltf[j] = c.ltf_start + (c.win_start - tc)
                cfo[j] = c.cfo
            if gp > g:
                t_abs[g:] = t_abs[0]
                ltf[g:] = ltf[0]
                cfo[g:] = cfo[0]
            words = mu_sigb_parse_capture(
                cap_dev, scale, jnp.asarray(t_abs), jnp.asarray(ltf),
                jnp.asarray(cfo), wlen=wlen, stream_idx=si, n_sts_total=nt,
                q=self.q)
            words.copy_to_host_async()
            futs.append((items, words))
        return futs

    def _plan_mu_data(self, sigb_futs):
        """Fetch the SIG-B words, apply the (mcs, len) gates, and build
        the final MU _Plans for _dispatch_plans."""
        from ..mu.sounding import MU_SIGB_LEN
        n_len = MU_SIGB_LEN[self.bw]
        plans = []
        for items, words in sigb_futs:
            wd = np.asarray(words)
            for j, (i, c) in enumerate(items):
                bits = (wd[j] >> np.arange(n_len + 4)) & 1
                mcs = int(bits[n_len:n_len + 4] @ (1 << np.arange(4)))
                try:
                    mod = Mod(F.VHT, mcs, self.bw, 1)
                except ValueError:
                    continue          # invalid 1-SS MCS at this bandwidth
                psdu_len = (c.n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
                if (c.n_sym * mod.nDBPS > 33000 or psdu_len <= 0):
                    continue
                crc = int(np.asarray(crc8_bits(list(bits[:n_len + 4])))
                          @ (1 << np.arange(8)))
                plans.append((i, _Plan(
                    mod, c.n_sym, psdu_len, True, c.win_start, c.ltf_start,
                    c.cfo, c.cfo_hz, c.snr, mu=True,
                    stream_idx=c.stream_idx, n_sts_tot=c.n_sts_tot,
                    sigb_crc=crc)))
        return plans

    def _plan_batch(self, cap_len: int, meta, n: int):
        """Vectorized packet planning over all n trigger windows.

        Same gates and geometry as _plan_one (kept as the single-window
        reference implementation; tests/test_bucketing.py asserts parity),
        but the SIG-field bit arithmetic and the gate masks run as numpy
        array ops — the per-packet Python cost drops from ~36 us to ~8 us,
        which matters once captures carry thousands of packets.
        Returns (data_plans [(i, _Plan)], ndp_plans [_Plan])."""
        snr = np.asarray(meta["snr"][:n], np.float64)
        lsig_ok = np.asarray(meta["lsig_ok"][:n]).astype(bool)
        cand = lsig_ok & (snr > 0.0)
        plans: list = []
        ndps: list = []
        if not np.any(cand):
            return plans, ndps
        win_start = np.asarray(meta["win_start"][:n], np.int64)
        ltf_start = np.asarray(meta["ltf_start"][:n], np.int64)
        cfo = np.asarray(meta["cfo"][:n], np.float64)
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        l_mcs = np.asarray(meta["l_mcs"][:n], np.int64)
        l_len = np.asarray(meta["l_len"][:n], np.int64)
        ht_ok = np.asarray(meta["ht_ok"][:n]).astype(bool)
        vht_ok = np.asarray(meta["vht_ok"][:n]).astype(bool)
        imag_dom = np.asarray(meta["nl1_imag_dom"][:n]).astype(bool)
        hb = np.asarray(meta["ht_bits"][:n], np.int64)
        vb = np.asarray(meta["vht_bits"][:n], np.int64)
        ht_mcs = hb[:, :7] @ (1 << np.arange(7, dtype=np.int64))
        ht_bw40 = hb[:, 7].astype(bool)
        ht_len = hb[:, 8:24] @ (1 << np.arange(16, dtype=np.int64))
        ht_aggre = hb[:, 27].astype(bool)
        ht_sgi = hb[:, 31].astype(bool)
        v_bw = vb[:, 0] + 2 * vb[:, 1]
        v_gid = vb[:, 4:10] @ (1 << np.arange(6, dtype=np.int64))
        v_su = (v_gid == 0) | (v_gid == 63)   # gid 1..62 = downlink MU
                                              # (-> _plan_mu_batch, not SU)
        v_nsts = (vb[:, 10:13] @ (1 << np.arange(3, dtype=np.int64))) + 1
        v_sgi = vb[:, 24].astype(bool)
        v_mcs = vb[:, 28:32] @ (1 << np.arange(4, dtype=np.int64))
        # format pick, _pick_nl_format precedence, applied when l_mcs == 0
        pick_vht = vht_ok & (~imag_dom | ~ht_ok)
        pick_ht = ht_ok & ~pick_vht
        is_nl = cand & (l_mcs == 0)
        is_vht = is_nl & pick_vht & v_su
        is_ht = is_nl & pick_ht
        is_l = cand & ~is_vht & ~is_ht & ~(is_nl & pick_vht & ~v_su)
        # VHT nSym budget from the spoofed L-SIG length (vectorized)
        v_nltf = np.asarray(tables.N_LTF)[np.minimum(v_nsts, 4)]
        v_nsym_l = -(-(l_len * 8 + 16 + 6) // 24)
        v_nsym = v_nsym_l - 2 - 1 - v_nltf - 1

        # n_sym fully vectorized (ppdu_params_nonaggregate's ceil formula;
        # nES == 1 across this 20 MHz SISO envelope) so the loop below
        # only constructs accepted plans — no per-packet sizing calls
        ndbps_l = np.asarray([24, 36, 48, 72, 96, 144, 192, 216],
                             np.int64)[np.clip(l_mcs, 0, 7)]
        l_nsym = -(-(8 * l_len + 16 + 6) // ndbps_l)
        ht_tab = (np.asarray([54, 108, 162, 216, 324, 432, 486, 540],
                             np.int64) if self.bw == BW.BW40 else
                  np.asarray([26, 52, 78, 104, 156, 208, 234, 260],
                             np.int64))
        ndbps_ht = ht_tab[np.clip(ht_mcs, 0, 7)]
        ht_nsym = -(-(8 * ht_len + 16 + 6) // ndbps_ht)

        qq = self.q
        # completeness gates use the EXACT per-format packet end (a packet
        # whose last sample IS the capture's last sample is complete; the
        # device capture is zero-padded, so window reads past cap_len see
        # zeros, not garbage). L data starts at 208, HT at 528 (1 LTF),
        # VHT at 608 (+SIG-B), in 20 MHz units from the LTF data start.
        lim = cap_len

        for i in np.flatnonzero(cand):
            ws, ls = int(win_start[i]), int(ltf_start[i])
            c, chz, sn = float(cfo[i]), float(cfo_hz[i]), float(snr[i])
            if is_l[i]:
                if qq != 1 or not (14 <= l_len[i] <= 4095):
                    continue
                n_sym = int(l_nsym[i])
                if (n_sym * ndbps_l[i] > 33000
                        or ws + ls + (208 + n_sym * 80) > lim):
                    continue
                plans.append((i, _Plan(Mod(F.L, int(l_mcs[i])), n_sym,
                                       int(l_len[i]), False, ws, ls, c,
                                       chz, sn)))
            elif is_ht[i]:
                if (ht_bw40[i] != (self.bw == BW.BW40) or ht_mcs[i] > 7
                        or ht_sgi[i] or not (1 <= ht_len[i] <= 4095)):
                    continue          # mcs>7 (2 streams) -> MimoReceiver
                n_sym = int(ht_nsym[i])
                if (n_sym * ndbps_ht[i] > 33000
                        or ws + ls + (528 + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(Mod(F.HT, int(ht_mcs[i]), self.bw,
                                           1, False), n_sym,
                                       int(ht_len[i]), bool(ht_aggre[i]),
                                       ws, ls, c, chz, sn)))
            elif is_vht[i]:
                if (v_bw[i] != int(self.bw) or v_sgi[i]
                        or not (1 <= v_nsts[i] <= 4)):
                    continue
                if v_nsym[i] <= 0:
                    ndps.append(_Plan(Mod(F.VHT, 0, self.bw, int(v_nsts[i])),
                                      0, 0, False, ws, ls, c, chz, sn,
                                      ndp=True))
                    continue
                if v_nsts[i] != 1:
                    continue          # SISO receiver; 2x2 -> MimoReceiver
                mod = Mod(F.VHT, int(v_mcs[i]), self.bw, 1, False)
                n_sym = int(v_nsym[i])
                psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
                if (n_sym * mod.nDBPS > 33000 or psdu_len > 4095
                        or ws + ls + (608 + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(mod, n_sym, psdu_len, True, ws, ls,
                                       c, chz, sn)))
        return plans, ndps

    def _plan_one(self, cap_len: int, meta, i) -> Optional[_Plan]:
        if not bool(meta["lsig_ok"][i]):
            return None
        # sync gate: the reference only syncs when the LTF autocorrelation
        # peak exceeds 0.5 (lib/sync_impl.cc:99); with snr = 10log10(ac/(1-ac))
        # that is exactly snr > 0 dB. Drops mid-packet re-triggers whose
        # junk L-SIG passes parity by chance (they'd otherwise each compile
        # a junk-length DATA program).
        if float(meta["snr"][i]) <= 0.0:
            return None
        win_start = int(meta["win_start"][i])
        ltf_start = int(meta["ltf_start"][i])
        cfo = float(meta["cfo"][i])
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        snr = float(meta["snr"][i])
        l_mcs = int(meta["l_mcs"][i])
        l_len = int(meta["l_len"][i])

        # length-consistency guards (parity: lib/demod_impl.cc:159,186 and
        # the PSDU/trellis caps in lib/decode_impl.h:35-36). Extent = the
        # EXACT packet end (see _plan_batch).
        def extent(mod, n_sym):
            if mod.fmt == F.L:
                off = 208
            elif mod.fmt == F.HT:
                off = OFF_NLLTF + 80 * mod.nLTF
            else:
                off = OFF_NLLTF + 80 * mod.nLTF + 80
            return ltf_start + (off + n_sym * 80) * self.q

        def fits(mod, n_sym):
            return (0 < n_sym and n_sym * mod.nDBPS <= 33000
                    and win_start + extent(mod, n_sym) <= cap_len)
        fmt = F.L
        if l_mcs == 0:
            fmt = _pick_nl_format(meta, i)
        if fmt == F.L:
            if self.q != 1:
                return None    # legacy payloads exist only at 20 MHz
            if not (14 <= l_len <= 4095):
                return None
            mod = Mod(F.L, l_mcs)
            pp = ppdu_params_nonaggregate(mod, l_len)
            if not fits(mod, pp.n_sym):
                return None
            return _Plan(mod, pp.n_sym, l_len, False, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        if fmt == F.HT:
            mcs, bw, length, aggre, sgi = parse_ht_sig(meta["ht_bits"][i])
            if bw != self.bw or mcs > 15 or sgi:
                return None    # packet bw must match the capture rate;
                               # SGI out of envelope (as in the reference)
            nsts = mcs // 8 + 1
            if nsts != 1:
                return None    # SISO receiver; 2x2 handled by MimoReceiver
            if not (1 <= length <= 4095):
                return None
            mod = Mod(F.HT, mcs, bw, nsts, sgi)
            pp = ppdu_params_nonaggregate(mod, length)
            if not fits(mod, pp.n_sym):
                return None
            return _Plan(mod, pp.n_sym, length, aggre, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        # VHT
        bw, gid, nsts, paid, sgi, mcs = parse_vht_siga(meta["vht_bits"][i])
        if not (gid == 0 or gid == 63):
            return None    # downlink MU group -> _plan_mu_batch, not SU
        if bw != self.bw or sgi or not (1 <= nsts <= 4):
            return None
        # NDP check BEFORE the nSTS gate: a sounding NDP announces the
        # number of sounded streams (usually 2), and its nSym budget from
        # the spoofed L-SIG length is <= 0 (lib/decode_impl.cc:100-121)
        n_ltf = int(tables.N_LTF[nsts])
        n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        if n_sym <= 0:
            # channel-report path (mu/feedback.py); surfaced by
            # decode_capture_full
            return _Plan(Mod(F.VHT, 0, bw, nsts), 0, 0, False, win_start,
                         ltf_start, cfo, cfo_hz, snr, ndp=True)
        if nsts != 1:
            return None    # SISO receiver; 2x2 data handled by MimoReceiver
        mod = Mod(F.VHT, mcs, bw, nsts, sgi)
        psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
        if not fits(mod, n_sym) or psdu_len > 4095:
            return None
        return _Plan(mod, n_sym, psdu_len, True, win_start, ltf_start,
                     cfo, cfo_hz, snr)
