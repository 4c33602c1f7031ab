"""MU-MIMO station-side processing: NDP capture and MU packet decode.

STA side of the sounding loop (reference demod mupos path,
lib/demod_impl.cc:347-399 + decode NDP type-20 report,
lib/decode_impl.cc:100-121): detect a VHT NDP, hand the VHT-LTF windows to
the feedback pipeline; and decode the STA's own stream of a downlink MU
PPDU given its group position (mupos).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coding, demod, sync
from ..rx.receiver import (OFF_NLLTF, PacketResult, assemble_packet,
                           parse_vht_siga, sig_parse)
from ..specs import BW, CR, F, M, Mod, tables
from ..specs import interleaver as ilv
from ..specs.tables import crc8_bits
from ..utils.riq import r2c


@dataclasses.dataclass
class NdpCapture:
    ltf_iq: np.ndarray      # [nLtf * 64] complex time samples, CFO-corrected
    cfo_rad: float
    snr_db: float


def sta_capture_ndp(capture: np.ndarray, n_sts: int = 2
                    ) -> Optional[NdpCapture]:
    """Find a VHT NDP in a 1-antenna capture and return its LTF windows."""
    capture = np.asarray(capture, dtype=np.complex64)
    t0s = sync.find_triggers_np(capture)
    for t0 in t0s:
        wlen = min(len(capture) - t0, 1600)
        x2 = np.zeros((1, max(wlen, 1360), 2), dtype=np.float32)
        seg = capture[t0:t0 + wlen]
        x2[0, :len(seg), 0] = np.real(seg)
        x2[0, :len(seg), 1] = np.imag(seg)
        meta = {k: np.asarray(v) for k, v in
                sig_parse(jnp.asarray(x2),
                          jnp.zeros(1, np.int32)).items()}
        if not (bool(meta["lsig_ok"][0]) and bool(meta["vht_ok"][0])):
            continue
        bw, gid, nsts, paid, sgi, mcs = parse_vht_siga(meta["vht_bits"][0])
        l_len = int(meta["l_len"][0])
        n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
        n_ltf = tables.N_LTF[n_sts]
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        if n_sym > 0:
            continue   # not an NDP
        ltf_start = int(meta["ltf_start"][0]) + t0
        cfo = float(meta["cfo"][0])
        ramp = np.exp(1j * cfo * np.arange(len(capture)))
        y = capture * ramp
        wins = []
        for l in range(n_ltf):
            s = ltf_start + OFF_NLLTF + 80 * l + 16 - 8
            wins.append(y[s:s + 64])
        return NdpCapture(ltf_iq=np.concatenate(wins), cfo_rad=cfo,
                          snr_db=float(meta["snr"][0]))
    return None


class MuStaDecoder:
    """Decode this station's stream of an MU PPDU (1 RX antenna).

    mupos here is the station's SPACE-TIME STREAM index within the group
    (== group position when every user has one stream); n_sts_total is the
    group's total stream count (<= 4, reference genAmpduMu envelope,
    tools/phy80211.py:183)."""

    def __init__(self, mod: Mod, n_sym: int, psdu_len: int, mupos: int,
                 n_sts_total: int = 2):
        self.mod = mod
        self.n_sym = n_sym
        self.psdu_len = psdu_len
        self.mupos = mupos
        self.n_sts = n_sts_total
        self.n_ltf = int(tables.N_LTF[n_sts_total])
        self.n_bits = n_sym * mod.nDBPS
        self._fn = jax.jit(self._decode)

    def _decode(self, x2, ltf_start, cfo):
        mod = self.mod
        u = self.mupos
        y = sync.apply_cfo_correction(r2c(x2), cfo)
        n_ltf = self.n_ltf
        ltf_t = demod.extract_symbol_windows(y, ltf_start + OFF_NLLTF, n_ltf)
        ltf_f = demod.fft_syms(ltf_t)                     # [B, nLtf, 64]
        ref = jnp.asarray(demod.ltf_ref_grid(mod.bw, False))
        safe_ref = jnp.where(ref == 0, 1.0, ref)
        p = tables.P_LTF_4[:max(self.n_sts, 2), :n_ltf]
        # own-stream effective channel via P-row combining (P rows are
        # orthogonal over the nLtf symbols)
        h_u = jnp.einsum("l,blk->bk", p[u], ltf_f) / n_ltf / safe_ref
        h_u = jnp.where(ref == 0, 1.0 + 0j, h_u)
        # pilot channel: sum over streams, from LTF1 (R[0] = +1 for all)
        pil = jnp.asarray(tables.PILOT_GRID[(mod.bw, False)])
        sum_h_pil = ltf_f[:, 0, :][..., pil] / safe_ref[pil]

        g = demod.fft_syms(demod.extract_symbol_windows(
            y, ltf_start + OFF_NLLTF + 80 * n_ltf + 80, self.n_sym))
        pref = jnp.asarray(np.asarray(demod.pilot_refs(mod, self.n_sym, 4)))
        obs = g[..., pil]                                 # [B, S, nP]
        exp = sum_h_pil[:, None, :] * pref[None]
        acc = jnp.sum(obs * jnp.conj(exp), axis=-1)
        ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
        g = g / ph[..., None]
        eq = g / h_u[:, None, :]
        data = eq[..., jnp.asarray(tables.DATA_GRID[(mod.bw, False)])]
        llr = demod.demap_llr(data, mod.mod)
        llr = llr[..., jnp.asarray(ilv.rx_perm(mod, 0))].reshape(
            llr.shape[0], -1)
        bits = coding.viterbi_decode(llr, mod.cr, self.n_bits)
        return coding.descramble(bits)

    def decode(self, x2, ltf_start, cfo) -> np.ndarray:
        return np.asarray(self._fn(x2, ltf_start, cfo))


@lru_cache(maxsize=64)
def get_mu_sta_decoder(mod: Mod, n_sym: int, psdu_len: int, mupos: int,
                       n_sts_total: int = 2):
    return MuStaDecoder(mod, n_sym, psdu_len, mupos, n_sts_total)


def sta_decode_mu(capture: np.ndarray, mupos: int,
                  fs_hz: float = 20e6) -> List[PacketResult]:
    """Decode this STA's stream from downlink MU PPDUs in a capture.

    SIG-B is decoded per user position to learn (mcs, length)
    (parity: vhtSigBDemod + signalParserVhtB, lib/demod_impl.cc:449-505).
    """
    capture = np.asarray(capture, dtype=np.complex64)
    t0s = sync.find_triggers_np(capture)
    out: List[PacketResult] = []
    for t0 in t0s:
        wlen = len(capture) - t0
        x2 = np.zeros((1, wlen, 2), dtype=np.float32)
        seg = capture[t0:]
        x2[0, :, 0] = np.real(seg)
        x2[0, :, 1] = np.imag(seg)
        meta = {k: np.asarray(v) for k, v in
                sig_parse(jnp.asarray(x2), jnp.zeros(1, np.int32)).items()}
        if not (bool(meta["lsig_ok"][0]) and bool(meta["vht_ok"][0])):
            continue
        bw, gid, _, _, sgi, _ = parse_vht_siga(meta["vht_bits"][0])
        if bw != BW.BW20 or sgi or not (1 <= gid <= 62):
            continue
        # MU NSTS fields: 4 users x 3 bits at SIG-A bits 10..21 (0 = user
        # absent); this station's stream index = streams before its
        # position (reference genAmpduMu group layout, phy80211.py:183)
        vb = np.asarray(meta["vht_bits"][0], np.int64)
        nsts_u = [int(vb[10 + 3 * u:13 + 3 * u] @ (1 << np.arange(3)))
                  for u in range(4)]
        n_sts_total = int(sum(nsts_u))
        if not (1 <= n_sts_total <= 4) or mupos >= 4 or nsts_u[mupos] != 1:
            continue                  # absent / multi-stream user: not ours
        stream_idx = int(sum(nsts_u[:mupos]))
        n_ltf = int(tables.N_LTF[n_sts_total])
        l_len = int(meta["l_len"][0])
        n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        if n_sym <= 0:
            continue
        ltf_start = np.asarray([meta["ltf_start"][0]], np.int32)
        cfo = np.asarray([meta["cfo"][0]], np.float32)
        sigb = _decode_mu_sigb(x2, ltf_start, cfo, stream_idx, n_sts_total)
        if sigb is None:
            continue
        mcs, ampdu_len, sigb_crc = sigb
        mod = Mod(F.VHT, mcs, BW.BW20, 1)
        need = int(ltf_start[0]) + 448 + 80 * n_ltf + 160 + n_sym * 80
        if need > wlen or n_sym * mod.nDBPS > 33000:
            continue
        psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
        dec = get_mu_sta_decoder(mod, n_sym, psdu_len, stream_idx,
                                 n_sts_total)
        bits = dec.decode(jnp.asarray(x2), jnp.asarray(ltf_start),
                          jnp.asarray(cfo))[0]
        # SIG-B CRC-8 vs SERVICE bits 8..15: a mismatch means the SIG-B
        # (mcs, length) decode is unreliable — drop, as the reference does
        sigb_ok = bool(np.all(np.asarray(bits[8:16]) == sigb_crc))
        if not sigb_ok:
            continue
        r = assemble_packet(F.VHT, mod, psdu_len, bits, True,
                            float(cfo[0]) * fs_hz / (2 * np.pi) * -1.0,
                            float(meta["snr"][0]))
        r.sigb_ok = True
        out.append(r)
    return out


@lru_cache(maxsize=16)
def _mu_sigb_fn(mupos: int, n_sts_total: int = 2):
    sigb_mod = Mod(F.VHT, 0, BW.BW20, 1)
    n_ltf = int(tables.N_LTF[n_sts_total])

    @jax.jit
    def fn(x2, ltf_start, cfo):
        y = sync.apply_cfo_correction(r2c(x2), cfo)
        ltf_t = demod.extract_symbol_windows(y, ltf_start + OFF_NLLTF, n_ltf)
        ltf_f = demod.fft_syms(ltf_t)
        ref = jnp.asarray(demod.ltf_ref_grid(BW.BW20, False))
        safe_ref = jnp.where(ref == 0, 1.0, ref)
        p = tables.P_LTF_4[:max(n_sts_total, 2), :n_ltf]
        h_u = jnp.einsum("l,blk->bk", p[mupos], ltf_f) / n_ltf / safe_ref
        h_u = jnp.where(ref == 0, 1.0 + 0j, h_u)
        g = demod.fft_syms(demod.extract_symbol_windows(
            y, ltf_start + OFF_NLLTF + 80 * n_ltf, 1))[:, 0]
        pil = jnp.asarray(tables.PILOT_GRID[(BW.BW20, False)])
        sum_h_pil = ltf_f[:, 0, :][..., pil] / safe_ref[pil]
        pref = jnp.asarray(tables.PILOT_VHT[BW.BW20]
                           * tables.PILOT_POLARITY[3])
        acc = jnp.sum(g[..., pil] * jnp.conj(sum_h_pil * pref[None]), axis=-1)
        ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
        eq = (g / ph[:, None]) / h_u
        llr = jnp.real(eq[..., jnp.asarray(tables.DATA_GRID[(BW.BW20, False)])])
        # 4/7/8-stream groups flip SIG-B's sign on some streams
        # (P_SIGB_NSTS478, 21.3.8.3.6 / tx vht_sigb_field)
        if n_sts_total in (4, 7, 8):
            llr = llr * float(tables.P_SIGB_NSTS478[mupos])
        llr = llr[..., jnp.asarray(ilv.rx_perm(sigb_mod))]
        return coding.viterbi_decode(llr, CR.CR12, 26)

    return fn


def _decode_mu_sigb(x2, ltf_start, cfo, mupos: int, n_sts_total: int = 2):
    """MU VHT-SIG-B: 16-bit len/4 + 4-bit mcs. Returns (mcs, length,
    expected_crc8) — the CRC-8 of the 20 pre-tail bits, to be verified
    against SERVICE bits 8..15 of the descrambled DATA stream
    (parity: signalParserVhtB + vhtSigBDemod, lib/demod_impl.cc:449-505)."""
    bits = np.asarray(_mu_sigb_fn(mupos, n_sts_total)(jnp.asarray(x2),
                                                      jnp.asarray(ltf_start),
                                                      jnp.asarray(cfo)))[0]
    length = int(np.sum(bits[0:16] << np.arange(16))) * 4
    mcs = int(np.sum(bits[16:20] << np.arange(4)))
    if mcs > 9:
        return None
    crc = np.asarray(crc8_bits(list(bits[:20])), dtype=np.int64)
    return mcs, length, crc


# ---------------------------------------------------------------------------
# streaming, batched MU-STA decode (the receiver-integrated path)
# ---------------------------------------------------------------------------
# The reference decodes the station's MU stream inside its real-time demod
# state machine (lib/demod_impl.cc:27-40 mupos/mugid ctor, :347-378 MU 2x1
# channel estimate). The batched analog below follows the same contract
# as every other decoder lane in rx/receiver.py: one static
# (Mod, nSym-bucket, stream_idx, nSTS-total) compilation with fixed-capacity
# windows gathered in-graph from the device-resident capture, true symbol
# counts traced through `n_valid` — so a stream of MU packets costs one
# SIG-B dispatch plus one decode dispatch per group, not one compile per
# capture length (the sta_decode_mu loop above is kept as the small
# offline/single-shot utility).


from functools import partial as _partial


# MU VHT-SIG-B geometry per bandwidth: (length-field bits, total info
# bits incl. the standard's pre-BCC repetition — same totals as the SU
# SIGB_DIMS; tx/golden.vhtsigb_bits_mu)
MU_SIGB_LEN = {BW.BW20: 16, BW.BW40: 17, BW.BW80: 19}
MU_SIGB_INFO = {BW.BW20: 26, BW.BW40: 54, BW.BW80: 117}


@_partial(jax.jit, static_argnames=("wlen", "stream_idx", "n_sts_total",
                                    "q"))
def mu_sigb_parse_capture(cap, scale, t_abs, ltf_start, cfo, wlen: int,
                          stream_idx: int, n_sts_total: int, q: int = 1):
    """Batched MU VHT-SIG-B decode over in-graph capture windows.

    cap: [Npad, 2] (1 chain) or [nRx, Npad, 2] (multi-chain, MRC-combined);
    t_abs: [G] window starts; ltf_start/cfo: [G] per-window sync results;
    q = 1/2/4 for a 20/40/80 MHz capture. Returns [G] int32 — the first
    len+mcs+crc-relevant SIG-B info bits packed LSB-first (one scalar
    fetch per window instead of a bit-plane).
    """
    from ..rx.receiver import capture_windows, capture_windows_mimo
    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    nfft, gi, sh = 64 * q, 16 * q, 4 * q
    if cap.ndim == 3:
        x2 = capture_windows_mimo(cap, t_abs, wlen)
    else:
        x2 = capture_windows(cap, t_abs, wlen)[:, None]
    x2 = x2.astype(jnp.float32) * scale                    # [G, R, w, 2]
    g, nrx = x2.shape[0], x2.shape[1]
    n_ltf = int(tables.N_LTF[n_sts_total])
    y = r2c(x2) * sync.cfo_ramp(cfo, x2.shape[2])[:, None, :]
    yf = y.reshape(g * nrx, -1)
    ls2 = jnp.repeat(ltf_start, nrx)
    ltf_f = demod.fft_syms(demod.extract_symbol_windows(
        yf, ls2 + OFF_NLLTF * q, n_ltf, nfft=nfft, gi=gi,
        shift=sh)).reshape(g, nrx, n_ltf, nfft)
    ref = jnp.asarray(demod.ltf_ref_grid(bw, False))
    safe_ref = jnp.where(ref == 0, 1.0, ref)
    p = tables.P_LTF_4[:max(n_sts_total, 2), :n_ltf]
    h_u = jnp.einsum("l,brlk->brk", jnp.asarray(p[stream_idx]),
                     ltf_f) / n_ltf / safe_ref             # [G, R, nfft]
    h_u = jnp.where((ref == 0)[None, None], 1.0 + 0j, h_u)
    sb = demod.fft_syms(demod.extract_symbol_windows(
        yf, ls2 + (OFF_NLLTF + 80 * n_ltf) * q, 1, nfft=nfft, gi=gi,
        shift=sh)).reshape(g, nrx, nfft)
    # pilots ride the SUM channel over the group's streams (every stream
    # carries SIG-B identically through the spatial expansion)
    pil = jnp.asarray(tables.PILOT_GRID[(bw, False)])
    sum_h_pil = ltf_f[:, :, 0, :][..., pil] / safe_ref[pil]  # [G, R, nP]
    pref = jnp.asarray(tables.PILOT_VHT[bw]
                       * tables.PILOT_POLARITY[3])
    acc = jnp.sum(sb[..., pil] * jnp.conj(sum_h_pil * pref[None, None]),
                  axis=(1, 2))
    ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
    sb = sb / ph[:, None, None]
    eq = demod.mrc_combine(sb[:, :, None, :], h_u)[:, 0]   # [G, nfft]
    llr = jnp.real(eq[..., jnp.asarray(tables.DATA_GRID[(bw, False)])])
    if n_sts_total in (4, 7, 8):
        llr = llr * float(tables.P_SIGB_NSTS478[stream_idx])
    sigb_mod = Mod(F.VHT, 0, bw, 1)
    llr = llr[..., jnp.asarray(ilv.rx_perm(sigb_mod))]
    bits = coding.viterbi_decode(llr, CR.CR12, MU_SIGB_INFO[bw])
    n_keep = MU_SIGB_LEN[bw] + 4                           # len + mcs
    w = (1 << jnp.arange(n_keep, dtype=jnp.int32))
    return jnp.sum(bits[:, :n_keep].astype(jnp.int32) * w, axis=-1)


class MuStaDataDecoder:
    """Batched own-stream DATA decoder for downlink MU PPDUs.

    Static config (Mod, nSym-bucket, stream_idx, nSTS-total); windows carry
    1..nRx chains and the own-stream channels (P-row combining per chain,
    lib/demod_impl.cc:347-378's 2x1 MU estimate generalized) are
    MRC-combined — a 2-antenna STA gets array gain the reference's
    1-antenna mupos path never had. Pilot tracking rides the group's SUM
    channel (all streams carry the same pilots through the spatial
    expansion). True per-packet symbol counts pass through `n_valid`; the
    expected SIG-B CRC-8 byte is verified in-graph against the descrambled
    SERVICE field (parity: signalParserVhtB re-encode check).
    """

    def __init__(self, mod: Mod, n_sym: int, stream_idx: int,
                 n_sts_total: int):
        assert mod.nSS == 1
        self.mod = mod
        self.n_sym = n_sym
        self.stream_idx = stream_idx
        self.n_sts = n_sts_total
        self.n_ltf = int(tables.N_LTF[n_sts_total])
        self.n_bits = n_sym * mod.nDBPS
        self.q = tables.NFFT[mod.bw] // 64

    def data_offset(self) -> int:
        return (OFF_NLLTF + 80 * self.n_ltf + 80) * self.q   # + SIG-B

    def window_capacity(self) -> int:
        return (272 * self.q + self.data_offset()
                + (self.n_sym * 80 + 80) * self.q)

    def zlen(self) -> int:
        """Aligned-window length (see rx SisoDataDecoder.zlen)."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _decode_z(self, z, n_valid, sigb_crc):
        """z: [B, nRx, zlen] complex, CFO-corrected, aligned at
        ltf_start - gi; sigb_crc: [B] int32 expected CRC-8 of the SIG-B
        pre-tail bits. Returns (descrambled bits, evm, sigb_ok)."""
        mod = self.mod
        q = self.q
        nfft, gi, sh = 64 * q, 16 * q, 4 * q   # 4q shift (models/pipeline)
        b, nrx = z.shape[0], z.shape[1]
        yf = z.reshape(b * nrx, -1)
        ltf_f = demod.fft_syms(demod.static_symbol_windows(
            yf, gi + OFF_NLLTF * q, self.n_ltf, nfft=nfft, gi=gi,
            shift=sh)).reshape(b, nrx, self.n_ltf, nfft)
        ref = jnp.asarray(demod.ltf_ref_grid(mod.bw, False))
        safe_ref = jnp.where(ref == 0, 1.0, ref)
        p = tables.P_LTF_4[:max(self.n_sts, 2), :self.n_ltf]
        h_u = jnp.einsum("l,brlk->brk", jnp.asarray(p[self.stream_idx]),
                         ltf_f) / self.n_ltf / safe_ref    # [B, R, nfft]
        h_u = jnp.where((ref == 0)[None, None], 1.0 + 0j, h_u)
        pil = jnp.asarray(tables.PILOT_GRID[(mod.bw, False)])
        sum_h_pil = ltf_f[:, :, 0, :][..., pil] / safe_ref[pil]
        gd = demod.fft_syms(demod.static_symbol_windows(
            yf, gi + self.data_offset(), self.n_sym, nfft=nfft, gi=gi,
            shift=sh)).reshape(b, nrx, self.n_sym, nfft)
        pref = jnp.asarray(np.asarray(demod.pilot_refs(mod, self.n_sym, 4)))
        exp = sum_h_pil[:, :, None, :] * pref[None, None]  # [B, R, S, nP]
        acc = jnp.sum(gd[..., pil] * jnp.conj(exp), axis=(1, 3))
        ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)        # [B, S]
        gd = gd / ph[:, None, :, None]
        eq = demod.mrc_combine(gd, h_u)                    # [B, S, nfft]
        data = eq[..., jnp.asarray(tables.DATA_GRID[(mod.bw, False)])]
        sym_m = None
        if n_valid is not None:
            sym_m = (jnp.arange(self.n_sym, dtype=jnp.int32)[None, :]
                     < n_valid[:, None])
        evm = demod.evm_snr_db(data, mod.mod, sym_mask=sym_m)
        llr = demod.demap_llr(data, mod.mod)
        # CSI weight = post-MRC noise inverse (see demod_data_mrc)
        wg = jnp.sum(jnp.abs(h_u) ** 2, axis=1)
        w = wg[..., jnp.asarray(tables.DATA_GRID[(mod.bw, False)])]
        w = w / jnp.maximum(jnp.mean(w, axis=-1, keepdims=True), 1e-12)
        nb = llr.shape[-1] // data.shape[-1]
        llr = llr * jnp.repeat(w, nb, axis=-1)[:, None, :]
        llr = llr[..., jnp.asarray(ilv.rx_perm(mod, 0))].reshape(b, -1)
        if sym_m is not None:
            ncbpss = llr.shape[1] // self.n_sym
            llr = jnp.where(jnp.repeat(sym_m, ncbpss, axis=1), llr, 0.0)
        bits = coding.viterbi_decode(llr, mod.cr, self.n_bits)
        scr = coding.descramble(bits)
        svc = jnp.sum(scr[:, 8:16].astype(jnp.int32)
                      * (1 << jnp.arange(8, dtype=jnp.int32)), axis=1)
        return scr, evm, svc == sigb_crc

    def _decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                             n_valid, sigb_crc):
        from ..rx.receiver import (capture_windows, capture_windows_mimo,
                                   pack_bits_le)
        zl = self.zlen()
        ta = t_abs + ltf_start - 16 * self.q
        if cap.ndim == 3:
            x2 = capture_windows_mimo(cap, ta, zl)
        else:
            x2 = capture_windows(cap, ta, zl)[:, None]
        x2 = x2.astype(jnp.float32) * scale
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)[:, None, :]
        bits, evm, sigb_ok = self._decode_z(z, n_valid, sigb_crc)
        return pack_bits_le(bits), evm, sigb_ok

    def decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                            n_valid, sigb_crc):
        """Async dispatch over the device-resident capture."""
        if not hasattr(self, "_fn_cap"):
            self._fn_cap = jax.jit(self._decode_from_capture)
        return self._fn_cap(cap, scale, t_abs, ltf_start, cfo, n_valid,
                            sigb_crc)


@lru_cache(maxsize=64)
def get_mu_sta_data_decoder(mod: Mod, n_sym_bucket: int, stream_idx: int,
                            n_sts_total: int) -> MuStaDataDecoder:
    return MuStaDataDecoder(mod, n_sym_bucket, stream_idx, n_sts_total)
