"""2x2 SU-MIMO receiver: dual-chain sync, MIMO channel est, ZF equalizer.

Batched re-design of the reference 2x2 stack (signal2 + demod2,
SURVEY.md §2 C5/C7): both RX chains are decoded as one batched tensor
program — P-matrix channel estimation from the two HT/VHT-LTFs, per-tone
2x2 Gram-inverse ZF equalization, joint two-stream pilot phase tracking,
per-stream deinterleave and stream-deparser, one Viterbi over the re-merged
coded stream. (Math parity: lib/demod2_impl.cc:374-530.)
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coding, demod, sync
from ..specs import BW, CR, F, M, Mod, tables
from ..specs import interleaver as ilv
from ..utils.riq import r2c
from .receiver import (MIN_TRIGGER_GAP, N_SYM_BUCKET, OFF_LSIG, OFF_NLLTF,
                       PacketResult, SisoReceiver, _bucket, assemble_packet,
                       parse_ht_sig, parse_vht_siga, sig_parse_mimo)


@lru_cache(maxsize=None)
def _deparser_gather(mod: Mod):
    """Per-encoder gather maps [nES][nCBPS/nES]: coded-bit i of encoder e
    <- (stream, pos). (The reference's stream parser is dormant/buggy for
    nES>=2, tests/test_specs_vs_reference.py — ours follows the standard.)"""
    ss_idx, pos_idx = ilv.stream_deparser_maps(mod)
    return ss_idx.astype(np.int32), pos_idx.astype(np.int32)


def _pilot_obs_ref(mod: Mod, h_pil: jnp.ndarray, n_sym: int, pidx0: int):
    """Expected pilot observations per RX chain [B, S, nRx, nP].

    h_pil: [B, nP, nRx, nSTS] channel rows at pilot bins (for VHT this is
    the *sum* channel replicated; see mimo channel estimation note).
    """
    if mod.fmt == F.HT:
        pats = np.stack([tables.PILOT_HT[mod.bw][mod.nSS - 1][iss]
                         for iss in range(mod.nSS)])     # [nSTS, nP]
        refs = np.stack([np.asarray(
            demod.pilot_refs(mod, n_sym, pidx0, iss))
            for iss in range(mod.nSS)])                  # [nSTS, S, nP]
        # y_exp[r, k, n] = sum_s H[r, s, k] * p_s[k, n]
        return jnp.einsum("bprs,snp->bnrp", h_pil, jnp.asarray(refs))
    # VHT: same pilot values on every stream
    pref = jnp.asarray(np.asarray(demod.pilot_refs(mod, n_sym, pidx0)))
    hsum = jnp.sum(h_pil, axis=-1)                       # [B, nP, nRx]
    return jnp.einsum("bpr,np->bnrp", hsum, pref)


class MimoDataDecoder:
    """Batched 2-stream DATA decoder for one static (Mod, nSym-bucket).

    n_sym is the compiled symbol capacity; true per-packet symbol counts
    pass through `n_valid` with LLRs past the true extent zeroed
    (path-neutral in the Viterbi) — one compilation serves every packet
    length in the bucket, same as SisoDataDecoder."""

    def __init__(self, mod: Mod, n_sym: int, detector: str = "ml"):
        assert mod.nSS == 2
        assert detector in ("ml", "zf")
        self.mod = mod
        self.n_sym = n_sym
        self.detector = detector
        self.n_bits = n_sym * mod.nDBPS
        self.q = tables.NFFT[mod.bw] // 64
        self._fn = jax.jit(self._decode)

    def data_offset(self) -> int:
        n_ltf = self.mod.nLTF
        if self.mod.fmt == F.HT:
            off = OFF_NLLTF + 80 * n_ltf
        else:
            off = OFF_NLLTF + 80 * n_ltf + 80    # VHT: + SIG-B
        return off * self.q

    def zlen(self) -> int:
        """Aligned-window length (index 0 == ltf_start - gi; see
        SisoDataDecoder.zlen — static slicing replaces per-packet gathers)."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _decode_z(self, z: jnp.ndarray, n_valid: jnp.ndarray = None):
        """z: [B, nRx=2, zlen] complex, CFO-corrected, aligned at
        ltf_start - gi. Returns (descrambled bits, evm, sigb_ok)."""
        mod = self.mod
        q = self.q
        nfft, gi, sh = 64 * q, 16 * q, 4 * q  # 4q shift: see make_rx_step
        b = z.shape[0]
        yf = z.reshape(b * 2, -1)

        # both chains' NL-LTF symbols -> [B, nRx, nLtf, nfft]
        ltf_t = demod.static_symbol_windows(yf, gi + OFF_NLLTF * q, 2,
                                            nfft=nfft, gi=gi, shift=sh)
        ltf_f = demod.fft_syms(ltf_t).reshape(b, 2, 2, nfft)
        h = demod.mimo_chan_est_2x2(ltf_f, mod.bw, vht=mod.fmt == F.VHT)
        # h: [B, 64, nRx, nSTS]; at VHT pilot tones this holds sumH/ref in
        # every stream column / 2 (since both LTFs carry R*ref there):
        # mimo_chan_est combines with P, giving [sum/2, sum/2] columns *
        # P-row structure — recover the sum channel at pilots directly:
        pil_bins = jnp.asarray(tables.PILOT_GRID[(mod.bw, False)])
        ref = jnp.asarray(demod.ltf_ref_grid(mod.bw, False))
        ltf1_pil = ltf_f[:, :, 0, :][..., pil_bins]       # [B, nRx, nP]
        sum_h_pil = ltf1_pil / ref[pil_bins][None, None, :]

        # data symbols on both chains
        gd = demod.fft_syms(demod.static_symbol_windows(
            yf, gi + self.data_offset(), self.n_sym,
            nfft=nfft, gi=gi, shift=sh)).reshape(
                b, 2, self.n_sym, nfft)
        pidx0 = 3 if mod.fmt == F.HT else 4

        # joint pilot phase tracking across chains
        if mod.fmt == F.HT:
            h_pil = h[:, pil_bins]                        # [B, nP, nRx, nSTS]
            exp_obs = _pilot_obs_ref(mod, h_pil, self.n_sym, pidx0)
        else:
            exp_obs = _pilot_obs_ref(
                mod, jnp.moveaxis(sum_h_pil, -1, 1)[..., None],
                self.n_sym, pidx0)
        obs = gd[..., pil_bins]                           # [B, nRx, S, nP]
        obs = jnp.moveaxis(obs, 1, 2)                     # [B, S, nRx, nP]
        acc = jnp.sum(obs * jnp.conj(exp_obs), axis=(-1, -2))
        ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)       # [B, S]
        gd = gd / ph[:, None, :, None]

        # ZF equalize the data bins
        xhat = demod.mimo_equalize_2x2(gd, h)             # [B, 2, S, nfft]
        data_bins = jnp.asarray(tables.DATA_GRID[(mod.bw, False)])
        data = xhat[..., data_bins]                       # [B, 2, S, nSD]
        sym_m = None
        if n_valid is not None:
            sym_m = (jnp.arange(self.n_sym, dtype=jnp.int32)[None, :]
                     < n_valid[:, None])                  # [B, S]
        # PER-STREAM EVM SNRs (reference sssnr0/sssnr1,
        # lib/demod2_impl.cc:736-757): reduce over (S, nSD) only
        evm = demod.evm_snr_db(
            data, mod.mod, axes=(-2, -1),
            sym_mask=None if sym_m is None else sym_m[:, None, :])  # [B, 2]
        if self.detector == "ml":
            # max-log ML detection (exact for 2 streams) instead of the ZF
            # hard split — decodes dense constellations through channels
            # whose conditioning defeats the reference's Gram-inverse
            # equalizer (lib/demod2_impl.cc:410-428)
            llr = demod.ml_detect_llr_2x2(
                gd[..., data_bins], h[:, data_bins], mod.mod)
        else:                              # "zf": reference-parity detector
            llr = demod.demap_llr(data, mod.mod)          # [B, 2, S, nCBPSS]
        # per-stream deinterleave
        llr = jnp.stack([llr[:, iss][..., jnp.asarray(ilv.rx_perm(mod, iss))]
                         for iss in range(2)], axis=1)
        # stream deparser: re-merge into per-encoder order per symbol
        ss_idx, pos_idx = _deparser_gather(self.mod)      # [nES, nCBPS/nES]
        n_es = mod.nES

        def mask_syms(m):
            """Zero LLRs of bucket-padding symbols past the true extent."""
            if sym_m is None:
                return m
            return jnp.where(sym_m[..., None], m, 0.0)
        if n_es == 1:
            merged = llr[:, jnp.asarray(ss_idx[0]), :,
                         jnp.asarray(pos_idx[0])]
            merged = jnp.moveaxis(merged, 0, -1)          # [B, S, nCBPS]
            bits = coding.viterbi_decode(
                mask_syms(merged).reshape(b, -1), mod.cr, self.n_bits)
        else:
            # per-encoder Viterbi lanes, then round-robin re-merge of the
            # decoded bits (encoder ies carried scrambled-stream bits
            # ies::nES; each encoder ends in its own 6-bit zero tail)
            dec_es = []
            for ies in range(n_es):
                me = llr[:, jnp.asarray(ss_idx[ies]), :,
                         jnp.asarray(pos_idx[ies])]
                me = mask_syms(jnp.moveaxis(me, 0, -1)).reshape(b, -1)
                dec_es.append(coding.viterbi_decode(
                    me, mod.cr, self.n_bits // n_es))
            bits = jnp.stack(dec_es, axis=-1).reshape(b, -1)
        scr = coding.descramble(bits)
        if mod.fmt == F.VHT:
            # SIG-B rides the SUM channel over streams (every stream sends
            # the same SIG-B through the spatial expansion): per-chain sum
            # channel = LTF1 / ref, MRC-combined across chains
            # (parity: lib/demod2_impl.cc:664-703 SIG-B demod)
            from .receiver import decode_vht_sigb, sigb_service_crc_ok
            safe_ref = jnp.where(ref == 0, 1.0, ref)
            sum_h = ltf_f[:, :, 0, :] / safe_ref[None, None, :]
            sb = demod.fft_syms(demod.static_symbol_windows(
                yf, gi + self.data_offset() - 80 * q, 1,
                nfft=nfft, gi=gi, shift=sh)).reshape(b, 2, nfft)
            eq = demod.mrc_combine(sb[:, :, None, :], sum_h)[:, 0]
            pref = jnp.asarray(tables.PILOT_VHT[mod.bw]
                               * tables.PILOT_POLARITY[3])
            acc = jnp.sum(eq[:, pil_bins] * jnp.conj(pref)[None], axis=-1)
            ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
            sigb_bits = decode_vht_sigb(eq / ph[:, None], mod.bw)
            sigb_ok = sigb_service_crc_ok(sigb_bits, scr, mod.bw)
        else:
            sigb_ok = jnp.ones(b, dtype=bool)
        return scr, evm, sigb_ok

    def _decode(self, x2, ltf_start, cfo, n_valid=None):
        """x2: [B, nRx=2, N, 2] float32 windows; one aligned slice per
        chain, then the static decode."""
        gi = 16 * self.q
        b = x2.shape[0]
        zl = self.zlen()
        z2 = sync.batch_slice_iq(x2.reshape(b * 2, x2.shape[2], 2),
                                 jnp.repeat(ltf_start - gi, 2), zl)
        z = r2c(z2).reshape(b, 2, zl) * sync.cfo_ramp(cfo, zl)[:, None, :]
        return self._decode_z(z, n_valid)

    def decode(self, x2, ltf_start, cfo, n_valid=None):
        bits, evm, _ = self._fn(x2, ltf_start, cfo, n_valid)
        return np.asarray(bits), np.asarray(evm)

    def window_capacity(self) -> int:
        return (272 * self.q + self.data_offset()
                + (self.n_sym * 80 + 80) * self.q)

    def _decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                             n_valid):
        from .receiver import capture_windows_mimo, pack_bits_le
        gi = 16 * self.q
        zl = self.zlen()
        x2 = capture_windows_mimo(cap, t_abs + ltf_start - gi,
                                  zl).astype(jnp.float32) * scale
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)[:, None, :]
        bits, evm, sigb_ok = self._decode_z(z, n_valid)
        return pack_bits_le(bits), evm, sigb_ok

    def decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                            n_valid):
        """Async dispatch over the device-resident dual-chain capture."""
        if not hasattr(self, "_fn_cap"):
            self._fn_cap = jax.jit(self._decode_from_capture)
        return self._fn_cap(cap, scale, t_abs, ltf_start, cfo, n_valid)


@lru_cache(maxsize=64)
def get_mimo_decoder(mod: Mod, n_sym_bucket: int,
                     detector: str = "ml") -> MimoDataDecoder:
    return MimoDataDecoder(mod, n_sym_bucket, detector)


class MrcDataDecoder:
    """Batched single-stream DATA decoder over a MULTI-chain capture.

    Decodes legacy and SISO HT/VHT packets arriving on the dual-antenna
    receiver with maximal-ratio combining across chains — the envelope the
    reference's 2-chain RX covers from chain 0 only (DEMOD_S_LEGACY path,
    lib/demod2_impl.cc:213-276, legacyChanUpdate :761). MRC buys ~3 dB
    array gain plus diversity against per-chain fades the reference path
    never had. Same (Mod, nSym-bucket) compilation contract as
    SisoDataDecoder/MimoDataDecoder.
    """

    def __init__(self, mod: Mod, n_sym: int):
        assert mod.nSS == 1
        self.mod = mod
        self.n_sym = n_sym
        self.n_bits = n_sym * mod.nDBPS
        self.q = tables.NFFT[mod.bw] // 64
        self._fn = jax.jit(self._decode)

    def data_offset(self) -> int:
        if self.mod.fmt == F.L:
            off = OFF_LSIG + 80
        elif self.mod.fmt == F.HT:
            off = OFF_NLLTF + 80 * self.mod.nLTF
        else:
            off = OFF_NLLTF + 80 * self.mod.nLTF + 80   # VHT: + SIG-B
        return off * self.q

    def zlen(self) -> int:
        """Aligned-window length (see SisoDataDecoder.zlen)."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _decode_z(self, z: jnp.ndarray, n_valid: jnp.ndarray = None):
        """z: [B, nRx, zlen] complex, CFO-corrected, aligned at
        ltf_start - gi; static slicing only (see SisoDataDecoder)."""
        mod = self.mod
        q = self.q
        nfft, gi, sh = 64 * q, 16 * q, 4 * q  # 4q shift: see make_rx_step
        b, nrx = z.shape[0], z.shape[1]
        yf = z.reshape(b * nrx, -1)
        if mod.fmt == F.L:
            ltf_t = demod.static_symbol_windows(
                yf, 0, 2, nfft=nfft, gi=gi, shift=sh, stride=nfft)
            chan = demod.legacy_chan_est(
                demod.fft_syms(ltf_t), mod.bw).reshape(b, nrx, nfft)
            pidx0 = 1
        else:
            ltf_t = demod.static_symbol_windows(
                yf, gi + OFF_NLLTF * q, 1, nfft=nfft, gi=gi, shift=sh)
            chan = demod.nonlegacy_chan_est_siso(
                demod.fft_syms(ltf_t)[:, 0], mod.bw).reshape(b, nrx, nfft)
            pidx0 = 3 if mod.fmt == F.HT else 4
        gd = demod.fft_syms(demod.static_symbol_windows(
            yf, gi + self.data_offset(), self.n_sym,
            nfft=nfft, gi=gi, shift=sh)).reshape(b, nrx, self.n_sym, nfft)
        llrs, evm = demod.demod_data_mrc(gd, chan, mod, self.n_sym, pidx0,
                                         with_snr=True, n_valid_sym=n_valid)
        bits = coding.viterbi_decode(llrs, mod.cr, self.n_bits)
        scr = coding.descramble(bits)
        if mod.fmt == F.VHT:
            from .receiver import decode_vht_sigb, sigb_service_crc_ok
            sb = demod.fft_syms(demod.static_symbol_windows(
                yf, gi + self.data_offset() - 80 * q, 1,
                nfft=nfft, gi=gi, shift=sh)).reshape(b, nrx, nfft)
            eq = demod.mrc_combine(sb[:, :, None, :], chan)[:, 0]
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
        """x2: [B, nRx, N, 2] float32; one aligned slice per chain, then
        the static decode."""
        gi = 16 * self.q
        b, nrx = x2.shape[0], x2.shape[1]
        zl = self.zlen()
        z2 = sync.batch_slice_iq(x2.reshape(b * nrx, x2.shape[2], 2),
                                 jnp.repeat(ltf_start - gi, nrx), zl)
        z = r2c(z2).reshape(b, nrx, zl) * sync.cfo_ramp(cfo, zl)[:, None, :]
        return self._decode_z(z, n_valid)

    def decode(self, x2, ltf_start, cfo, n_valid=None):
        bits, evm, _ = self._fn(x2, ltf_start, cfo, n_valid)
        return np.asarray(bits), np.asarray(evm)

    def window_capacity(self) -> int:
        return (272 * self.q + self.data_offset()
                + (self.n_sym * 80 + 80) * self.q)

    def _decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                             n_valid):
        from .receiver import capture_windows_mimo, pack_bits_le
        gi = 16 * self.q
        zl = self.zlen()
        x2 = capture_windows_mimo(cap, t_abs + ltf_start - gi,
                                  zl).astype(jnp.float32) * scale
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)[:, None, :]
        bits, evm, sigb_ok = self._decode_z(z, n_valid)
        return pack_bits_le(bits), evm, sigb_ok

    def decode_from_capture(self, cap, scale, t_abs, ltf_start, cfo,
                            n_valid):
        """Async dispatch over the device-resident dual-chain capture."""
        if not hasattr(self, "_fn_cap"):
            self._fn_cap = jax.jit(self._decode_from_capture)
        return self._fn_cap(cap, scale, t_abs, ltf_start, cfo, n_valid)


@lru_cache(maxsize=64)
def get_mrc_decoder(mod: Mod, n_sym_bucket: int) -> MrcDataDecoder:
    return MrcDataDecoder(mod, n_sym_bucket)


def merge_triggers(per_chain: List[np.ndarray], dedup_gap: int) -> np.ndarray:
    """Union of per-chain trigger positions, deduplicated within dedup_gap.

    Triggering on every chain (not only chain 0, as the reference's rx2.grc
    wiring does) keeps detection alive when one chain's channel fades."""
    t_all = np.sort(np.concatenate([np.asarray(t) for t in per_chain]))
    merged: List[int] = []
    last = -dedup_gap
    for t in t_all:
        if t - last >= dedup_gap:
            merged.append(int(t))
            last = int(t)
    return np.asarray(merged, dtype=np.int64)


class _FutsWithCtx(list):
    """Dispatch futs plus the capture refs needed for a retry pass."""
    ctx = None


class MimoReceiver(SisoReceiver):
    """Auto-detecting universal dual-chain receiver over captures [2, N].

    Batched like SisoReceiver (whose pipelined streaming entry
    `decode_captures` it inherits): one capture upload, one MRC SIG-parse
    dispatch (packed meta fetch), one decode dispatch per (Mod, bucket)
    group — 2x2 plans through the MIMO detector, legacy/SISO plans
    through the MRC decoder.

    detector:
      * "auto" (default): 2x2 plans decode through the cheap ZF detector;
        any that fail FCS (or the SIG-B CRC) are re-dispatched once
        through the exact max-log ML detector. Well-conditioned channels
        (the overwhelming streaming case — and the only case the
        reference's always-ZF rx2 chain can decode at all,
        lib/demod2_impl.cc:410-428) never pay the ML candidate sweep, so
        the dual-chain stream runs at ZF speed while keeping exact-ML's
        PDR on ill-conditioned channels.
      * "ml": exact max-log on every 2x2 packet.
      * "zf": reference-parity linear detector, no retry.
    """

    def __init__(self, sample_rate_hz: float = 20e6, stats=None,
                 ingest: str = "auto", trigger: str = "host",
                 detector: str = "auto", mu_pos: int = 0,
                 mu_gid: Optional[int] = None):
        super().__init__(sample_rate_hz, stats, ingest, trigger,
                         mu_pos=mu_pos, mu_gid=mu_gid)
        assert detector in ("auto", "ml", "zf")
        self.detector = detector

    def _upload(self, capture: np.ndarray):
        """See SisoReceiver._upload: auto = f32 below 32 MB, int8 above;
        per-chain native peak quantization."""
        from .receiver import _pad_capture, _round_64k, next_pow2
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = capture.shape[1]
        npad = next_pow2(n + 4096, lo=1 << 15)
        n_r = min(_round_64k(n), npad)
        mode = self.ingest
        if mode == "auto":
            mode = "int8" if npad > (1 << 19) else "f32"
        if mode == "int8":
            peak = float(max(np.abs(capture.real).max(initial=0.0),
                             np.abs(capture.imag).max(initial=0.0), 1e-12))
            s = 126.0 / peak
            buf = np.zeros((2, n_r, 2), np.int8)
            buf[:, :n, 0] = np.clip(np.round(capture.real * s), -127, 127)
            buf[:, :n, 1] = np.clip(np.round(capture.imag * s), -127, 127)
            return (_pad_capture(jnp.asarray(buf), npad),
                    jnp.float32(1.0 / s), npad)
        buf = np.zeros((2, n_r, 2), np.float32)
        buf[:, :n] = capture.view(np.float32).reshape(2, -1, 2)
        return _pad_capture(jnp.asarray(buf), npad), jnp.float32(1.0), npad

    def _ingest(self, capture: np.ndarray):
        """Dual-chain trigger scan + quantize + upload (fused native path).

        On the int8 path each chain runs the native fused STF-scan +
        peak-track + int8-quantize pass (native/phyrt.cc
        phyrt_scan_quantize); per-chain triggers are union-merged (the
        reference's rx2 flowgraph triggers on chain 0 only — triggering
        on both keeps detection alive through one-chain fades). Per-chain
        dequant scales ship as a [2, 1, 1] array that broadcasts over the
        [B, nRx, N, 2] windows in the jit programs.
        Returns (t0s, cap_dev, scale, npad)."""
        from .. import native
        from .receiver import _pad_capture, _round_64k, next_pow2
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = capture.shape[1]
        npad = next_pow2(n + 4096, lo=1 << 15)
        mode = self.ingest
        if mode == "auto":
            mode = "int8" if npad > (1 << 19) else "f32"
        if mode == "int8" and native.available():
            buf = np.zeros((2, min(_round_64k(n), npad), 2), np.int8)
            scales = np.zeros((2, 1, 1), np.float32)

            def scan_one(c):
                # native pass releases the GIL: both chains can
                # scan+quantize concurrently (chain_scan="threaded")
                return native.scan_quantize(
                    capture[c], buf[c, :n], thresh=0.5,
                    plateau=20 * self.q,
                    min_gap=MIN_TRIGGER_GAP * self.q,
                    lag=16 * self.q)

            if getattr(self, "chain_scan", "threaded") == "threaded":
                if not hasattr(self, "_chain_pool"):
                    from concurrent.futures import ThreadPoolExecutor
                    self._chain_pool = ThreadPoolExecutor(max_workers=2)
                res = list(self._chain_pool.map(scan_one, range(2)))
            else:
                res = [scan_one(c) for c in range(2)]
            per_chain = [np.asarray(t_c, np.int64) for t_c, _ in res]
            scales[0], scales[1] = res[0][1], res[1][1]
            t0s = merge_triggers(per_chain, dedup_gap=200 * self.q)
            return (t0s, _pad_capture(jnp.asarray(buf), npad),
                    jnp.asarray(scales), npad)
        t0s = merge_triggers(
            [sync.find_triggers_np(capture[c], q=self.q,
                                   min_gap=MIN_TRIGGER_GAP)
             for c in range(2)],
            dedup_gap=200 * self.q)
        cap_dev, scale, npad = self._upload(capture)
        return t0s, cap_dev, scale, npad

    def _dispatch_sigs(self, cap_dev, scale, npad, t0s):
        """Submit the batched dual-chain MRC SIG parse (async)."""
        from .receiver import SIGPARSE_WIN, sig_parse_mimo_capture
        wlen = (SIGPARSE_WIN + 320) * self.q
        bpad = -(-len(t0s) // 32) * 32
        t_clamp = np.zeros(bpad, np.int32)
        delta = np.zeros(bpad, np.int32)
        tc = np.minimum(t0s, npad - wlen)
        t_clamp[:len(t0s)] = tc
        delta[:len(t0s)] = t0s - tc
        packed = sig_parse_mimo_capture(cap_dev, scale, jnp.asarray(t_clamp),
                                        jnp.asarray(delta), wlen=wlen,
                                        q=self.q)
        return packed, t_clamp

    def _decoder_for(self, mod: Mod, n_sym_bucket: int):
        det = "zf" if self.detector == "auto" else self.detector
        return (get_mimo_decoder(mod, n_sym_bucket, det)
                if mod.nSS == 2 else get_mrc_decoder(mod, n_sym_bucket))

    def _dispatch_plans(self, cap_dev, scale, npad, plans,
                        decoder_for=None):
        futs = super()._dispatch_plans(cap_dev, scale, npad, plans,
                                       decoder_for)
        if (decoder_for is None and self.detector == "auto"
                and any(p.mod.nSS == 2 and not p.mu for _, p in plans)):
            futs = _FutsWithCtx(futs)
            futs.ctx = (cap_dev, scale, npad)
        return futs

    def _finish_plans(self, futs):
        """Fetch + assemble, then (detector="auto") one exact-ML retry
        pass over the 2x2 packets the ZF detector failed to decode."""
        collected = SisoReceiver._finish_plans(futs)
        ctx = getattr(futs, "ctx", None)
        if ctx is None:
            return collected
        res_by_i = dict(collected)
        retry = []
        for items, _out in futs:
            for i, p in items:
                if p.mu or p.mod.nSS != 2:
                    continue
                r = res_by_i.get(i)
                if r is not None and r.fcs_ok and r.sigb_ok is not False:
                    continue
                retry.append((i, p))
        if not retry:
            return collected
        cap_dev, scale, npad = ctx
        ml_futs = SisoReceiver._dispatch_plans(
            self, cap_dev, scale, npad, retry,
            decoder_for=lambda mod, nb: get_mimo_decoder(mod, nb, "ml"))
        for i, r in SisoReceiver._finish_plans(ml_futs):
            if r.fcs_ok or res_by_i.get(i) is None:
                res_by_i[i] = r
        return sorted(res_by_i.items())

    def _plan_batch(self, cap_len: int, meta, n: int):
        """Universal dual-chain planning over all n trigger windows,
        VECTORIZED like SisoReceiver._plan_batch (the per-window gates
        and SIG-field arithmetic run as numpy array ops; the loop only
        constructs accepted plans). _plan_one is the single-window
        reference implementation; tests/test_dual_chain_universal.py
        asserts parity. Returns (data_plans [(i, _Plan)], ndp_plans)."""
        from .receiver import _Plan
        plans: list = []
        ndps: list = []
        snr = np.asarray(meta["snr"][:n], np.float64)
        cand = snr > 0.0
        if not np.any(cand):
            return plans, ndps
        lsig_ok = np.asarray(meta["lsig_ok"][:n]).astype(bool)
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
        v_nsts = (vb[:, 10:13] @ (1 << np.arange(3, dtype=np.int64))) + 1
        v_sgi = vb[:, 24].astype(bool)
        v_mcs = vb[:, 28:32] @ (1 << np.arange(4, dtype=np.int64))

        # format pick — _plan_one: non-legacy dispatch applies when the
        # L-SIG is a valid MCS0 OR failed outright (HT-SIG carries its
        # own CRC); a valid non-MCS0 L-SIG is a legacy payload
        lsig_data = lsig_ok & (l_mcs == 0)
        nl_elig = lsig_data | ~lsig_ok
        pick_vht = vht_ok & (~imag_dom | ~ht_ok)
        pick_ht = ht_ok & ~pick_vht
        is_vht = cand & nl_elig & pick_vht & lsig_data & v_su
        is_ht = cand & nl_elig & pick_ht
        is_l = (cand & lsig_ok & ~(nl_elig & (pick_vht | pick_ht)))

        # vectorized sizing (nES == 1 across this envelope)
        ndbps_l = np.asarray([24, 36, 48, 72, 96, 144, 192, 216],
                             np.int64)[np.clip(l_mcs, 0, 7)]
        l_nsym = -(-(8 * l_len + 16 + 6) // ndbps_l)
        ht_tab = (np.asarray([54, 108, 162, 216, 324, 432, 486, 540],
                             np.int64) if self.bw == BW.BW40 else
                  np.asarray([26, 52, 78, 104, 156, 208, 234, 260],
                             np.int64))
        ht_nss = ht_mcs // 8 + 1
        ndbps_ht = ht_tab[np.clip(ht_mcs % 8, 0, 7)] * np.clip(ht_nss, 1, 2)
        ht_nsym = -(-(8 * ht_len + 16 + 6) // ndbps_ht)
        v_nltf = np.asarray(tables.N_LTF)[np.clip(v_nsts, 0, 4)]
        v_nsym_l = -(-(l_len * 8 + 16 + 6) // 24)
        v_nsym = v_nsym_l - 2 - 1 - v_nltf - 1
        qq = self.q
        lim = cap_len

        for i in np.flatnonzero(cand):
            ws, ls = int(win_start[i]), int(ltf_start[i])
            c, chz, sn = float(cfo[i]), float(cfo_hz[i]), float(snr[i])
            if is_vht[i]:
                if (v_bw[i] != int(self.bw) or v_sgi[i]
                        or not (1 <= v_nsts[i] <= 4)):
                    continue
                if v_nsym[i] <= 0:
                    ndps.append(_Plan(Mod(F.VHT, 0, self.bw,
                                          int(v_nsts[i])), 0, 0, False,
                                      ws, ls, c, chz, sn, ndp=True))
                    continue
                if v_nsts[i] > 2:
                    continue
                mod = Mod(F.VHT, int(v_mcs[i]), self.bw, int(v_nsts[i]))
                n_sym = int(v_nsym[i])
                psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
                if (n_sym * mod.nDBPS > 33000
                        or psdu_len > 4095 * int(v_nsts[i])
                        or ws + ls + (448 + 80 * mod.nLTF + 80
                                      + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(mod, n_sym, psdu_len, True, ws, ls,
                                       c, chz, sn)))
            elif is_ht[i]:
                if (ht_bw40[i] != (self.bw == BW.BW40) or ht_mcs[i] > 15
                        or ht_sgi[i] or not (1 <= ht_len[i] <= 4095)):
                    continue
                mod = Mod(F.HT, int(ht_mcs[i]), self.bw, int(ht_nss[i]))
                n_sym = int(ht_nsym[i])
                if (n_sym <= 0 or n_sym * mod.nDBPS > 33000
                        or ws + ls + (448 + 80 * mod.nLTF
                                      + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(mod, n_sym, int(ht_len[i]),
                                       bool(ht_aggre[i]), ws, ls, c, chz,
                                       sn)))
            elif is_l[i]:
                if qq != 1 or not (14 <= l_len[i] <= 4095):
                    continue
                n_sym = int(l_nsym[i])
                if (n_sym <= 0 or n_sym * ndbps_l[i] > 33000
                        or ws + ls + 208 + n_sym * 80 > lim):
                    continue
                plans.append((i, _Plan(Mod(F.L, int(l_mcs[i])), n_sym,
                                       int(l_len[i]), False, ws, ls, c,
                                       chz, sn)))
        return plans, ndps

    def decode_capture(self, capture: np.ndarray) -> List[PacketResult]:
        return self.decode_capture_full(capture)[0]

    def decode_capture_full(self, capture: np.ndarray):
        """Decode EVERYTHING arriving on the dual-chain capture.

        Universal envelope (beyond the reference's 2-chain RX, which
        decodes only what its chain-0 L-SIG admits): legacy and SISO
        HT/VHT packets decode with MRC combining across chains, 2x2
        HT/VHT packets with the MIMO detector, and VHT NDPs surface as
        per-chain channel captures — returns (packets, ndps) where ndps
        is a list of per-NDP lists of NdpCapture (one per RX chain;
        parity: lib/decode_impl.cc:100-121 type-20 blob).
        """
        capture = np.asarray(capture, dtype=np.complex64)
        assert capture.ndim == 2 and capture.shape[0] == 2
        results: List[PacketResult] = []
        ndps: List[list] = []
        t0s, cap_dev, scale, npad = self._ingest(capture)
        if len(t0s) == 0:
            return results, ndps
        meta = self._parse_sigs(cap_dev, scale, npad, t0s)
        self.stats.n_trigger += len(t0s)
        self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
        plans, ndp_plans = self._plan_batch(capture.shape[1], meta,
                                            len(t0s))
        for p in ndp_plans:
            nd = self._extract_ndp(capture, p)
            if nd is not None:
                ndps.append(nd)
        self.stats.n_ndp += len(ndps)
        futs = self._dispatch_with_mu(cap_dev, scale, npad, plans,
                                      capture.shape[1], meta, len(t0s))
        for i, r in self._finish_plans(futs):
            self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
            results.append(r)
        return results, ndps

    def _extract_ndp(self, capture: np.ndarray, p) -> Optional[list]:
        """CFO-corrected VHT-LTF windows of a detected NDP, one NdpCapture
        per RX chain (a 2-antenna STA feeds both into
        mu.feedback.vht_channel_feedback for a [nSD, 2, nSTS] estimate)."""
        from ..mu.sounding import NdpCapture
        n_ltf = p.mod.nLTF
        start = p.win_start + p.ltf_start
        out = []
        for c in range(capture.shape[0]):
            wins = []
            for l in range(n_ltf):
                s = start + (448 + 80 * l + 16 - 8) * self.q
                seg = capture[c, s:s + 64 * self.q]
                if len(seg) != 64 * self.q:
                    return None
                ramp = np.exp(1j * p.cfo * (np.arange(len(seg)) + s))
                wins.append((seg * ramp).astype(np.complex64))
            out.append(NdpCapture(ltf_iq=np.concatenate(wins),
                                  cfo_rad=p.cfo, snr_db=p.snr))
        return out

    def _plan_one(self, cap_len: int, meta, i):
        """Universal dual-chain packet planner: legacy + SISO HT/VHT (MRC
        decode), 2x2 HT/VHT (MIMO decode), VHT NDP (channel capture).

        The reference's 2-chain RX covers the same envelope but decodes
        legacy/SISO from chain 0 only (lib/demod2_impl.cc:213-276) and
        hard-drops packets whose chain-0 L-SIG fails
        (lib/signal2_impl.cc:113-127); here the SIG parse is MRC-combined
        and L-SIG validity is NOT a hard gate for HT — the HT-SIG carries
        its own length + CRC-8, so such packets are recoverable.
        """
        from ..specs.modulation import ppdu_params_nonaggregate
        from .receiver import _Plan, _pick_nl_format
        # sync gate (drops mid-packet re-triggers; parity with the SISO
        # receiver and lib/sync_impl.cc:99's ac>0.5 peak requirement)
        if float(meta["snr"][i]) <= 0.0:
            return None
        lsig_data = bool(meta["lsig_ok"][i]) and int(meta["l_mcs"][i]) == 0
        win_start = int(meta["win_start"][i])
        ltf_start = int(meta["ltf_start"][i])
        cfo = float(meta["cfo"][i])
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        snr = float(meta["snr"][i])
        l_mcs = int(meta["l_mcs"][i])
        l_len = int(meta["l_len"][i])
        fmt = _pick_nl_format(meta, i) if (lsig_data or not
                                           bool(meta["lsig_ok"][i])) else F.L

        # exact packet ends (see SisoReceiver._plan_batch: the device
        # capture is zero-padded, so a packet ending at cap_len is whole)
        def extent(mod, n_sym):
            off = 448 + 80 * mod.nLTF + (80 if mod.fmt == F.VHT else 0)
            return ltf_start + (off + n_sym * 80) * self.q

        def l_extent(mod, n_sym):
            return ltf_start + (208 + n_sym * 80) * self.q

        if fmt == F.VHT:
            if not lsig_data:
                return None          # VHT nSym derives from the L-SIG length
            bw, gid, nsts, paid, sgi, mcs = parse_vht_siga(meta["vht_bits"][i])
            if not (gid == 0 or gid == 63):
                return None    # downlink MU group -> _plan_mu_batch, not SU
            if bw != self.bw or sgi or not (1 <= nsts <= 4):
                return None
            mod = Mod(F.VHT, mcs if nsts <= 2 else 0, bw, min(nsts, 2), sgi)
            n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
            n_sym = n_sym_l - 2 - 1 - int(tables.N_LTF[nsts]) - 1
            if n_sym <= 0:
                # NDP: channel capture (any announced nSTS up to 4)
                return _Plan(Mod(F.VHT, 0, bw, nsts), 0, 0, False,
                             win_start, ltf_start, cfo, cfo_hz, snr,
                             ndp=True)
            if nsts > 2:
                return None          # data decode envelope: <=2 streams
            if (win_start + extent(mod, n_sym) > cap_len
                    or n_sym * mod.nDBPS > 33000):
                return None
            psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
            if psdu_len > 4095 * (1 if nsts == 1 else 2):
                return None
            return _Plan(mod, n_sym, psdu_len, True, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        if fmt == F.HT:
            mcs, bw, length, aggre, sgi = parse_ht_sig(meta["ht_bits"][i])
            if bw != self.bw or sgi or mcs > 15:
                return None
            nss = mcs // 8 + 1
            mod = Mod(F.HT, mcs, bw, nss, sgi)
            pp = ppdu_params_nonaggregate(mod, length)
            if (pp.n_sym <= 0 or pp.n_sym * mod.nDBPS > 33000
                    or win_start + extent(mod, pp.n_sym) > cap_len
                    or not (1 <= length <= 4095)):
                return None
            return _Plan(mod, pp.n_sym, length, aggre, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        # legacy payload (MRC decode; 20 MHz only, as in the SISO receiver)
        if not bool(meta["lsig_ok"][i]) or self.q != 1:
            return None
        if not (14 <= l_len <= 4095):
            return None
        mod = Mod(F.L, l_mcs)
        pp = ppdu_params_nonaggregate(mod, l_len)
        if (pp.n_sym <= 0 or pp.n_sym * mod.nDBPS > 33000
                or win_start + l_extent(mod, pp.n_sym) > cap_len):
            return None
        return _Plan(mod, pp.n_sym, l_len, False, win_start, ltf_start,
                     cfo, cfo_hz, snr)
