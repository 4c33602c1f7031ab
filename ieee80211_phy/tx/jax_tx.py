"""Batched JAX transmitter: one jit program from PSDU bytes to IQ samples.

Batched re-design of the reference TX chain (pktgen->encode->modulation->
IFFT/CP->pad, SURVEY.md §3.2): for a static (Mod, PpduParams) config the
entire preamble (training fields + SIG fields) is a config constant
precomputed by the golden model; only the DATA field is computed on-device —
scramble (PRBS XOR), BCC (shift-XOR taps), puncture/interleave (gathers),
QAM (table lookup), pilot insertion (static scatter), IFFT (batched), GI and
boundary windowing (static scale mask). Everything is batched over packets.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..specs import BW, CR, F, M, Mod, PpduParams, tables
from ..specs import interleaver as ilv
from ..specs.modulation import (ppdu_params_aggregate, ppdu_params_nonaggregate)
from ..utils.riq import r_of
from . import golden


class TxPipeline:
    """Config-specialized batched transmitter."""

    def __init__(self, mod: Mod, pp: PpduParams,
                 scrambler: int = golden.DEFAULT_SCRAMBLER):
        assert not pp.mu, "MU TX uses the golden model for now"
        self.mod = mod
        self.pp = pp
        self.scrambler = scrambler
        self._prep()
        self.step = jax.jit(self._tx)

    # -- static precomputation ---------------------------------------------
    def _prep(self):
        mod, pp = self.mod, self.pp
        # preamble from the golden model with a zero payload: every sample
        # before the DATA field depends only on the config.
        # TX input length: raw A-MPDU bytes for VHT (EOF padding is added
        # on-device), MPDU bytes otherwise.
        self.in_len = pp.ampdu_len if mod.fmt == F.VHT else pp.psdu_len
        probe = bytes(self.in_len)
        if mod.fmt == F.L or (mod.fmt == F.HT and not pp.ampdu):
            ref = golden.gen_mpdu(probe, mod, self.scrambler)
        else:
            ref = golden.gen_ampdu(probe, mod, scrambler=self.scrambler)
        n_data_samp = pp.n_sym * 80
        wave = ref.waveform
        self.n_samp = wave.shape[-1]
        pre = wave[:, : self.n_samp - n_data_samp].astype(np.complex64)
        if pp.n_sym > 0:
            pre[:, -1] *= 1.0  # already halved by golden concat
        self.preamble = pre                                  # [nSS, nPre]
        self.sigb_crc = (ref.sigb_crc if ref.sigb_crc is not None
                         else np.zeros(0, np.int64))
        # scramble PRBS over the data-bit region
        n_dbits = 16 + 8 * pp.psdu_len + pp.n_pad_bits + \
            (6 * mod.nES if mod.fmt != F.VHT else 0)
        if mod.fmt == F.VHT:
            n_dbits = pp.n_sym * mod.nDBPS - 6 * mod.nES
        else:
            n_dbits = pp.n_sym * mod.nDBPS
        reps = -(-n_dbits // 127)
        self.prbs = np.tile(tables.SCRAMBLE_SEQ[self.scrambler],
                            reps)[:n_dbits].astype(np.int32)
        # fixed bit fields
        if mod.fmt == F.VHT:
            service = np.concatenate([np.zeros(8, np.int32),
                                      self.sigb_crc.astype(np.int32)])
            eof = np.tile(tables.EOF_PAD_SUBFRAME.astype(np.int32),
                          pp.n_pad_eof)
            self.fixed_tail = np.concatenate(
                [eof, np.zeros(8 * pp.n_pad_octet + pp.n_pad_bits, np.int32)])
        else:
            service = np.zeros(16, np.int32)
            self.fixed_tail = np.zeros(6 * mod.nES + pp.n_pad_bits, np.int32)
        self.service = service
        # puncture keep indices over one encoder's coded stream
        n_in = pp.n_sym * mod.nDBPS // mod.nES
        pat = tables.PUNCTURE[mod.cr].astype(bool)
        keep = np.tile(pat, -(-2 * n_in // len(pat)))[:2 * n_in]
        self.punct_idx = np.nonzero(keep)[0].astype(np.int32)
        # stream parser & interleaver gathers
        self.es_idx, self.bit_idx = ilv.stream_parser_maps(mod)
        self.tx_perms = np.stack([ilv.tx_perm(mod, iss)
                                  for iss in range(mod.nSS)])
        # pilots per symbol/stream
        self.pilots = np.stack([golden.pilot_sequence(mod, pp.n_sym, iss)
                                for iss in range(mod.nSS)])  # [nSS,S,nP]
        # CSD phasor per stream on the grid
        tab = tables.CSD_NONLEGACY_NS
        self.csd = np.stack([
            golden.csd_phase(mod.bw, tab[mod.nSS - 1, iss])
            for iss in range(mod.nSS)]).astype(np.complex64)  # [nSS, nfft]
        if mod.fmt == F.L:
            self.scale = np.float32(np.sqrt(tables.SCALE_DATA_L[mod.bw]
                                            * mod.nSS))
        elif mod.fmt == F.HT:
            self.scale = np.float32(np.sqrt(tables.SCALE_DATA_HT[mod.bw]
                                            * mod.nSS))
        else:
            self.scale = np.float32(np.sqrt(tables.SCALE_DATA_VHT[mod.bw]
                                            * mod.nSS))
        # boundary window: halve symbol edges; last sample of last symbol
        # stays (it is the packet end)
        w = np.ones((pp.n_sym, 80), np.float32)
        w[:, 0] = 0.5
        w[:-1, -1] = 0.5
        self.window = w
        self.qam_r = np.real(tables.QAM_TAB[mod.mod]).astype(np.float32)
        self.qam_i = np.imag(tables.QAM_TAB[mod.mod]).astype(np.float32)

    # -- the jitted program --------------------------------------------------
    def _tx(self, psdu: jnp.ndarray) -> jnp.ndarray:
        """psdu: [B, psdu_len] uint8 -> waveform [B, nSS, nSamp, 2] f32."""
        mod, pp = self.mod, self.pp
        b = psdu.shape[0]
        bits = ((psdu[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
                ).astype(jnp.int32).reshape(b, -1)
        dbits = jnp.concatenate(
            [jnp.tile(jnp.asarray(self.service)[None], (b, 1)), bits,
             jnp.tile(jnp.asarray(self.fixed_tail)[None], (b, 1))], axis=1)
        scr = dbits ^ jnp.asarray(self.prbs)[None]
        if mod.fmt == F.VHT:
            # per-encoder stride slice + zero tail, then BCC
            n_in = pp.n_sym * mod.nDBPS // mod.nES - 6
            es = jnp.stack([
                jnp.concatenate([scr[:, ies: n_in * mod.nES: mod.nES],
                                 jnp.zeros((b, 6), jnp.int32)], axis=1)
                for ies in range(mod.nES)], axis=1)     # [B, nES, nIn+6]
        else:
            t0 = 16 + pp.psdu_len * 8
            scr = scr.at[:, t0: t0 + 6 * mod.nES].set(0)
            n_in = pp.n_sym * mod.nDBPS // mod.nES
            es = jnp.stack([scr[:, ies: n_in * mod.nES: mod.nES]
                            for ies in range(mod.nES)], axis=1)
        coded = self._bcc(es)                           # [B, nES, 2*nIn]
        punct = coded[:, :, jnp.asarray(self.punct_idx)]
        punct = punct.reshape(b, mod.nES, pp.n_sym, -1)  # [B,nES,S,cbps/es]
        # stream parse + interleave + QAM per stream
        grids = []
        for iss in range(mod.nSS):
            if mod.fmt == F.L:
                stream = punct[:, 0]
            else:
                stream = punct[:, jnp.asarray(self.es_idx[iss]), :,
                               jnp.asarray(self.bit_idx[iss])]
                stream = jnp.moveaxis(stream, 0, -1)    # [B, S, nCBPSS]
            inted = stream[..., jnp.asarray(self.tx_perms[iss])]
            chips = inted.reshape(b, pp.n_sym, mod.nSD, mod.nBPSCS)
            chips = jnp.sum(chips * (1 << jnp.arange(mod.nBPSCS)), axis=-1)
            qam = (jnp.asarray(self.qam_r)[chips]
                   + 1j * jnp.asarray(self.qam_i)[chips])  # [B, S, nSD]
            nfft = tables.NFFT[mod.bw]
            grid = jnp.zeros((b, pp.n_sym, nfft), jnp.complex64)
            grid = grid.at[..., jnp.asarray(
                tables.DATA_GRID[(mod.bw, mod.fmt == F.L)])].set(qam)
            grid = grid.at[..., jnp.asarray(
                tables.PILOT_GRID[(mod.bw, mod.fmt == F.L)])].set(
                jnp.asarray(self.pilots[iss])[None].astype(jnp.complex64))
            grid = grid * jnp.asarray(self.csd[iss])[None, None, :]
            grids.append(grid)
        grids = jnp.stack(grids, axis=1)                # [B, nSS, S, nfft]
        sym = jnp.fft.ifft(jnp.fft.ifftshift(grids, axes=-1), axis=-1)
        sym = sym / self.scale
        n = sym.shape[-1]
        sym = jnp.concatenate([sym[..., 3 * n // 4:], sym], axis=-1)
        sym = sym * jnp.asarray(self.window)[None, None]
        data = sym.reshape(b, self.mod.nSS, -1)
        pre = jnp.tile(jnp.asarray(self.preamble)[None], (b, 1, 1))
        return r_of(jnp.concatenate([pre, data], axis=-1))

    def _bcc(self, bits: jnp.ndarray) -> jnp.ndarray:
        """[..., N] int bits -> [..., 2N] rate-1/2 coded (zero state)."""
        n = bits.shape[-1]
        pad = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(6, 0)])

        def taps(mask):
            out = jnp.zeros_like(bits)
            for k in range(7):
                if (mask >> k) & 1:
                    out = out ^ jax.lax.slice_in_dim(pad, 6 - k, 6 - k + n,
                                                     axis=-1)
            return out

        o0 = taps(tables.G0)
        o1 = taps(tables.G1)
        return jnp.stack([o0, o1], axis=-1).reshape(*bits.shape[:-1], 2 * n)


@lru_cache(maxsize=64)
def get_tx_pipeline(mod: Mod, psdu_len: int, ampdu: bool) -> TxPipeline:
    if mod.fmt == F.VHT or (mod.fmt == F.HT and ampdu):
        pp = ppdu_params_aggregate(mod, psdu_len)
    else:
        pp = ppdu_params_nonaggregate(mod, psdu_len)
    return TxPipeline(mod, pp)


# ---------------------------------------------------------------------------
# MU-MIMO downlink transmitter (spatial mapping Q as a runtime argument)
# ---------------------------------------------------------------------------


class _UserEncoder:
    """Per-user static constants + jit-traceable PSDU -> QAM constellations.

    Mirrors the VHT branch of TxPipeline._tx (scramble -> per-encoder BCC ->
    puncture -> stream parse -> interleave -> QAM) for one MU user sized to
    the group symbol count (reference encode2_impl.cc:129-216: both users'
    PSDUs encoded independently at their own MCS)."""

    def __init__(self, mod: Mod, pp: PpduParams, sigb_crc: np.ndarray,
                 scrambler: int):
        assert mod.fmt == F.VHT
        self.mod, self.pp = mod, pp
        n_dbits = pp.n_sym * mod.nDBPS - 6 * mod.nES
        reps = -(-n_dbits // 127)
        self.prbs = np.tile(tables.SCRAMBLE_SEQ[scrambler],
                            reps)[:n_dbits].astype(np.int32)
        self.service = np.concatenate([np.zeros(8, np.int32),
                                       sigb_crc.astype(np.int32)])
        eof = np.tile(tables.EOF_PAD_SUBFRAME.astype(np.int32), pp.n_pad_eof)
        self.fixed_tail = np.concatenate(
            [eof, np.zeros(8 * pp.n_pad_octet + pp.n_pad_bits, np.int32)])
        n_in = pp.n_sym * mod.nDBPS // mod.nES
        pat = tables.PUNCTURE[mod.cr].astype(bool)
        keep = np.tile(pat, -(-2 * n_in // len(pat)))[:2 * n_in]
        self.punct_idx = np.nonzero(keep)[0].astype(np.int32)
        self.es_idx, self.bit_idx = ilv.stream_parser_maps(mod)
        self.tx_perms = np.stack([ilv.tx_perm(mod, iss)
                                  for iss in range(mod.nSS)])
        self.qam_r = np.real(tables.QAM_TAB[mod.mod]).astype(np.float32)
        self.qam_i = np.imag(tables.QAM_TAB[mod.mod]).astype(np.float32)

    def qam(self, psdu: jnp.ndarray) -> jnp.ndarray:
        """[B, ampdu_len] uint8 -> constellations [B, nSS, S, nSD]."""
        mod, pp = self.mod, self.pp
        b = psdu.shape[0]
        bits = ((psdu[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
                ).astype(jnp.int32).reshape(b, -1)
        dbits = jnp.concatenate(
            [jnp.tile(jnp.asarray(self.service)[None], (b, 1)), bits,
             jnp.tile(jnp.asarray(self.fixed_tail)[None], (b, 1))], axis=1)
        scr = dbits ^ jnp.asarray(self.prbs)[None]
        n_in = pp.n_sym * mod.nDBPS // mod.nES - 6
        es = jnp.stack([
            jnp.concatenate([scr[:, ies: n_in * mod.nES: mod.nES],
                             jnp.zeros((b, 6), jnp.int32)], axis=1)
            for ies in range(mod.nES)], axis=1)
        coded = TxPipeline._bcc(self, es)
        punct = coded[:, :, jnp.asarray(self.punct_idx)]
        punct = punct.reshape(b, mod.nES, pp.n_sym, -1)
        streams = []
        for iss in range(mod.nSS):
            stream = punct[:, jnp.asarray(self.es_idx[iss]), :,
                           jnp.asarray(self.bit_idx[iss])]
            stream = jnp.moveaxis(stream, 0, -1)
            inted = stream[..., jnp.asarray(self.tx_perms[iss])]
            chips = inted.reshape(b, pp.n_sym, mod.nSD, mod.nBPSCS)
            chips = jnp.sum(chips * (1 << jnp.arange(mod.nBPSCS)), axis=-1)
            streams.append(jnp.asarray(self.qam_r)[chips]
                           + 1j * jnp.asarray(self.qam_i)[chips])
        return jnp.stack(streams, axis=1)              # [B, nSS, S, nSD]


class MuTxPipeline:
    """Batched VHT MU-MIMO downlink transmitter, one jit program.

    The spatial-mapping matrix Q is a RUNTIME argument: in the serving loop
    Q is refreshed each sounding round (the reference installs it via a
    message into modulation2, lib/modulation2_impl.cc:109-127, and applies
    it per symbol with procNss2SymBfQ, :354-361) while packet configs stay
    fixed — so Q-dependent preamble fields (VHT-STF/LTF/SIG-B) are computed
    on-device from constant per-STS grids, and only the legacy fields +
    VHT-SIG-A are baked constants. Sample-exact vs golden.gen_ampdu_mu."""

    def __init__(self, mods, ampdu_lens, group_id: int = 1,
                 scrambler: int = golden.DEFAULT_SCRAMBLER):
        from ..specs.modulation import ppdu_params_aggregate_mu
        self.mods = list(mods)
        self.lens = list(ampdu_lens)
        n_user = len(self.mods)
        pps0 = [ppdu_params_aggregate(m, l)
                for m, l in zip(self.mods, self.lens)]
        self.n_sym = max(p.n_sym for p in pps0)
        self.n_sts = sum(m.nSTS for m in self.mods)
        bw = self.mods[0].bw
        self.nfft = tables.NFFT[bw]
        self.gmod = Mod(F.VHT, 0, bw, self.n_sts, self.mods[0].sgi)
        self.gpp = ppdu_params_aggregate_mu(self.gmod, 0, self.n_sym)
        self.pps = [ppdu_params_aggregate_mu(m, l, self.n_sym)
                    for m, l in zip(self.mods, self.lens)]

        # constant legacy preamble + VHT-SIG-A (Q-independent; boundary with
        # the Q-dependent VHT-STF pre-halved)
        lt = golden.legacy_training(self.gmod)
        ls = golden.legacy_sig_field(self.gmod, self.gpp)
        va = golden.vht_siga_field(self.gmod, self.gpp, group_id, 0,
                                   mu_nsts=[m.nSTS for m in self.mods])
        pre = np.stack([golden.concat_blocks([lt[i], ls[i], va[i]])
                        for i in range(self.n_sts)]).astype(np.complex64)
        pre[:, -1] *= 0.5
        self.preamble = pre                            # [nSTS, nPre]

        # constant per-STS frequency grids of the Q-dependent fields
        def csd_all(g):
            return np.stack([golden.apply_csd(g[i] if g.ndim > 1 else g,
                                              bw, self.n_sts, i, False)
                             for i in range(self.n_sts)])
        stf = golden._nl_grid_from_occ(tables.STF_VHT[bw], bw)
        self.stf_grid = csd_all(stf[None].repeat(self.n_sts, 0))
        n_ltf = tables.N_LTF[self.n_sts]
        self.ltf_grids = np.stack([
            csd_all(np.stack([golden._nl_grid_from_occ(
                golden._vht_ltf_occ(bw, i, il), bw)
                for i in range(self.n_sts)]))
            for il in range(n_ltf)])                   # [nLTF, nSTS, nfft]
        sigb_ints = []
        self.sigb_crcs = []
        for u in range(n_user):
            sb_bits, crc = golden.vhtsigb_bits_mu(self.mods[u],
                                                  self.lens[u], bw)
            inted = golden.interleave_sigb(self.gmod,
                                           golden.bcc(sb_bits, CR.CR12))
            self.sigb_crcs.append(crc)
            for _ in range(self.mods[u].nSTS):
                sigb_ints.append(inted)
        sigb_grids = []
        for i in range(self.n_sts):
            qam = tables.QAM_TAB[M.BPSK][sigb_ints[i]]
            if self.n_sts in (4, 7, 8):
                qam = qam * tables.P_SIGB_NSTS478[i]
            sigb_grids.append(golden.build_grid(
                qam, tables.PILOT_VHT[bw], bw, False))
        self.sigb_grid = csd_all(np.stack(sigb_grids))

        self.users = [_UserEncoder(m, p, c, scrambler)
                      for m, p, c in zip(self.mods, self.pps,
                                         self.sigb_crcs)]
        # data grid constants: pilots (all STS use the iss-0 sequence,
        # phy80211.py:869-871 MU path), CSD phasors, scales
        self.pilots = golden.pilot_sequence(self.gmod, self.n_sym, 0)
        self.csd = np.stack([
            golden.csd_phase(bw, tables.CSD_NONLEGACY_NS[self.n_sts - 1, i])
            for i in range(self.n_sts)]).astype(np.complex64)
        self.sc_stf = np.float32(np.sqrt(tables.SCALE_STF_VHT[bw]
                                         * self.n_sts))
        self.sc_ltf = np.float32(np.sqrt(tables.SCALE_LTF_VHT[bw]
                                         * self.n_sts))
        self.sc_sigb = np.float32(np.sqrt(tables.SCALE_SIG_VHT_B[bw]
                                          * self.n_sts))
        self.sc_data = np.float32(np.sqrt(tables.SCALE_DATA_VHT[bw]
                                          * self.n_sts))
        self.data_bins = tables.DATA_GRID[(bw, False)]
        self.pilot_bins = tables.PILOT_GRID[(bw, False)]
        self.n_samp = (self.preamble.shape[-1]
                       + 80 * (1 + n_ltf + 1 + self.n_sym)
                       * (self.nfft // 64))
        self.step = jax.jit(self._tx)

    def _tx(self, psdus, q2: jnp.ndarray) -> jnp.ndarray:
        """psdus: tuple of [B, len_u] uint8 per user; q2: [nfft, nSTS,
        nSTS, 2] float32 I/Q spatial mapping. -> [B, nSTS, nSamp, 2]."""
        from ..utils.riq import r2c
        q = r2c(q2)                                    # [nfft, nSTS, nSTS]
        b = psdus[0].shape[0]
        qam = jnp.concatenate([u.qam(p) for u, p in
                               zip(self.users, psdus)], axis=1)
        grid = jnp.zeros((b, self.n_sts, self.n_sym, self.nfft),
                         jnp.complex64)
        grid = grid.at[..., jnp.asarray(self.data_bins)].set(qam)
        grid = grid.at[..., jnp.asarray(self.pilot_bins)].set(
            jnp.asarray(self.pilots)[None, None].astype(jnp.complex64))
        grid = grid * jnp.asarray(self.csd)[None, :, None, :]
        hi = jax.lax.Precision.HIGHEST     # no TF32: sample-exact vs golden
        grid = jnp.einsum("kij,bjsk->bisk", q, grid, precision=hi)

        def to_time(g, scale):
            s = jnp.fft.ifft(jnp.fft.ifftshift(g, axes=-1), axis=-1) / scale
            n = s.shape[-1]
            return jnp.concatenate([s[..., 3 * n // 4:], s], axis=-1)

        data = to_time(grid, self.sc_data)             # [B, nSTS, S, 80q]
        def map1(g_const, scale):
            gq = jnp.einsum("kij,jk->ik", q, jnp.asarray(
                g_const.astype(np.complex64)), precision=hi)
            return to_time(gq, scale)                  # [nSTS, 80q]
        stf = map1(self.stf_grid, self.sc_stf)
        ltfs = [map1(self.ltf_grids[il], self.sc_ltf)
                for il in range(self.ltf_grids.shape[0])]
        sigb = map1(self.sigb_grid, self.sc_sigb)
        head = jnp.stack([stf] + ltfs + [sigb], axis=1)  # [nSTS, nT0, 80q]
        syms = jnp.concatenate(
            [jnp.tile(head[None], (b, 1, 1, 1)), data], axis=2)
        n_t = syms.shape[2]
        w = np.ones((n_t, syms.shape[-1]), np.float32)
        w[:, 0] = 0.5
        w[:-1, -1] = 0.5
        syms = syms * jnp.asarray(w)[None, None]
        tail = syms.reshape(b, self.n_sts, -1)
        pre = jnp.tile(jnp.asarray(self.preamble)[None], (b, 1, 1))
        return r_of(jnp.concatenate([pre, tail], axis=-1))
