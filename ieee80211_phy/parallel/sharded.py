"""Sharded PHY computation over a device mesh.

Device-mesh replacement for the reference's scaling story (SURVEY.md §2.5):

  * front-end correlators run over *time-sharded* captures with an
    overlap-save halo exchanged via `ppermute` between devices (the reference
    instead streams chunks through a thread pipeline with ring buffers);
  * packet decode is *batch-sharded* (dp) — the reference's analog is
    running multiple flowgraph processes;
  * demodulated soft bits / decoded bits are regrouped with collectives
    (psum/all_gather) instead of UDP sockets.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.pipeline import make_rx_step
from ..ops import sync
from ..specs import F, Mod

HALO = 31  # lag (16) + window (16) - 1 of the STF auto-correlator


def sharded_frontend(mesh, x2):
    """STF auto-correlation of a time-sharded capture with halo exchange.

    x2: [B, T, 2] float32 I/Q with B sharded over 'dp' and T sharded over
    'sp'. Each time shard pulls HALO samples from its right neighbor over
    ppermute so the sliding correlator is seamless across shard
    boundaries (overlap-save; SURVEY.md §5 "long-context" equivalent).
    Returns ac: [B, T] (last HALO samples of the capture are zero).
    """
    from ..utils.riq import r2c
    n_sp = mesh.shape["sp"]

    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp", "sp", None),
             out_specs=P("dp", "sp"))
    def local(xb2):
        left_edge = xb2[:, :HALO]
        perm = [(i, (i - 1) % n_sp) for i in range(n_sp)]
        halo = jax.lax.ppermute(left_edge, "sp", perm)
        ext = r2c(jnp.concatenate([xb2, halo], axis=1))
        ac = sync.stf_autocorr(ext)
        # zero the wrapped-around tail on the last shard
        idx = jax.lax.axis_index("sp")
        tail_invalid = (jnp.arange(xb2.shape[1]) >= xb2.shape[1] - HALO) \
            & (idx == n_sp - 1)
        return jnp.where(tail_invalid[None, :], 0.0, ac[:, :xb2.shape[1]])

    if isinstance(x2, jax.core.Tracer):
        return local(x2)         # inside jit: mesh comes from in_shardings
    with jax.set_mesh(mesh):     # eager call: establish the mesh context
        return local(x2)


def sharded_rx(mesh, mod: Mod, n_sym: int):
    """Batch-sharded fixed-config RX step: packets split over 'dp'."""
    step = make_rx_step(mod, n_sym)
    in_shard = NamedSharding(mesh, P(("dp", "sp"), None, None))
    t_shard = NamedSharding(mesh, P(("dp", "sp")))

    @partial(jax.jit, in_shardings=(in_shard, t_shard))
    def run(x2, t0):
        return step(x2, t0)

    return run


def _local_triggers(ac: jnp.ndarray, k: int, thresh: float = 0.5,
                    plateau: int = 20, min_gap: int = 400) -> jnp.ndarray:
    """Fixed-capacity in-graph trigger: rising edges of >=plateau runs of
    ac > thresh, min_gap-deduped. ac: [B, Ta] -> t [B, k] int32 ascending,
    invalid slots = Ta (one-past-end sentinel).

    Parity with the host/native trigger (lib/trigger_impl.cc:75-110,
    ops/sync.find_triggers_np) but jit-compatible: the run-length counter
    becomes a moving-sum threshold + rising-edge mask, the sequential
    min_gap suppression a K-step scan (K is small and static).
    """
    ta = ac.shape[-1]
    above = ac > thresh
    runp = sync._movsum(above.astype(jnp.float32), plateau) > plateau - 0.5
    prev = jnp.concatenate([jnp.zeros_like(above[:, :1]), above[:, :-1]],
                           axis=1)[:, :runp.shape[1]]
    rise = runp & ~prev                                     # [B, Ta-p+1]
    big = jnp.int32(ta)

    def one_row(r):
        (idx,) = jnp.nonzero(r, size=k, fill_value=ta)
        idx = idx.astype(jnp.int32)
        def f(last, t):
            keep = (t - last >= min_gap) & (t < ta)
            return jnp.where(keep, t, last), jnp.where(keep, t, big)
        # init derived from data so its varying-axes set matches inside
        # shard_map (scan carry in/out vma must agree)
        _, out = jax.lax.scan(f, jnp.int32(-min_gap) + idx[0] * 0, idx)
        return out

    return jax.vmap(one_row)(rise)


def sharded_capture_decode(mesh, mod: Mod, n_sym: int, window_len: int,
                           k_per_shard: int = 4):
    """The CLOSED sharded capture->decode loop, one XLA program:

      sp-sharded front-end (STF autocorr with ppermute halo)
        -> in-graph trigger (fixed capacity k per time shard; a packet
           belongs to the shard containing its trigger)
        -> window extraction with a right halo of a full window length, so
           packets straddling shard edges decode seamlessly (overlap-save;
           SURVEY.md §7 "halo correctness")
        -> all_gather regroup of the windows across devices (the soft-bit/window
           redistribution the reference does with ring buffers + UDP)
        -> load-balanced decode: shard i decodes windows j = i mod n_sp,
           so unevenly distributed triggers still spread over the mesh
        -> all_gather of decoded bits (replicated out).

    Returns run(capture[B, T, 2] f32 I/Q; B over dp, T over sp) -> dict:
      bits [B, n_win, n_bits], trig_t [B, n_win] (global sample index,
      T = invalid slot), ok [B, n_win] (valid trigger & L-SIG-consistent
      decode), cfo [B, n_win].
    """
    step = make_rx_step(mod, n_sym)
    n_sp = mesh.shape["sp"]
    w = window_len
    cap_shard = NamedSharding(mesh, P("dp", "sp", None))

    # check_vma=False: outputs ARE replicated over 'sp' (they are produced
    # by all_gather over 'sp'), but the varying-axes checker cannot infer
    # replication through the gather+reshape; the parity tests in
    # tests/test_sharded_capture.py prove the replication invariant.
    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp", "sp", None),
             out_specs=(P("dp", None, None), P("dp", None), P("dp", None),
                        P("dp", None)), check_vma=False)
    def local(xb2):
        from ..utils.riq import r2c
        b, tl, _ = xb2.shape
        idx = jax.lax.axis_index("sp")
        perm = [(i, (i - 1) % n_sp) for i in range(n_sp)]
        halo = jax.lax.ppermute(xb2[:, :w], "sp", perm)     # right halo
        ext = jnp.concatenate([xb2, halo], axis=1)          # [B, Tl+w, 2]
        ac = sync.stf_autocorr(r2c(ext))
        # wrapped halo on the last shard is invalid: zero its tail ac
        tail = (jnp.arange(ac.shape[1]) >= tl) & (idx == n_sp - 1)
        ac = jnp.where(tail[None, :], 0.0, ac)
        t_loc = _local_triggers(ac[:, :tl], k_per_shard)    # [B, k]
        valid = t_loc < tl
        t_safe = jnp.minimum(t_loc, tl)
        wins = jax.vmap(                                     # [B, k, w, 2]
            lambda row, ts: jax.vmap(
                lambda t: jax.lax.dynamic_slice(
                    row, (t, 0), (w, 2)))(ts))(ext, t_safe)
        t_glob = jnp.where(valid, t_loc + idx * tl, n_sp * tl)

        # regroup: every shard sees all windows, decodes its strided share
        wins_all = jax.lax.all_gather(wins, "sp")            # [n_sp,B,k,w,2]
        val_all = jax.lax.all_gather(valid, "sp")
        tg_all = jax.lax.all_gather(t_glob, "sp")
        wins_all = jnp.moveaxis(wins_all, 0, 1).reshape(b, n_sp * k_per_shard,
                                                        w, 2)
        val_all = jnp.moveaxis(val_all, 0, 1).reshape(b, -1)
        tg_all = jnp.moveaxis(tg_all, 0, 1).reshape(b, -1)
        # sort by global time so output slots are capture-ordered
        order = jnp.argsort(tg_all, axis=1)
        wins_all = jnp.take_along_axis(
            wins_all, order[:, :, None, None], axis=1)
        val_all = jnp.take_along_axis(val_all, order, axis=1)
        tg_all = jnp.take_along_axis(tg_all, order, axis=1)

        mine = jnp.take(wins_all.reshape(b, k_per_shard, n_sp, w, 2),
                        idx, axis=2)                         # [B, k, w, 2]
        out = step(mine.reshape(b * k_per_shard, w, 2),
                   jnp.zeros(b * k_per_shard, jnp.int32))
        bits = out["bits"].reshape(b, k_per_shard, -1)
        ok = out["lsig_ok"].reshape(b, k_per_shard)
        cfo = out["cfo"].reshape(b, k_per_shard)
        # re-interleave each shard's strided share back to sorted order
        nw = n_sp * k_per_shard
        bits_g = jax.lax.all_gather(bits, "sp")              # [n_sp,B,k,nb]
        ok_g = jax.lax.all_gather(ok, "sp")
        cfo_g = jax.lax.all_gather(cfo, "sp")
        bits_f = jnp.moveaxis(bits_g, 0, 2).reshape(b, nw, -1)
        ok_f = jnp.moveaxis(ok_g, 0, 2).reshape(b, nw)
        cfo_f = jnp.moveaxis(cfo_g, 0, 2).reshape(b, nw)
        ok_f = ok_f & val_all
        return bits_f, tg_all, ok_f, cfo_f

    @partial(jax.jit, in_shardings=(cap_shard,))
    def run(capture):
        bits, trig_t, ok, cfo = local(capture)
        return dict(bits=bits, trig_t=trig_t, ok=ok, cfo=cfo)

    return run


# ---------------------------------------------------------------------------
# auto-detecting sharded loop: per-packet format/MCS/length detection
# IN-GRAPH (the reference RX detects each packet's format on the fly,
# lib/demod_impl.cc:106-219; here the whole mixed-format capture decodes in
# one XLA program over the mesh)
# ---------------------------------------------------------------------------

# nDBPS lookup tables for the in-graph planner (20 MHz defaults; the
# wideband variants are generated from the Mod descriptor)
_NDBPS_L = np.array([24, 36, 48, 72, 96, 144, 192, 216], np.int32)
_NDBPS_HT = np.array([26, 52, 78, 104, 156, 208, 234, 260], np.int32)
_NDBPS_VHT = np.array([26, 52, 78, 104, 156, 208, 234, 260, 312, 1],
                      np.int32)  # mcs9 invalid @ 20 MHz 1SS


@lru_cache(maxsize=None)
def _ndbps_q(q: int):
    """(ht [8], vht [10]) single-stream nDBPS at the capture bandwidth
    (invalid combos -> 1, which the length gates then reject)."""
    from ..specs import BW
    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    ht = np.ones(8, np.int32)
    vht = np.ones(10, np.int32)
    for m in range(8):
        if bw != BW.BW80:            # HT exists at 20/40 MHz only
            ht[m] = Mod(F.HT, m, bw, 1).nDBPS
    for m in range(10):
        try:
            vht[m] = Mod(F.VHT, m, bw, 1).nDBPS
        except ValueError:
            pass
    return ht, vht


def _bits_val(bits, lo, n):
    """LSB-first integer from bit columns [.., lo:lo+n]."""
    w = (1 << jnp.arange(n, dtype=jnp.int32))
    return jnp.sum(bits[:, lo:lo + n].astype(jnp.int32) * w, axis=-1)


def _auto_plan(meta: dict, q: int = 1) -> dict:
    """Vectorized in-graph packet planner (jit analog of
    SisoReceiver._plan_one, SISO envelope at the capture bandwidth).

    q: capture oversample factor (1/2/4 = 20/40/80 MHz): wideband
    captures plan HT40 / VHT40 / VHT80 packets (legacy payloads exist
    only at 20 MHz). meta: the sig_parse output dict (traced arrays,
    [N]-shaped fields). Returns fmt (0=L/1=HT/2=VHT, -1 invalid), mcs,
    n_sym, psdu_len, ampdu — all [N] int32/bool.
    """
    lsig_ok = meta["lsig_ok"]
    snr_ok = meta["snr"] > 0.0          # LTF-corr gate (sync_impl.cc:99)
    l_mcs = meta["l_mcs"].astype(jnp.int32)
    l_len = meta["l_len"].astype(jnp.int32)
    ht_ok = meta["ht_ok"]
    vht_ok = meta["vht_ok"]
    imag_dom = meta["nl1_imag_dom"]

    # format pick (mirror of _pick_nl_format): only an L-SIG rate of MCS0
    # can hide a non-legacy preamble
    nl = lsig_ok & (l_mcs == 0)
    pick_vht = nl & vht_ok & (~imag_dom | ~ht_ok)
    pick_ht = nl & ht_ok & ~pick_vht
    pick_l = lsig_ok & ~pick_vht & ~pick_ht

    # legacy (20 MHz captures only)
    ndl = jnp.asarray(_NDBPS_L)[jnp.clip(l_mcs, 0, 7)]
    l_n_sym = (8 * l_len + 22 + ndl - 1) // ndl
    l_valid = pick_l & (l_len >= 14) & (l_len <= 4095) & (q == 1)

    ht_tab, vht_tab = _ndbps_q(q)
    # HT-SIG fields (cloud80211phy.cc:730-751 semantics, vectorized)
    hb = meta["ht_bits"]
    ht_mcs = _bits_val(hb, 0, 7)
    ht_bw40 = hb[:, 7].astype(bool)
    ht_len = _bits_val(hb, 8, 16)
    ht_aggre = hb[:, 27].astype(bool)
    ht_sgi = hb[:, 31].astype(bool)
    ht_mcs_c = jnp.clip(ht_mcs, 0, 7)
    ndh = jnp.asarray(ht_tab)[ht_mcs_c]
    ht_n_sym = (8 * ht_len + 22 + ndh - 1) // ndh
    ht_valid = pick_ht & (ht_mcs <= 7) & (ht_bw40 == (q == 2)) \
        & (q <= 2) & ~ht_sgi & (ht_len >= 1) & (ht_len <= 4095)

    # VHT-SIG-A fields; nSym from the spoofed L-SIG duration
    vb = meta["vht_bits"]
    vht_bw = _bits_val(vb, 0, 2)
    vht_nsts = _bits_val(vb, 10, 3) + 1
    vht_sgi = vb[:, 24].astype(bool)
    vht_mcs = _bits_val(vb, 28, 4)
    n_sym_l = (l_len * 8 + 22 + 23) // 24
    vht_n_sym = n_sym_l - 4 - 1          # nLTF = 1 (SISO)
    vht_mcs_c = jnp.clip(vht_mcs, 0, 9)
    vndbps = jnp.asarray(vht_tab)[vht_mcs_c]
    vht_psdu = (vht_n_sym * vndbps - 16 - 6) // 8
    vht_valid = pick_vht & (vht_bw == {1: 0, 2: 1, 4: 2}[q]) \
        & (vht_nsts == 1) & ~vht_sgi & (vndbps > 1) \
        & (vht_n_sym >= 1) & (vht_psdu >= 1) & (vht_psdu <= 4095)

    fmt = jnp.where(vht_valid, 2, jnp.where(ht_valid, 1,
                    jnp.where(l_valid, 0, -1)))
    mcs = jnp.where(vht_valid, vht_mcs, jnp.where(ht_valid, ht_mcs, l_mcs))
    n_sym = jnp.where(vht_valid, vht_n_sym,
                      jnp.where(ht_valid, ht_n_sym, l_n_sym))
    psdu_len = jnp.where(vht_valid, vht_psdu,
                         jnp.where(ht_valid, ht_len, l_len))
    valid = (l_valid | ht_valid | vht_valid) & snr_ok
    fmt = jnp.where(valid, fmt, -1)
    return dict(fmt=fmt.astype(jnp.int32), mcs=mcs.astype(jnp.int32),
                n_sym=n_sym.astype(jnp.int32),
                psdu_len=psdu_len.astype(jnp.int32), ampdu=ht_aggre)


def _auto_plan2(meta: dict, q: int = 1, mu_pos: int = 0,
                mu_gid: int = None) -> dict:
    """_auto_plan extended to the DUAL-CHAIN envelope: adds nSS (1 or 2)
    and an NDP flag (VHT whose spoofed-length symbol budget is <= 0,
    lib/decode_impl.cc:100-121). HT MCS 0-15 (20/40 MHz), VHT nSTS 1-2
    at the capture bandwidth (q = 1/2/4).

    mu_gid (static): also flag downlink MU PPDUs of that group whose
    layout gives position mu_pos a single stream — `mu` windows carry
    mu_n_sym/mu_nsts/mu_sidx and decode through the loop's MU branches
    (the in-graph analog of rx/receiver._plan_mu_batch)."""
    lsig_ok = meta["lsig_ok"]
    snr_ok = meta["snr"] > 0.0
    l_mcs = meta["l_mcs"].astype(jnp.int32)
    l_len = meta["l_len"].astype(jnp.int32)
    ht_ok = meta["ht_ok"]
    vht_ok = meta["vht_ok"]
    imag_dom = meta["nl1_imag_dom"]

    nl = lsig_ok & (l_mcs == 0)
    pick_vht = nl & vht_ok & (~imag_dom | ~ht_ok)
    pick_ht = nl & ht_ok & ~pick_vht
    pick_l = lsig_ok & ~pick_vht & ~pick_ht

    ndl = jnp.asarray(_NDBPS_L)[jnp.clip(l_mcs, 0, 7)]
    l_n_sym = (8 * l_len + 22 + ndl - 1) // ndl
    l_valid = pick_l & (l_len >= 14) & (l_len <= 4095) & (q == 1)

    ht_tab, vht_tab = _ndbps_q(q)
    hb = meta["ht_bits"]
    ht_mcs = _bits_val(hb, 0, 7)
    ht_bw40 = hb[:, 7].astype(bool)
    ht_len = _bits_val(hb, 8, 16)
    ht_aggre = hb[:, 27].astype(bool)
    ht_sgi = hb[:, 31].astype(bool)
    ht_nss = ht_mcs // 8 + 1
    ndh = jnp.asarray(ht_tab)[jnp.clip(ht_mcs % 8, 0, 7)] * ht_nss
    ht_n_sym = (8 * ht_len + 22 + ndh - 1) // ndh
    ht_valid = pick_ht & (ht_mcs <= 15) & (ht_bw40 == (q == 2)) \
        & (q <= 2) & ~ht_sgi & (ht_len >= 1) & (ht_len <= 4095)

    vb = meta["vht_bits"]
    vht_bw = _bits_val(vb, 0, 2)
    vht_nsts = _bits_val(vb, 10, 3) + 1
    vht_sgi = vb[:, 24].astype(bool)
    vht_mcs = _bits_val(vb, 28, 4)
    n_sym_l = (l_len * 8 + 22 + 23) // 24
    v_nltf = jnp.where(vht_nsts > 1, 2, 1)
    # nSTS > 2 only relevant for NDPs (data envelope is <= 2 streams)
    v_nltf = jnp.where(vht_nsts > 2, 4, v_nltf)
    vht_n_sym = n_sym_l - 2 - 1 - v_nltf - 1
    vndbps1 = jnp.asarray(vht_tab)[jnp.clip(vht_mcs, 0, 9)]
    vndbps = vndbps1 * jnp.minimum(vht_nsts, 2)
    vht_psdu = (vht_n_sym * vndbps - 16 - 6) // 8
    vht_fields_ok = pick_vht & (vht_bw == {1: 0, 2: 1, 4: 2}[q]) & ~vht_sgi
    ndp = vht_fields_ok & (vht_nsts >= 1) & (vht_n_sym <= 0)
    vht_valid = vht_fields_ok & (vht_nsts <= 2) & (vndbps1 > 1) \
        & (vht_n_sym >= 1) & (vht_psdu >= 1) & (vht_psdu <= 4095)

    fmt = jnp.where(vht_valid, 2, jnp.where(ht_valid, 1,
                    jnp.where(l_valid, 0, -1)))
    mcs = jnp.where(vht_valid, vht_mcs, jnp.where(ht_valid, ht_mcs, l_mcs))
    nss = jnp.where(vht_valid, jnp.minimum(vht_nsts, 2),
                    jnp.where(ht_valid, ht_nss, 1))
    n_sym = jnp.where(vht_valid, vht_n_sym,
                      jnp.where(ht_valid, ht_n_sym, l_n_sym))
    psdu_len = jnp.where(vht_valid, vht_psdu,
                         jnp.where(ht_valid, ht_len, l_len))
    valid = (l_valid | ht_valid | vht_valid) & snr_ok
    fmt = jnp.where(valid, fmt, -1)
    out = dict(fmt=fmt.astype(jnp.int32), mcs=mcs.astype(jnp.int32),
               nss=nss.astype(jnp.int32), n_sym=n_sym.astype(jnp.int32),
               psdu_len=psdu_len.astype(jnp.int32), ampdu=ht_aggre,
               ndp=ndp & snr_ok)
    if mu_gid is not None:
        gid = _bits_val(vb, 4, 6)
        nsts_u = jnp.stack([_bits_val(vb, 10 + 3 * u, 3)
                            for u in range(4)], axis=1)      # [N, 4]
        n_tot = jnp.sum(nsts_u, axis=1)
        mu_nltf = jnp.asarray(np.asarray([1, 1, 2, 4, 4],
                                         np.int32))[jnp.clip(n_tot, 0, 4)]
        mu_n_sym = n_sym_l - 2 - 1 - mu_nltf - 1
        mu = (lsig_ok & (l_mcs == 0) & vht_ok & snr_ok
              & (gid == mu_gid) & (vht_bw == {1: 0, 2: 1, 4: 2}[q])
              & ~vht_sgi & (nsts_u[:, mu_pos] == 1)
              & (n_tot >= 1) & (n_tot <= 4) & (mu_n_sym >= 1))
        sidx = jnp.concatenate(
            [jnp.zeros_like(nsts_u[:, :1]),
             jnp.cumsum(nsts_u, axis=1)[:, :-1]], axis=1)[:, mu_pos]
        out.update(mu=mu, mu_n_sym=mu_n_sym.astype(jnp.int32),
                   mu_nsts=n_tot.astype(jnp.int32),
                   mu_sidx=sidx.astype(jnp.int32))
        out["fmt"] = jnp.where(mu, -1, out["fmt"])   # MU exits the SU path
    return out


_FMT_CODE = {F.L: 0, F.HT: 1, F.VHT: 2}


def _mu_ingraph(mod: Mod, n_sym: int, mu_pos: int, q: int):
    """In-graph downlink MU own-stream decode for the mesh loop.

    Unlike the host-driven streaming path (which groups windows by the
    group's static (stream_idx, nSTS)), the one-program loop handles the
    group layout DYNAMICALLY: 4 NL-LTF symbols are always extracted and
    the P-row combining masks l >= nLTF, SIG-B/data offsets are
    per-window dynamic starts. Envelope: every group member carries one
    stream (stream index == group position), groups of 1..4 streams.

    Returns sigb(yf2, ltf_start, nltf, nsts) -> (mcs [G], crc8 [G]) and
    data(yf2, ltf_start, nltf, nsts, n_valid, crc8) ->
    (bits [G, n_bits], sigb_ok [G]); yf2: [G, nRx, w] complex,
    CFO-corrected."""
    from ..mu.sounding import MU_SIGB_INFO, MU_SIGB_LEN
    from ..rx.receiver import _crc8_matrix
    from ..specs import BW, CR, tables as T
    from ..specs import interleaver as ilv
    from ..ops import coding, demod

    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    nfft, gi, sh = 64 * q, 16 * q, 4 * q
    off_nl = 448
    n_len = MU_SIGB_LEN[bw]
    n_info = MU_SIGB_INFO[bw]

    def chans(yf2, ltf_start, nltf, nsts):
        g, nrx, _ = yf2.shape
        yf = yf2.reshape(g * nrx, -1)
        ls2 = jnp.repeat(ltf_start, nrx)
        ltf_f = demod.fft_syms(demod.extract_symbol_windows(
            yf, ls2 + off_nl * q, 4, nfft=nfft, gi=gi,
            shift=sh)).reshape(g, nrx, 4, nfft)
        ref = jnp.asarray(demod.ltf_ref_grid(bw, False))
        safe_ref = jnp.where(ref == 0, 1.0, ref)
        p_row = jnp.asarray(T.P_LTF_4[mu_pos])               # [4]
        lmask = (jnp.arange(4)[None, :] < nltf[:, None])     # [G, 4]
        h_u = jnp.einsum("gl,grlk->grk",
                         p_row[None, :] * lmask, ltf_f) \
            / nltf[:, None, None] / safe_ref
        h_u = jnp.where((ref == 0)[None, None], 1.0 + 0j, h_u)
        pil = jnp.asarray(T.PILOT_GRID[(bw, False)])
        sum_h_pil = ltf_f[:, :, 0, :][..., pil] / safe_ref[pil]
        return yf, ls2, h_u, sum_h_pil, pil

    def sigb(yf2, ltf_start, nltf, nsts):
        g, nrx, _ = yf2.shape
        yf, ls2, h_u, sum_h_pil, pil = chans(yf2, ltf_start, nltf, nsts)
        nltf2 = jnp.repeat(nltf, nrx)
        sb = demod.fft_syms(demod.extract_symbol_windows(
            yf, ls2 + (off_nl + 80 * nltf2) * q, 1, nfft=nfft, gi=gi,
            shift=sh)).reshape(g, nrx, nfft)
        pref = jnp.asarray(T.PILOT_VHT[bw] * T.PILOT_POLARITY[3])
        acc = jnp.sum(sb[..., pil] * jnp.conj(sum_h_pil * pref[None, None]),
                      axis=(1, 2))
        ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
        sb = sb / ph[:, None, None]
        eq = demod.mrc_combine(sb[:, :, None, :], h_u)[:, 0]
        llr = jnp.real(eq[..., jnp.asarray(T.DATA_GRID[(bw, False)])])
        sign = jnp.where(nsts == 4,
                         float(T.P_SIGB_NSTS478[mu_pos]), 1.0)
        llr = llr * sign[:, None]
        llr = llr[..., jnp.asarray(ilv.rx_perm(Mod(F.VHT, 0, bw, 1)))]
        bits = coding.viterbi_decode(llr, CR.CR12, n_info)
        mcs = jnp.sum(bits[:, n_len:n_len + 4].astype(jnp.int32)
                      * (1 << jnp.arange(4, dtype=jnp.int32)), axis=1)
        mat, const = _crc8_matrix(n_len + 4)
        crc_bits = (bits[:, :n_len + 4].astype(jnp.int32)
                    @ jnp.asarray(mat) + jnp.asarray(const)) % 2
        crc = jnp.sum(crc_bits * (1 << jnp.arange(8, dtype=jnp.int32)),
                      axis=1)
        return mcs, crc

    n_bits = n_sym * mod.nDBPS

    def data(yf2, ltf_start, nltf, nsts, n_valid, crc8):
        g, nrx, _ = yf2.shape
        yf, ls2, h_u, sum_h_pil, pil = chans(yf2, ltf_start, nltf, nsts)
        nltf2 = jnp.repeat(nltf, nrx)
        gd = demod.fft_syms(demod.extract_symbol_windows(
            yf, ls2 + (off_nl + 80 * nltf2 + 80) * q, n_sym, nfft=nfft,
            gi=gi, shift=sh)).reshape(g, nrx, n_sym, nfft)
        pref = jnp.asarray(np.asarray(demod.pilot_refs(mod, n_sym, 4)))
        exp = sum_h_pil[:, :, None, :] * pref[None, None]
        acc = jnp.sum(gd[..., pil] * jnp.conj(exp), axis=(1, 3))
        ph = acc / jnp.maximum(jnp.abs(acc), 1e-12)
        gd = gd / ph[:, None, :, None]
        eq = demod.mrc_combine(gd, h_u)
        dg = jnp.asarray(T.DATA_GRID[(bw, False)])
        data_t = eq[..., dg]
        llr = demod.demap_llr(data_t, mod.mod)
        wg = jnp.sum(jnp.abs(h_u) ** 2, axis=1)[..., dg]
        wg = wg / jnp.maximum(jnp.mean(wg, axis=-1, keepdims=True), 1e-12)
        nb = llr.shape[-1] // data_t.shape[-1]
        llr = llr * jnp.repeat(wg, nb, axis=-1)[:, None, :]
        llr = llr[..., jnp.asarray(ilv.rx_perm(mod, 0))].reshape(g, -1)
        sym_m = (jnp.arange(n_sym, dtype=jnp.int32)[None, :]
                 < n_valid[:, None])
        ncbpss = llr.shape[1] // n_sym
        llr = jnp.where(jnp.repeat(sym_m, ncbpss, axis=1), llr, 0.0)
        bits = coding.viterbi_decode(llr, mod.cr, n_bits)
        scr = coding.descramble(bits)
        svc = jnp.sum(scr[:, 8:16].astype(jnp.int32)
                      * (1 << jnp.arange(8, dtype=jnp.int32)), axis=1)
        return scr, svc == crc8

    return sigb, data


def branch_window_len(mod: Mod, n_sym_cap: int) -> int:
    """Window length needed to decode up to n_sym_cap symbols of mod."""
    from ..models.pipeline import RxPipeline
    return RxPipeline(mod, n_sym_cap, 0).window_len()


def sharded_capture_decode_auto(mesh, branches, window_len: int,
                                k_per_shard: int = 4,
                                generic: bool = False, q: int = 1):
    """Mixed-format sharded capture decode with IN-GRAPH auto-detection.

    branches: static tuple of (Mod, n_sym_cap) decode branches. Every
    detected packet is planned in-graph from its own SIG fields
    (sig_parse + _auto_plan) and routed to the first branch whose
    (format, mcs) matches and whose symbol capacity fits — the masked
    analog of the reference's per-packet format dispatch
    (lib/demod_impl.cc:106-219). Each branch's fixed-config RX step runs
    over all windows; outputs are one-hot selected. That costs
    len(branches)x the single-config decode but keeps the whole mixed
    capture in ONE XLA program over the mesh.

    generic=True replaces the per-branch decode loop with the
    table-driven rx/generic.GenericSisoDecoder: ONE shared-trellis
    decode whose per-window (rate, constellation, interleaver,
    depuncture) come from gathered config tables — the fix for the
    ~7 ms/branch dispatch floor (docs/PERF_NOTES.md: a 42-config MCS
    matrix costs ~0.3 s/invocation through per-branch launches; the
    generic program costs ~one worst-case decode regardless of branch
    count — measured in perf_generic_r5.py).

    Pipeline (one program): sp-sharded STF autocorr with ppermute halo ->
    in-graph trigger (capacity k_per_shard, with an overflow flag when a
    (k+1)-th deduped trigger exists) -> halo window extraction ->
    all_gather regroup -> per-window SIG parse + plan -> masked
    multi-branch decode -> all_gather of bits + plan meta.

    Returns run(capture[B, T, 2]; B over dp, T over sp) -> dict:
      bits [B, n_win, max_bits], trig_t, ok, fmt, mcs, n_sym, psdu_len,
      ampdu [B, n_win], overflow [B] (True => a shard saturated its
      trigger capacity and may have dropped packets).
    """
    from ..models.pipeline import make_rx_step
    from ..rx.receiver import sig_parse

    branches = tuple(branches)
    from ..specs import BW
    bw_q = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    for m, cap in branches:
        assert m.bw == bw_q, f"branch {m} vs capture bandwidth {bw_q}"
        need = branch_window_len(m, cap)
        assert window_len >= need, (
            f"window_len {window_len} < {need} required by branch "
            f"({m.fmt.name} mcs{m.mcs}, {cap} sym)")
    if generic:
        assert q == 1, "the generic decoder covers the 20 MHz envelope"
    if generic:
        from ..rx.generic import GenericSisoDecoder
        cap_max = max(cap for _, cap in branches)
        gen_dec = GenericSisoDecoder(
            tuple((m.fmt, m.mcs) for m, _ in branches), cap_max)
        # (fmt, mcs) -> config row; -1 = no branch
        lut = np.full((3, 16), -1, np.int32)
        caps_tab = np.zeros(len(branches), np.int32)
        for j, (m, capj) in enumerate(branches):
            if lut[_FMT_CODE[m.fmt], m.mcs] < 0:
                lut[_FMT_CODE[m.fmt], m.mcs] = j
            caps_tab[j] = capj
        steps = []
        n_bits_max = gen_dec.n_bits_max
    else:
        steps = [make_rx_step(m, cap) for m, cap in branches]
        n_bits_max = max(cap * m.nDBPS for m, cap in branches)
    n_sp = mesh.shape["sp"]
    w = window_len
    cap_shard = NamedSharding(mesh, P("dp", "sp", None))

    # check_vma=False for the same reason as sharded_capture_decode: the
    # outputs are replicated over 'sp' by construction (all_gather), which
    # the varying-axes checker cannot see through.
    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp", "sp", None),
             out_specs=(P("dp", None, None),) + (P("dp", None),) * 7
             + (P("dp"),), check_vma=False)
    def local(xb2):
        from ..utils.riq import r2c
        b, tl, _ = xb2.shape
        idx = jax.lax.axis_index("sp")
        perm = [(i, (i - 1) % n_sp) for i in range(n_sp)]
        halo = jax.lax.ppermute(xb2[:, :w], "sp", perm)
        ext = jnp.concatenate([xb2, halo], axis=1)
        ac = sync.stf_autocorr(r2c(ext), lag=16 * q, win=16 * q)
        tail = (jnp.arange(ac.shape[1]) >= tl) & (idx == n_sp - 1)
        ac = jnp.where(tail[None, :], 0.0, ac)
        t_ext = _local_triggers(ac[:, :tl], k_per_shard + 1,
                                plateau=20 * q, min_gap=600 * q)
        t_loc = t_ext[:, :k_per_shard]
        overflow = t_ext[:, k_per_shard] < tl          # [B] capacity hit
        valid = t_loc < tl
        t_safe = jnp.minimum(t_loc, tl)
        wins = jax.vmap(
            lambda row, ts: jax.vmap(
                lambda t: jax.lax.dynamic_slice(
                    row, (t, 0), (w, 2)))(ts))(ext, t_safe)
        t_glob = jnp.where(valid, t_loc + idx * tl, n_sp * tl)

        wins_all = jax.lax.all_gather(wins, "sp")
        val_all = jax.lax.all_gather(valid, "sp")
        tg_all = jax.lax.all_gather(t_glob, "sp")
        ov_all = jnp.any(jax.lax.all_gather(overflow, "sp"), axis=0)
        wins_all = jnp.moveaxis(wins_all, 0, 1).reshape(
            b, n_sp * k_per_shard, w, 2)
        val_all = jnp.moveaxis(val_all, 0, 1).reshape(b, -1)
        tg_all = jnp.moveaxis(tg_all, 0, 1).reshape(b, -1)
        order = jnp.argsort(tg_all, axis=1)
        wins_all = jnp.take_along_axis(
            wins_all, order[:, :, None, None], axis=1)
        val_all = jnp.take_along_axis(val_all, order, axis=1)
        tg_all = jnp.take_along_axis(tg_all, order, axis=1)
        # cross-shard trigger dedup (see sharded_capture_decode_auto2)
        prev_t = jnp.concatenate(
            [jnp.full_like(tg_all[:, :1], -(1 << 30)), tg_all[:, :-1]],
            axis=1)
        val_all = val_all & (tg_all - prev_t >= 600 * q)

        mine = jnp.take(wins_all.reshape(b, k_per_shard, n_sp, w, 2),
                        idx, axis=2)
        xw = mine.reshape(b * k_per_shard, w, 2)
        t0 = jnp.zeros(b * k_per_shard, jnp.int32)

        meta = sig_parse(xw, t0, q=q)
        plan = _auto_plan(meta, q)

        # branch routing: first branch whose (fmt, mcs) matches and whose
        # symbol capacity fits
        if generic:
            fmt_c = jnp.clip(plan["fmt"], 0, 2)
            mcs_c = jnp.clip(plan["mcs"], 0, 15)
            bid = jnp.asarray(lut)[fmt_c, mcs_c]
            bid = jnp.where(
                (plan["fmt"] >= 0)
                & (plan["n_sym"] <= jnp.asarray(caps_tab)[
                    jnp.clip(bid, 0, None)]), bid, -1)
            nv = jnp.clip(plan["n_sym"], 1, cap_max)
            bits = gen_dec.decode(xw, meta["ltf_start"].astype(jnp.int32),
                                  meta["cfo"], jnp.clip(bid, 0, None),
                                  nv).astype(jnp.int32)
        else:
            bid = jnp.full(b * k_per_shard, -1, jnp.int32)
            for j, (m, capj) in enumerate(branches):
                match = (plan["fmt"] == _FMT_CODE[m.fmt]) \
                    & (plan["mcs"] == m.mcs) & (plan["n_sym"] <= capj)
                bid = jnp.where((bid < 0) & match, j, bid)

            bits = jnp.zeros((b * k_per_shard, n_bits_max), jnp.int32)
            for j, step in enumerate(steps):
                oj = step(xw, t0)
                bj = oj["bits"].astype(jnp.int32)
                if bj.shape[1] < n_bits_max:
                    bj = jnp.pad(bj,
                                 ((0, 0), (0, n_bits_max - bj.shape[1])))
                bits = jnp.where((bid == j)[:, None], bj, bits)
        ok = bid >= 0

        def regroup(a, dims):
            g = jax.lax.all_gather(a, "sp")          # [n_sp, B*k, ...]
            g = g.reshape((n_sp, b, k_per_shard) + dims)
            return jnp.moveaxis(g, 0, 2).reshape(
                (b, n_sp * k_per_shard) + dims)

        bits_f = regroup(bits, (n_bits_max,))
        ok_f = regroup(ok, ()) & val_all
        fmt_f = regroup(plan["fmt"], ())
        mcs_f = regroup(plan["mcs"], ())
        nsym_f = regroup(plan["n_sym"], ())
        psdu_f = regroup(plan["psdu_len"], ())
        amp_f = regroup(plan["ampdu"], ())
        return (bits_f, tg_all, ok_f, fmt_f, mcs_f, nsym_f, psdu_f,
                amp_f, ov_all)

    @partial(jax.jit, in_shardings=(cap_shard,))
    def run(capture):
        (bits, trig_t, ok, fmt, mcs, n_sym, psdu_len, ampdu,
         overflow) = local(capture)
        return dict(bits=bits, trig_t=trig_t, ok=ok, fmt=fmt, mcs=mcs,
                    n_sym=n_sym, psdu_len=psdu_len, ampdu=ampdu,
                    overflow=overflow)

    return run


def sharded_capture_decode_auto2(mesh, branches, window_len: int,
                                 k_per_shard: int = 4,
                                 branch_cap: int = None, q: int = 1,
                                 mu_branches=(), mu_pos: int = 0,
                                 mu_gid: int = None):
    """DUAL-CHAIN mixed-format sharded capture decode with in-graph
    auto-detection — the one-program mesh analog of the reference's rx2
    flowgraph (examples/rx2.grc): SISO packets decode with MRC combining
    across both chains, 2x2 packets with the MIMO detector, and VHT NDPs
    emit their CFO-corrected LTF windows in-graph.

    branches: static tuple of (Mod, n_sym_cap) with mod.nSS in {1, 2}.

    branch_cap: optional per-branch window capacity K. Without it every
    branch decodes ALL windows and outputs are one-hot selected (cost x
    len(branches) — fine at 3 branches, prohibitive at the 42-config MCS
    matrix). With it, each branch gathers at most K windows whose planned
    (fmt, mcs, nSS) matches (stable in-graph sort on the branch id), so
    the decode cost is sum_j K_j x cost_j ~ n_win x cost instead of
    n_win x sum_j cost_j; `branch_overflow[j]` flags truncation (the
    same fixed-capacity contract as the trigger itself).

    mu_branches/mu_pos/mu_gid: optional downlink-MU decode branches for
    a station at group position mu_pos in group mu_gid — each a
    (Mod(F.VHT, mcs, bw, 1), n_sym_cap). MU windows are detected
    in-graph from SIG-A (single-stream-per-user groups of 1..4 streams,
    dynamic layout via masked P-row combining), their (mcs, len) decoded
    from an in-graph MU SIG-B pass, and routed like every other branch;
    `mu[b, j]` flags them and `ok` additionally requires the SIG-B
    CRC-8 vs SERVICE check.

    Returns run(capture[B, nRx, T, 2]; B over dp, T over sp) -> dict:
      bits [B, n_win, max_bits], trig_t, ok, fmt, mcs, nss, n_sym,
      psdu_len, ampdu, mu [B, n_win]; ndp [B, n_win] flag + ndp_ltf
      [B, n_win, nRx, 160q, 2] CFO-corrected VHT-LTF windows;
      overflow [B]; branch_overflow [B, n_branches (+ mu branches)].
    """
    from ..rx.mimo import MimoDataDecoder, MrcDataDecoder
    from ..rx.receiver import OFF_NLLTF, sig_parse_mimo

    branches = tuple(branches)
    from ..specs import BW
    bw_q = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    decs = [(MimoDataDecoder(m, cap) if m.nSS == 2
             else MrcDataDecoder(m, cap)) for m, cap in branches]
    for (m, cap), dec in zip(branches, decs):
        assert m.bw == bw_q, f"branch {m} vs capture bandwidth {bw_q}"
        need = 272 * q + dec.data_offset() + (cap * 80 + 80) * q
        assert window_len >= need, (
            f"window_len {window_len} < {need} required by branch "
            f"({m.fmt.name} mcs{m.mcs} nSS{m.nSS}, {cap} sym)")
    mu_branches = tuple(mu_branches)
    assert not mu_branches or mu_gid is not None
    for m, cap in mu_branches:
        assert m.fmt == F.VHT and m.nSS == 1 and m.bw == bw_q
        need = (272 + 448 + 4 * 80 + 160 + cap * 80 + 80) * q
        assert window_len >= need, (
            f"window_len {window_len} < {need} required by MU branch "
            f"(VHT mcs{m.mcs}, {cap} sym)")
    mu_fns = [_mu_ingraph(m, cap, mu_pos, q) for m, cap in mu_branches]
    n_bits_max = max([cap * m.nDBPS for m, cap in branches]
                    + [cap * m.nDBPS for m, cap in mu_branches])
    n_sp = mesh.shape["sp"]
    w = window_len
    n_br = len(branches)
    cap_shard = NamedSharding(mesh, P("dp", None, "sp", None))

    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp", None, "sp", None),
             out_specs=(P("dp", None, None),) + (P("dp", None),) * 10
             + (P("dp", None, None, None, None), P("dp"), P("dp", None)),
             check_vma=False)
    def local(xb2):
        from ..utils.riq import r2c
        b, nrx, tl, _ = xb2.shape
        idx = jax.lax.axis_index("sp")
        perm = [(i, (i - 1) % n_sp) for i in range(n_sp)]
        halo = jax.lax.ppermute(xb2[:, :, :w], "sp", perm)
        ext = jnp.concatenate([xb2, halo], axis=2)      # [B, nRx, Tl+w, 2]
        # trigger on the max of per-chain autocorrelations: detection
        # survives one chain's fade (beyond rx2.grc's chain-0 trigger)
        ac = sync.stf_autocorr(r2c(ext.reshape(b * nrx, tl + w, 2)),
                               lag=16 * q, win=16 * q)
        ac = jnp.max(ac.reshape(b, nrx, -1), axis=1)
        tail = (jnp.arange(ac.shape[1]) >= tl) & (idx == n_sp - 1)
        ac = jnp.where(tail[None, :], 0.0, ac)
        t_ext = _local_triggers(ac[:, :tl], k_per_shard + 1,
                                plateau=20 * q, min_gap=600 * q)
        t_loc = t_ext[:, :k_per_shard]
        overflow = t_ext[:, k_per_shard] < tl
        valid = t_loc < tl
        t_safe = jnp.minimum(t_loc, tl)
        wins = jax.vmap(                         # [B, k, nRx, w, 2]
            lambda row, ts: jax.vmap(
                lambda t: jax.lax.dynamic_slice(
                    row, (0, t, 0), (nrx, w, 2)))(ts))(ext, t_safe)
        t_glob = jnp.where(valid, t_loc + idx * tl, n_sp * tl)

        wins_all = jax.lax.all_gather(wins, "sp")
        val_all = jax.lax.all_gather(valid, "sp")
        tg_all = jax.lax.all_gather(t_glob, "sp")
        ov_all = jnp.any(jax.lax.all_gather(overflow, "sp"), axis=0)
        wins_all = jnp.moveaxis(wins_all, 0, 1).reshape(
            b, n_sp * k_per_shard, nrx, w, 2)
        val_all = jnp.moveaxis(val_all, 0, 1).reshape(b, -1)
        tg_all = jnp.moveaxis(tg_all, 0, 1).reshape(b, -1)
        order = jnp.argsort(tg_all, axis=1)
        wins_all = jnp.take_along_axis(
            wins_all, order[:, :, None, None, None], axis=1)
        val_all = jnp.take_along_axis(val_all, order, axis=1)
        tg_all = jnp.take_along_axis(tg_all, order, axis=1)
        # cross-shard trigger dedup: an STF straddling a shard edge fires
        # in BOTH shards (per-shard min_gap suppression cannot see across
        # the boundary); after the global time-sort, drop any window
        # within min_gap of its predecessor
        prev_t = jnp.concatenate(
            [jnp.full_like(tg_all[:, :1], -(1 << 30)), tg_all[:, :-1]],
            axis=1)
        val_all = val_all & (tg_all - prev_t >= 600 * q)

        mine = jnp.take(wins_all.reshape(b, k_per_shard, n_sp, nrx, w, 2),
                        idx, axis=2)
        n_loc = b * k_per_shard
        xw = mine.reshape(n_loc, nrx, w, 2)
        t0 = jnp.zeros(n_loc, jnp.int32)

        meta = sig_parse_mimo(xw, t0, q=q)
        plan = _auto_plan2(meta, q, mu_pos, mu_gid)
        ltf_start = meta["ltf_start"].astype(jnp.int32)
        cfo = meta["cfo"]

        # CFO-corrected complex windows (shared by the MU pass + NDP slice)
        xs = r2c(xw)                             # [n_loc, nRx, w]
        ys = xs * sync.cfo_ramp(cfo, w)[:, None, :]

        bid = jnp.full(n_loc, -1, jnp.int32)
        for j, (m, capj) in enumerate(branches):
            match = (plan["fmt"] == _FMT_CODE[m.fmt]) \
                & (plan["mcs"] == m.mcs) & (plan["nss"] == m.nSS) \
                & (plan["n_sym"] <= capj) & ~plan["ndp"]
            bid = jnp.where((bid < 0) & match, j, bid)
        if mu_branches:
            mu_nltf = jnp.asarray(np.asarray([1, 1, 2, 4, 4], np.int32))[
                jnp.clip(plan["mu_nsts"], 0, 4)]
            mu_mcs, mu_crc = mu_fns[0][0](ys, ltf_start, mu_nltf,
                                          plan["mu_nsts"])
            for j, (m, capj) in enumerate(mu_branches):
                match = plan["mu"] & (mu_mcs == m.mcs) \
                    & (plan["mu_n_sym"] <= capj)
                bid = jnp.where((bid < 0) & match, n_br + j, bid)

        nv_all = jnp.clip(plan["n_sym"], 1, None)
        bits = jnp.zeros((n_loc, n_bits_max), jnp.int32)
        br_ov = []
        widx = jnp.arange(n_loc, dtype=jnp.int32)
        for j, dec in enumerate(decs):
            if branch_cap is None:
                oj, _, _ = dec._decode(
                    xw, ltf_start, cfo,
                    jnp.minimum(nv_all, branches[j][1]))
                bj = oj.astype(jnp.int32)
                if bj.shape[1] < n_bits_max:
                    bj = jnp.pad(bj,
                                 ((0, 0), (0, n_bits_max - bj.shape[1])))
                bits = jnp.where((bid == j)[:, None], bj, bits)
                br_ov.append(jnp.zeros((), bool))
            else:
                kj = min(branch_cap, n_loc)
                # stable gather: windows with bid==j first, in time order
                key = jnp.where(bid == j, widx, n_loc + widx)
                sel = jnp.argsort(key)[:kj]
                oj, _, _ = dec._decode(
                    xw[sel], ltf_start[sel], cfo[sel],
                    jnp.minimum(nv_all[sel], branches[j][1]))
                bj = oj.astype(jnp.int32)
                if bj.shape[1] < n_bits_max:
                    bj = jnp.pad(bj,
                                 ((0, 0), (0, n_bits_max - bj.shape[1])))
                mask = (bid[sel] == j)[:, None]
                # rows belong to <= 1 branch and start at zero -> add
                bits = bits.at[sel].add(jnp.where(mask, bj, 0))
                br_ov.append(jnp.sum(bid == j) > kj)
        sigb_ok_all = jnp.ones(n_loc, dtype=bool)
        for j, (_, data_fn) in enumerate(mu_fns):
            bj_id = n_br + j
            capj = mu_branches[j][1]
            nvm = jnp.clip(plan["mu_n_sym"], 1, capj)
            if branch_cap is None:
                oj, sb_ok = data_fn(ys, ltf_start, mu_nltf,
                                    plan["mu_nsts"], nvm, mu_crc)
                bj = oj.astype(jnp.int32)
                if bj.shape[1] < n_bits_max:
                    bj = jnp.pad(bj,
                                 ((0, 0), (0, n_bits_max - bj.shape[1])))
                sel_m = (bid == bj_id)
                bits = jnp.where(sel_m[:, None], bj, bits)
                sigb_ok_all = jnp.where(sel_m, sb_ok, sigb_ok_all)
                br_ov.append(jnp.zeros((), bool))
            else:
                kj = min(branch_cap, n_loc)
                key = jnp.where(bid == bj_id, widx, n_loc + widx)
                sel = jnp.argsort(key)[:kj]
                oj, sb_ok = data_fn(ys[sel], ltf_start[sel], mu_nltf[sel],
                                    plan["mu_nsts"][sel], nvm[sel],
                                    mu_crc[sel])
                bj = oj.astype(jnp.int32)
                if bj.shape[1] < n_bits_max:
                    bj = jnp.pad(bj,
                                 ((0, 0), (0, n_bits_max - bj.shape[1])))
                mask = (bid[sel] == bj_id)[:, None]
                bits = bits.at[sel].add(jnp.where(mask, bj, 0))
                sigb_ok_all = sigb_ok_all.at[sel].set(
                    jnp.where(bid[sel] == bj_id, sb_ok, sigb_ok_all[sel]))
                br_ov.append(jnp.sum(bid == bj_id) > kj)
        branch_overflow = jnp.stack(br_ov)[None, :].repeat(b, 0)
        mu_win = bid >= n_br
        ok = (bid >= 0) & sigb_ok_all

        # NDP LTF windows (cheap static-size slice, masked by the flag):
        # 2 VHT-LTF symbols per chain, CFO-corrected (decode_impl type-20)
        ndp_win = jax.vmap(lambda row, s: jax.lax.dynamic_slice(
            row, (0, s), (nrx, 160 * q)))(ys, ltf_start + OFF_NLLTF * q)
        ndp_ltf = jnp.stack([jnp.real(ndp_win), jnp.imag(ndp_win)],
                            axis=-1)             # [n_loc, nRx, 160q, 2]

        def regroup(a, dims):
            g = jax.lax.all_gather(a, "sp")
            g = g.reshape((n_sp, b, k_per_shard) + dims)
            return jnp.moveaxis(g, 0, 2).reshape(
                (b, n_sp * k_per_shard) + dims)

        # MU windows surface their own symbol count / data capacity
        n_sym_out = plan["n_sym"]
        psdu_out = plan["psdu_len"]
        if mu_branches:
            mu_ndbps = jnp.zeros(n_loc, jnp.int32)
            for j, (m, capj) in enumerate(mu_branches):
                mu_ndbps = jnp.where(bid == n_br + j, m.nDBPS, mu_ndbps)
            mu_psdu = (plan["mu_n_sym"] * mu_ndbps - 16 - 6) // 8
            n_sym_out = jnp.where(mu_win, plan["mu_n_sym"], n_sym_out)
            psdu_out = jnp.where(mu_win, jnp.maximum(mu_psdu, 0), psdu_out)

        return (regroup(bits, (n_bits_max,)), tg_all,
                regroup(ok, ()) & val_all, regroup(plan["fmt"], ()),
                regroup(plan["mcs"], ()), regroup(plan["nss"], ()),
                regroup(n_sym_out, ()), regroup(psdu_out, ()),
                regroup(plan["ampdu"], ()), regroup(mu_win, ()),
                regroup(plan["ndp"], ()) & val_all,
                regroup(ndp_ltf, (nrx, 160 * q, 2)), ov_all, branch_overflow)

    @partial(jax.jit, in_shardings=(cap_shard,))
    def run(capture):
        (bits, trig_t, ok, fmt, mcs, nss, n_sym, psdu_len, ampdu, mu,
         ndp, ndp_ltf, overflow, br_ov) = local(capture)
        return dict(bits=bits, trig_t=trig_t, ok=ok, fmt=fmt, mcs=mcs,
                    nss=nss, n_sym=n_sym, psdu_len=psdu_len, ampdu=ampdu,
                    mu=mu, ndp=ndp, ndp_ltf=ndp_ltf, overflow=overflow,
                    branch_overflow=br_ov)

    return run


def multichip_step(mesh, mod: Mod, n_sym: int):
    """The full multi-chip step: halo-sharded front-end + dp-sharded decode
    + collective reduction of per-packet outcomes (one XLA program)."""
    step = make_rx_step(mod, n_sym)
    n_sp = mesh.shape["sp"]
    cap_shard = NamedSharding(mesh, P("dp", "sp", None))
    win_shard = NamedSharding(mesh, P(("dp", "sp"), None, None))
    t_shard = NamedSharding(mesh, P(("dp", "sp")))

    @partial(jax.jit, in_shardings=(cap_shard, win_shard, t_shard))
    def run(capture, windows, t0):
        ac = sharded_frontend(mesh, capture)
        out = step(windows, t0)
        # global packet counter: the cross-shard reduction that replaces the
        # reference's per-process stdout counters (lib/decode_impl.cc:377)
        n_ok = jnp.sum(out["lsig_ok"].astype(jnp.int32))
        return dict(ac_peak=jnp.max(ac), n_ok=n_ok, bits=out["bits"],
                    cfo=out["cfo"])

    return run
