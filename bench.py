#!/usr/bin/env python
"""Benchmark: full RX decode throughput (VHT MCS7, 20 MHz) on one GPU.

Headline metric (BASELINE.md): PHY samples/sec through the complete
receive chain — sync, CFO, channel estimation, L-SIG decode, per-symbol
demod and soft Viterbi — on a batch of VHT MCS7 packets (500 B payload, the
reference perf_siso.py operating point). vs_baseline is relative to the
reference's implied real-time operating point of 20 Msps sustained
(USRP B200 @ 20 MHz, examples/rx.grc).

Usage: python bench.py [batch] [iters]. Stops with a non-zero exit when no
GPU is found or any phase fails. Prints ONE JSON line. The workload
builders below are shared with chip_smoke.py.
"""
import json
import sys
import time

import numpy as np

MAC_ADDRS = dict(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                 addr3="f4:69:d5:80:0f:a0", seq=2704)


def _qos_cfg():
    from ieee80211_phy.mac import MacConfig
    return MacConfig(subtype=8, **MAC_ADDRS)


def build_batch(batch: int):
    """Headline: `batch` copies of one VHT MCS7 A-MPDU (500 B payload)
    in RxPipeline windows. -> (pipe, x [B, W, 2], t0 [B], mpdu)."""
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.models import RxPipeline
    from ieee80211_phy.specs import F, Mod
    from ieee80211_phy.specs.modulation import ppdu_params_aggregate
    from ieee80211_phy.tx import finalize, gen_ampdu

    payload = bytes(np.random.default_rng(0).integers(0, 256, 500,
                                                      dtype=np.uint8))
    mpdu = build_udp_mpdu(payload, _qos_cfg())
    ampdu = aggregate_vht([mpdu])
    mod = Mod(F.VHT, 7)
    pp = ppdu_params_aggregate(mod, len(ampdu))
    wave = finalize(gen_ampdu(ampdu, mod).waveform, multiplier=0.2,
                    cfo_hz=15000.0, gap=True, gap_len=64)[0]
    from ieee80211_phy.utils import c2r
    pipe = RxPipeline(mod, pp.n_sym, pp.psdu_len)
    w = pipe.window_len()
    seg = wave[64 - 8:]
    x = np.zeros((batch, w), dtype=np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    t0 = np.zeros(batch, dtype=np.int32)
    return pipe, c2r(x), t0, mpdu


def build_wideband_batch(batch: int):
    """80 MHz VHT MCS9 row (beyond the reference envelope — its RX is
    20 MHz-only): 1800 B payload. -> (pipe, x, t0, mpdu)."""
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.models import RxPipeline
    from ieee80211_phy.specs import BW, F, Mod
    from ieee80211_phy.specs.modulation import ppdu_params_aggregate
    from ieee80211_phy.tx import finalize, gen_ampdu
    from ieee80211_phy.utils import c2r

    payload = bytes(np.random.default_rng(1).integers(0, 256, 1800,
                                                      dtype=np.uint8))
    mpdu = build_udp_mpdu(payload, _qos_cfg())
    ampdu = aggregate_vht([mpdu])
    mod = Mod(F.VHT, 9, BW.BW80, 1)
    pp = ppdu_params_aggregate(mod, len(ampdu))
    wave = finalize(gen_ampdu(ampdu, mod).waveform, multiplier=0.2,
                    cfo_hz=60000.0, gap=True, gap_len=256)[0]
    pipe = RxPipeline(mod, pp.n_sym, pp.psdu_len)
    w = pipe.window_len()
    seg = wave[(64 - 8) * 4:]
    x = np.zeros((batch, w), dtype=np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    return pipe, c2r(x), np.zeros(batch, np.int32), mpdu


def fcs_rows_ok(bits: np.ndarray, psdu_len: int, mpdu: bytes) -> int:
    """Rows of descrambled RxPipeline bits whose A-MPDU carries `mpdu`
    with a valid FCS."""
    from ieee80211_phy.mac import deaggregate_vht
    n_ok = 0
    for row in np.asarray(bits).astype(np.uint8):
        psdu = np.packbits(row[16:16 + psdu_len * 8],
                           bitorder="little").tobytes()
        subs = deaggregate_vht(psdu)
        n_ok += bool(subs and subs[0].fcs_ok and subs[0].mpdu == mpdu)
    return n_ok


def build_tx_l_mcs0(batch: int):
    """Batched TX generation (BASELINE config 1): L MCS0, 30 B UDP
    payload. -> (TxPipeline, psdus [B, len] uint8, mpdu)."""
    from ieee80211_phy.mac import MacConfig, build_udp_mpdu
    from ieee80211_phy.specs import F, Mod
    from ieee80211_phy.specs.modulation import ppdu_params_nonaggregate
    from ieee80211_phy.tx.jax_tx import TxPipeline
    mpdu = build_udp_mpdu(b"123456789012345678901234567890",
                          MacConfig(**MAC_ADDRS))
    mod = Mod(F.L, 0)
    txp = TxPipeline(mod, ppdu_params_nonaggregate(mod, len(mpdu)))
    return txp, np.tile(np.frombuffer(mpdu, np.uint8), (batch, 1)), mpdu


def build_mu_tx(batch: int):
    """VHT 2x2 MU-MIMO TX with a runtime spatial-mapping Q (BASELINE.md
    config 5; reference analog tools/cmu_v3/cmu_ap.py:204-212).
    -> (MuTxPipeline, (psdus0, psdus1), q [64, 2, 2] complex, ampdus, mods)."""
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.specs import BW, F, Mod
    from ieee80211_phy.tx.jax_tx import MuTxPipeline
    rng = np.random.default_rng(2)
    a0 = aggregate_vht([build_udp_mpdu(
        bytes(rng.integers(0, 256, 500, dtype=np.uint8)), _qos_cfg())])
    a1 = aggregate_vht([build_udp_mpdu(
        bytes(rng.integers(0, 256, 300, dtype=np.uint8)), _qos_cfg())])
    mods = [Mod(F.VHT, 4, BW.BW20, 1), Mod(F.VHT, 2, BW.BW20, 1)]
    mu = MuTxPipeline(mods, [len(a0), len(a1)])
    qm, _ = np.linalg.qr(rng.normal(size=(64, 2, 2))
                         + 1j * rng.normal(size=(64, 2, 2)))
    psdus = (np.tile(np.frombuffer(a0, np.uint8), (batch, 1)),
             np.tile(np.frombuffer(a1, np.uint8), (batch, 1)))
    return mu, psdus, qm.astype(np.complex64), (a0, a1), mods


def build_mu_sta(batch: int):
    """MU STA decode (BASELINE config 5's RX half): station 0 of a 2-user
    MU PPDU (reference tools/cmu_v3/cmu_ap.py:98-213 semantics). Identity
    BFQ geometry: the per-tone P-column combining, joint pilot tracking
    and own-stream ZF cost the same as through any channel.
    -> (MuStaDecoder, x [B, W, 2], t0, psdu_len, window)."""
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.mu.sounding import MuStaDecoder
    from ieee80211_phy.specs import BW, F, Mod
    from ieee80211_phy.specs.modulation import ppdu_params_aggregate
    from ieee80211_phy.tx import finalize, gen_ampdu_mu
    from ieee80211_phy.utils import c2r
    rng = np.random.default_rng(4)
    amps = [aggregate_vht([build_udp_mpdu(
        bytes(rng.integers(0, 256, 500, dtype=np.uint8)), _qos_cfg())])
        for _ in range(2)]
    mods = [Mod(F.VHT, 4, BW.BW20, 1)] * 2
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    tx = gen_ampdu_mu(amps, mods, bfq=qi, group_id=2)
    pps = [ppdu_params_aggregate(m, len(a)) for m, a in zip(mods, amps)]
    n_sym = max(p.n_sym for p in pps)
    wave = finalize(tx.waveform, multiplier=0.2, cfo_hz=-9000.0,
                    gap=True, gap_len=64)
    dec = MuStaDecoder(mods[0], n_sym, pps[0].psdu_len, 0)
    w = 192 + 448 + 160 + 80 + 80 * n_sym + 80
    x = np.zeros(w, np.complex64)
    seg = wave[0, 64 - 8:]
    x[:min(w, len(seg))] = seg[:min(w, len(seg))]
    x2 = np.tile(c2r(x)[None], (batch, 1, 1))
    return dec, x2, np.zeros(batch, np.int32), pps[0].psdu_len, w


def build_api_capture(n_api: int = 20):
    """One capture of `n_api` mixed VHT MCS7 / HT MCS5 packets with
    100-900 B payloads and per-packet CFO. -> complex64 [N]."""
    from ieee80211_phy.mac import MacConfig, aggregate_vht, build_udp_mpdu
    from ieee80211_phy.specs import F, Mod
    from ieee80211_phy.tx import finalize, gen_ampdu, gen_mpdu
    rng = np.random.default_rng(3)
    parts = []
    for i in range(n_api):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 900)),
                                dtype=np.uint8))
        if i % 2:
            wv = gen_ampdu(aggregate_vht([build_udp_mpdu(pl, _qos_cfg())]),
                           Mod(F.VHT, 7)).waveform
        else:
            wv = gen_mpdu(build_udp_mpdu(pl, MacConfig(
                addr1=MAC_ADDRS["addr1"], addr2=MAC_ADDRS["addr2"],
                addr3=MAC_ADDRS["addr3"])), Mod(F.HT, 5)).waveform
        parts.append(finalize(wv, multiplier=0.2, cfo_hz=float(
            rng.uniform(-5e4, 5e4)), gap=True, gap_len=800)[0])
    return np.concatenate(parts)


def build_stream(cap: np.ndarray, n_copy: int = 50, n_stream: int = 6):
    """Sustained SISO stream: `n_stream` captures of `n_copy` copies of
    `cap` (about 4M samples and 1000 packets each with the default
    capture). -> list of complex64 [N]."""
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(n_copy):
        parts.append(np.zeros(int(rng.integers(16, 512)), np.complex64))
        parts.append(cap)
    big = np.concatenate(parts)
    return [np.concatenate([np.zeros(64 + 32 * k, np.complex64), big])
            for k in range(n_stream)]


def build_mimo_stream(reps: int = 120, n_stream: int = 6):
    """Dual-chain stream (the rx2.grc analog): mixed SISO(MRC) VHT MCS7 and
    2x2 VHT MCS4 packets on two RX chains, `n_stream` captures of about
    5.3M samples. -> (list of complex64 [2, N], packets per capture)."""
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.specs import BW, F, Mod
    from ieee80211_phy.tx import finalize, gen_ampdu
    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j], [-0.4 + 0.6j, 0.9 + 0.1j]])
    rng = np.random.default_rng(15)
    parts = []
    for i in range(12):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 700)),
                                dtype=np.uint8))
        amp = aggregate_vht([build_udp_mpdu(pl, _qos_cfg())])
        cfo = float(rng.uniform(-4e4, 4e4))
        if i % 2:
            wv = finalize(gen_ampdu(amp, Mod(F.VHT, 4, BW.BW20, 2)).waveform,
                          multiplier=0.2, cfo_hz=cfo, gap=False)
            w2 = h22 @ wv
        else:
            wv = finalize(gen_ampdu(amp, Mod(F.VHT, 7)).waveform,
                          multiplier=0.2, cfo_hz=cfo, gap=False)[0]
            w2 = np.stack([h1[0] * wv, h1[1] * wv])
        parts.append(np.zeros((2, 800), np.complex64))
        parts.append(w2.astype(np.complex64))
    big = np.concatenate([np.concatenate(parts, axis=1)] * reps, axis=1)
    caps = [np.concatenate([np.zeros((2, 64 + 32 * k), np.complex64), big],
                           axis=1) for k in range(n_stream)]
    return caps, 12 * reps


def build_mu_stream(reps: int = 60, n_stream: int = 4):
    """Downlink MU through the public streaming API: SU VHT MCS7 and
    2-user MU packets that station 0 (group 2) hears on chain 0.
    -> (list of complex64 [N], MU packets per capture, SU per capture)."""
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.specs import BW, F, Mod
    from ieee80211_phy.tx import finalize, gen_ampdu, gen_ampdu_mu
    rng = np.random.default_rng(21)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    parts = []
    for i in range(10):
        a0 = aggregate_vht([build_udp_mpdu(
            bytes(rng.integers(0, 256, 400, dtype=np.uint8)), _qos_cfg())])
        a1 = aggregate_vht([build_udp_mpdu(
            bytes(rng.integers(0, 256, 300, dtype=np.uint8)), _qos_cfg())])
        cfo = float(rng.uniform(-3e4, 3e4))
        if i % 2:
            mu = gen_ampdu_mu([a0, a1], [Mod(F.VHT, 4, BW.BW20, 1),
                                         Mod(F.VHT, 2, BW.BW20, 1)],
                              bfq=qi, group_id=2)
            wv = finalize(mu.waveform, multiplier=0.2, cfo_hz=cfo,
                          gap=False)[0]
        else:
            wv = finalize(gen_ampdu(a0, Mod(F.VHT, 7)).waveform,
                          multiplier=0.2, cfo_hz=cfo, gap=False)[0]
        parts.append(np.zeros(800, np.complex64))
        parts.append(wv.astype(np.complex64))
    big = np.concatenate([np.concatenate(parts)] * reps)
    caps = [np.concatenate([np.zeros(64 + 32 * k, np.complex64), big])
            for k in range(n_stream)]
    return caps, 5 * reps, 5 * reps


def main():
    import jax
    import jax.numpy as jnp

    from ieee80211_phy.utils import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    gpu = runtime.gpu_name_and_power_limit()
    T0 = time.perf_counter()

    def mark(tag):
        print(f"[bench +{time.perf_counter() - T0:.0f}s] {tag}",
              file=sys.stderr, flush=True)

    mark(gpu)
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    mark("headline rx")
    pipe, x, t0, mpdu = build_batch(batch)
    xd = jnp.asarray(x)
    td = jnp.asarray(t0)

    out = pipe.step(xd, td)
    n_ok = fcs_rows_ok(out["bits"], pipe.psdu_len, mpdu)
    assert n_ok == batch, f"decode invalid: {n_ok}/{batch} rows FCS-ok"

    # Timing: the step runs K times inside ONE program with a forced data
    # dependency (an invisible 1e-30 input perturbation defeats
    # CSE/hoisting), a scalar result is fetched, and the measured dispatch
    # round trip of a trivial program is subtracted.
    K = 8
    step = pipe.step

    def k_loop(fn, k):
        @jax.jit
        def run(x, t):
            def body(i, c):
                s, xx = c
                s2 = fn(xx, t)
                return (s + s2, xx + s2 * jnp.float32(1e-30))
            s, _ = jax.lax.fori_loop(0, k, body, (jnp.float32(0.0), x))
            return s
        return run

    step_k = k_loop(lambda x, t: jnp.sum(
        step(x, t)["bits"][:, :8]).astype(jnp.float32), K)

    @jax.jit
    def trivial(x):
        return jnp.sum(x[:, 0, 0]) * 0 + 1.0

    np.asarray(trivial(xd))
    rts = []
    for _ in range(8):
        t = time.perf_counter()
        np.asarray(trivial(xd))
        rts.append(time.perf_counter() - t)
    rt = min(rts)

    np.asarray(step_k(xd, td))   # compile + warm
    dts = []
    for _ in range(iters):
        t = time.perf_counter()
        np.asarray(step_k(xd, td))
        dts.append(time.perf_counter() - t)
    dt = max((np.median(dts) - rt) / K, 1e-9)

    samples = batch * x.shape[1]
    sps = samples / dt
    iters = len(dts)

    mark("tx gen")
    txp, psdus, _ = build_tx_l_mcs0(batch)
    pin = jnp.asarray(psdus)
    # tiny per-step compute: a long chain keeps the loop time well above
    # the dispatch jitter
    K_TX = 96

    @jax.jit
    def tx_k(p):
        def body(i, c):
            s, pp_ = c
            s2 = jnp.sum(txp._tx(pp_)[:, 0, 0, :])
            # runtime-zero XOR defeats loop hoisting on int inputs
            return (s + s2, pp_ ^ (s2 * 1e-30).astype(jnp.uint8))
        s, _ = jax.lax.fori_loop(0, K_TX, body, (jnp.float32(0.0), p))
        return s

    np.asarray(tx_k(pin))
    tts = []
    for _ in range(5):
        t = time.perf_counter()
        np.asarray(tx_k(pin))
        tts.append(time.perf_counter() - t)
    tx_sps = batch * txp.n_samp / max((np.median(tts) - rt) / K_TX, 1e-6)

    mark("wideband rx")
    wb_batch = max(batch // 4, 1)
    wpipe, wx, wt0, wmpdu = build_wideband_batch(wb_batch)
    wxd, wtd = jnp.asarray(wx), jnp.asarray(wt0)
    n_ok = fcs_rows_ok(wpipe.step(wxd, wtd)["bits"], wpipe.psdu_len, wmpdu)
    assert n_ok == wb_batch, f"80 MHz decode invalid: {n_ok}/{wb_batch}"
    wb_k = k_loop(lambda x, t: jnp.sum(
        wpipe.step(x, t)["bits"][:, :8]).astype(jnp.float32), K)
    np.asarray(wb_k(wxd, wtd))
    wts = []
    for _ in range(5):
        t = time.perf_counter()
        np.asarray(wb_k(wxd, wtd))
        wts.append(time.perf_counter() - t)
    wb_sps = wb_batch * wx.shape[1] / max((np.median(wts) - rt) / K, 1e-9)

    mark("mu tx")
    mu_batch = max(batch // 8, 256)
    mu, (p0, p1), qm, _, _ = build_mu_tx(mu_batch)
    from ieee80211_phy.utils import c2r
    p0, p1, qd = jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(c2r(qm))
    K_MU = 256

    @jax.jit
    def mu_k(pa, pb, q):
        def body(i, c):
            s, qq = c
            s2 = jnp.sum(mu.step((pa, pb), qq)[:, 0, 0, :])
            return (s + s2, qq + s2 * jnp.float32(1e-30))
        s, _ = jax.lax.fori_loop(0, K_MU, body, (jnp.float32(0.0), q))
        return s

    np.asarray(mu_k(p0, p1, qd))
    mts = []
    for _ in range(5):
        t = time.perf_counter()
        np.asarray(mu_k(p0, p1, qd))
        mts.append(time.perf_counter() - t)
    # total emitted samples across both TX chains
    mu_sps = mu_batch * 2 * mu.n_samp / max(
        (np.median(mts) - rt) / K_MU, 1e-6)

    mark("mu sta rx")
    from ieee80211_phy.mac import deaggregate_vht
    from ieee80211_phy.ops import sync
    sta_batch = max(batch // 4, 1)
    dec4, x4, t4, psdu_len4, w4 = build_mu_sta(sta_batch)
    x4d, t4d = jnp.asarray(x4), jnp.asarray(t4)
    ls0, cf0, _ = sync.sync_front_iq(x4d[:1], t4d[:1])
    bits0 = dec4.decode(x4d[:1], ls0, cf0)
    psdu0 = np.packbits(np.asarray(bits0)[0, 16:16 + psdu_len4 * 8],
                        bitorder="little").tobytes()
    subs4 = deaggregate_vht(psdu0)
    assert subs4 and subs4[0].fcs_ok, "MU STA decode invalid"

    def sta_step(x, t):
        ls, cf, _ = sync.sync_front_iq(x, t)
        return jnp.sum(dec4._decode(x, ls, cf)[:, :8]).astype(jnp.float32)

    sta_k = k_loop(sta_step, K)
    np.asarray(sta_k(x4d, t4d))
    sts4 = []
    for _ in range(5):
        t = time.perf_counter()
        np.asarray(sta_k(x4d, t4d))
        sts4.append(time.perf_counter() - t)
    mu_rx_sps = sta_batch * w4 / max((np.median(sts4) - rt) / K, 1e-6)

    # the PUBLIC API path — SisoReceiver.decode_capture on a multi-packet
    # mixed-length capture (host loop + per-packet fetches)
    mark("api decode_capture")
    from ieee80211_phy.rx import SisoReceiver
    n_api = 20
    cap = build_api_capture(n_api)
    rxr = SisoReceiver()
    res = rxr.decode_capture(cap)          # warm (compiles buckets)
    ok = sum(1 for r in res if r.fcs_ok)
    assert ok == n_api, f"API decode only {ok}/{n_api}"
    t = time.perf_counter()
    res = rxr.decode_capture(cap)
    dt_api = time.perf_counter() - t
    api_pps = len(res) / dt_api
    api_msps = len(cap) / dt_api

    # SUSTAINED public-API throughput — a stream of six ~4M-sample
    # captures (1000 mixed HT/VHT packets each) through the pipelined
    # SisoReceiver.decode_captures: the analog of the reference's 20 Msps
    # continuous operating point (examples/rx.grc), with per-packet format
    # auto-detection end to end
    mark("api stream")
    n_copy = 50
    caps = build_stream(cap, n_copy)
    total_samp = sum(len(c) for c in caps)

    def run_stream(rxs):
        stream = rxs.decode_captures(caps)     # warm
        for res_k in stream:
            okk = sum(1 for r in res_k if r.fcs_ok)
            assert okk == n_api * n_copy, \
                f"stream decode only {okk}/{n_api * n_copy}"
        # best-of-3: a background burst on the shared host can stretch a
        # run; every run decodes the full 6000 packets (FCS gate above)
        dts = []
        for _ in range(3):
            t = time.perf_counter()
            stream = rxs.decode_captures(caps)
            dts.append(time.perf_counter() - t)
        n_pk = sum(len(r) for r in stream)
        return total_samp / float(np.min(dts)), n_pk / float(np.min(dts))

    # A/B: host-side native trigger scan vs the in-graph device scan
    api_stream_host, pps_h = run_stream(SisoReceiver())
    api_stream_dev, pps_d = run_stream(SisoReceiver(trigger="device"))
    if api_stream_dev >= api_stream_host:
        api_stream_sps, api_stream_pps = api_stream_dev, pps_d
    else:
        api_stream_sps, api_stream_pps = api_stream_host, pps_h

    # DUAL-CHAIN sustained stream through MimoReceiver.decode_captures,
    # A/B'd across the detector modes: "auto" = ZF with a one-shot
    # exact-ML retry on FCS failure
    mark("api stream mimo")
    from ieee80211_phy.rx.mimo import MimoReceiver
    caps2, want2 = build_mimo_stream()
    total2 = sum(c.shape[1] for c in caps2)
    mimo_det = {}
    rxs2 = {d: MimoReceiver(detector=d) for d in ("auto", "zf", "ml")}
    for d, rxm in rxs2.items():            # warm + FCS gate
        for res_k in rxm.decode_captures(caps2):
            okk = sum(1 for r in res_k if r.fcs_ok)
            assert okk == want2, \
                f"mimo stream ({d}) decode only {okk}/{want2}"
    for _ in range(3):                     # alternating best-of-3
        for d, rxm in rxs2.items():
            t = time.perf_counter()
            rxm.decode_captures(caps2)
            dt2 = time.perf_counter() - t
            mimo_det[d] = max(mimo_det.get(d, 0.0), total2 / dt2)
    api_stream_mimo_sps = mimo_det["auto"]

    # downlink MU through the PUBLIC streaming API — mixed SU+MU captures
    # through SisoReceiver(mu_gid).decode_captures (batched MU-STA lanes)
    mark("api stream mu")
    caps6, want_mu, want_su = build_mu_stream()
    rx6 = SisoReceiver(mu_pos=0, mu_gid=2)
    for res_k in rx6.decode_captures(caps6):   # warm + FCS gate
        n_mu_ok = sum(1 for r in res_k if r.mu and r.fcs_ok)
        n_su_ok = sum(1 for r in res_k if not r.mu and r.fcs_ok)
        assert n_mu_ok == want_mu and n_su_ok == want_su, \
            f"mu stream decode {n_mu_ok}/{want_mu} mu, {n_su_ok} su"
    dts6 = []
    for _ in range(3):
        t = time.perf_counter()
        rx6.decode_captures(caps6)
        dts6.append(time.perf_counter() - t)
    api_mu_sps = sum(len(c) for c in caps6) / float(np.min(dts6))

    mark("done")
    baseline_sps = 20e6   # reference real-time operating point: 20 Msps
    print(json.dumps({
        "metric": "rx_decode_samples_per_sec_per_chip_vht_mcs7_20mhz",
        "value": round(sps),
        "unit": "samples/s",
        "vs_baseline": round(sps / baseline_sps, 3),
        "device": runtime.device_info(),
        "extra": {
            "gpu": gpu,
            "batch": batch,
            "window": int(x.shape[1]),
            "iters": iters,
            "packets_per_sec": round(batch / dt),
            "tx_gen_samples_per_sec_l_mcs0": round(tx_sps),
            "rx_decode_sps_vht80_mcs9": round(wb_sps),
            "mu_tx_samples_per_sec_2user_2x2": round(mu_sps),
            "mu_sta_decode_samples_per_sec": round(mu_rx_sps),
            # one-shot LATENCY metric (a single small capture end to end,
            # every round trip serial) — NOT comparable to the pipelined
            # api_stream_* throughput rows
            "api_decode_capture_packets_per_sec": round(api_pps, 1),
            "api_decode_capture_samples_per_sec": round(api_msps),
            "api_stream_packets_per_sec": round(api_stream_pps),
            "api_stream_samples_per_sec": round(api_stream_sps),
            "api_stream_sps_host_trigger": round(api_stream_host),
            "api_stream_sps_device_trigger": round(api_stream_dev),
            "api_stream_mimo_samples_per_sec": round(api_stream_mimo_sps),
            "api_stream_mimo_sps_by_detector": {
                k: round(v) for k, v in mimo_det.items()},
            "api_stream_mu_samples_per_sec": round(api_mu_sps),
        },
    }))


if __name__ == "__main__":
    main()
