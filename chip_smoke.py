#!/usr/bin/env python
"""Smoke check of the RX/TX main path on one GPU, at the sizes users run.

    python chip_smoke.py               # every phase, one card
    python chip_smoke.py --four-cards  # only the 4-card mesh dry run,
                                       # compared with one card

Everything runs in this one process: the Viterbi kernel against the XLA
reference at real widths, the window slice, the fixed-config RxPipeline
(batch 1024 VHT MCS7 and batch 256 80 MHz VHT MCS9, every row FCS-gated),
the precision check at 256-QAM, TX against the golden model, the three
streaming cells through decode_captures, and capture files through
PhyService. Each phase prints one line; a failing phase raises, so the
exit code is non-zero and no result line is printed. The last line is
{"ok": true, "device": {"platform", "kind", "count"}}. Without a GPU the
script stops at the device phase.
"""
import json
import os
import sys
import tempfile
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# LLR noise (std, for +-1 coded bits) at which the XLA reference decodes
# every width below exactly: the Viterbi checks compare with the true bits
SIGMA = 0.2
# TX vs golden numpy model, max |sample error|: FFT summation order differs
# from numpy's (the CPU tests hold 2e-6)
TX_ATOL = 2e-5
# RxPipeline LLRs at default matmul precision vs "highest", max |diff| over
# max |LLR|: float32 products may run in TF32 (about 3 decimal digits)
LLR_RTOL = 5e-2
# timed decode_captures runs per stream: the streams are host-bound, and
# their rate varies from run to run more than a device time does
STREAM_RUNS = 3


def report(name, **fields):
    print(f"[{name}] {json.dumps(fields, default=float)}", flush=True)


def timed(fn, *args, n=5):
    """-> (output, first-call seconds incl. compile, median of n more)."""
    import jax
    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return out, first, float(np.median(ts))


class Phase:
    """Prints a phase's wall time and persistent-cache hits/misses."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from ieee80211_phy.utils import runtime
        self.t = time.perf_counter()
        self.c0 = runtime.cache_stats()
        return self

    def __exit__(self, exc_type, *_):
        from ieee80211_phy.utils import runtime
        c1 = runtime.cache_stats()
        if exc_type is None:
            report(self.name + " done",
                   wall_s=time.perf_counter() - self.t,
                   cache_hits=c1["hits"] - self.c0["hits"],
                   cache_misses=c1["misses"] - self.c0["misses"])
        return False


def phase_device(want_count=1):
    import jax
    import jaxlib
    from ieee80211_phy import native
    from ieee80211_phy.utils import runtime
    devs = runtime.require_gpu()
    if len(devs) < want_count:
        raise RuntimeError(f"need {want_count} GPUs, found {len(devs)}")
    cache = runtime.enable_compile_cache()
    print(runtime.gpu_name_and_power_limit(), flush=True)
    # the host runtime (trigger scan, ingest) is built with g++ at first
    # use; without it the streams fall back to numpy and slow down
    report("device", **runtime.device_info(), jax=jax.__version__,
           jaxlib=jaxlib.__version__, compile_cache=cache,
           native_host_runtime=native.available())


def viterbi_case(b, n_bits, cr, seed):
    """Random zero-terminated BCC streams -> (true bits, depunctured LLR
    pairs [B, n_bits, 2] on the device)."""
    import jax.numpy as jnp
    from ieee80211_phy.ops import coding
    from ieee80211_phy.tx.golden import bcc
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(b, n_bits)).astype(np.int32)
    bits[:, -6:] = 0
    coded = np.stack([bcc(row, cr) for row in bits])
    llr = (coded * 2.0 - 1.0) + rng.normal(0, SIGMA, coded.shape)
    return bits, coding.depuncture(jnp.asarray(llr, jnp.float32), cr, n_bits)


def phase_viterbi(widths=None):
    import jax
    from ieee80211_phy.ops import coding
    from ieee80211_phy.ops.pallas.viterbi import viterbi_decode_pallas
    from ieee80211_phy.specs import CR
    widths = widths or [("lsig", 1024, 24, CR.CR12),
                        ("vht20_mcs7", 1024, 4680, CR.CR56),
                        ("vht20_cr34", 1024, 4680, CR.CR34),
                        ("vht80_mcs9", 256, 15600, CR.CR56),
                        ("trellis_limit", 64, 32782, CR.CR12)]
    for i, (name, b, n, cr) in enumerate(widths):
        bits, lp = viterbi_case(b, n, cr, seed=i)
        kern = jax.jit(partial(viterbi_decode_pallas, n_bits=n))
        xla = jax.jit(partial(coding.viterbi_decode_xla, n_bits=n))
        kb, k_first, k_med = timed(kern, lp, n=10)
        xb, x_first, x_med = timed(xla, lp, n=3)
        k_err = int(np.sum(np.asarray(kb) != bits))
        x_err = int(np.sum(np.asarray(xb) != bits))
        report("viterbi", width=name, batch=b, n_bits=n, cr=cr.name,
               kernel_bit_errors=k_err, xla_bit_errors=x_err,
               kernel_first_s=k_first, kernel_median_s=k_med,
               xla_first_s=x_first, xla_median_s=x_med,
               xla_radix=coding.XLA_RADIX)
        if k_err or x_err:
            raise AssertionError(f"viterbi {name}: kernel {k_err}, "
                                 f"xla {x_err} bit errors")


def phase_slice(b=1024, n=2320, length=2080):
    import jax
    import jax.numpy as jnp
    from ieee80211_phy.ops import sync
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, n, 2)).astype(np.float32)
    st = rng.integers(0, n - length + 1, b).astype(np.int32)
    st[:2] = (0, n - length)
    f = jax.jit(partial(sync.batch_slice_iq, length=length))
    out, first, med = timed(f, jnp.asarray(x), jnp.asarray(st), n=20)
    want = np.stack([x[r, s:s + length] for r, s in enumerate(st)])
    if not np.array_equal(np.asarray(out), want):
        raise AssertionError("batch_slice_iq differs from numpy slicing")
    report("window_slice", batch=b, n=n, length=length, first_s=first,
           median_s=med, bytes_copied=out.size * 4)


def _spy_llrs(step_fn, n_bits):
    """Wrap an RxPipeline step so it also returns the DATA LLRs handed to
    the Viterbi decoder (captured while tracing)."""
    from unittest import mock

    from ieee80211_phy.ops import coding
    orig = coding.viterbi_decode

    def run(x, t):
        seen = {}

        def spy(llrs, cr, nb):
            seen[nb] = llrs
            return orig(llrs, cr, nb)
        with mock.patch.object(coding, "viterbi_decode", spy):
            out = step_fn(x, t)
        return out["bits"], seen[n_bits]
    return run


def phase_rx(batch=1024, wb_batch=256):
    import jax
    import jax.numpy as jnp
    from unittest import mock

    import bench
    from ieee80211_phy.models.pipeline import make_rx_step
    from ieee80211_phy.ops import coding
    pipe, x, t0, mpdu = bench.build_batch(batch)
    xd, td = jnp.asarray(x), jnp.asarray(t0)
    t = time.perf_counter()
    compiled = pipe.step.lower(xd, td).compile()
    compile_s = time.perf_counter() - t
    ma = compiled.memory_analysis()
    out, first, med = timed(compiled, xd, td, n=10)
    n_ok = bench.fcs_rows_ok(out["bits"], pipe.psdu_len, mpdu)
    stats = jax.devices()[0].memory_stats() or {}
    report("rx_pipeline", cell="vht20_mcs7", batch=batch,
           window=x.shape[1], fcs_ok=n_ok, compile_s=compile_s,
           first_s=first, median_s=med,
           msps=batch * x.shape[1] / med / 1e6,
           temp_bytes=getattr(ma, "temp_size_in_bytes", None),
           argument_bytes=getattr(ma, "argument_size_in_bytes", None),
           output_bytes=getattr(ma, "output_size_in_bytes", None),
           peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    if n_ok != batch:
        raise AssertionError(f"rx_pipeline: {n_ok}/{batch} rows FCS-ok")

    # the same step with the XLA Viterbi: does the kernel win end to end?
    with mock.patch.object(coding, "viterbi_decode_pairs",
                           coding.viterbi_decode_xla):
        xla_step = jax.jit(make_rx_step(pipe.mod, pipe.n_sym))
        xout, x_first, x_med = timed(xla_step, xd, td, n=5)
    n_ok = bench.fcs_rows_ok(xout["bits"], pipe.psdu_len, mpdu)
    report("rx_pipeline_xla_viterbi", batch=batch, fcs_ok=n_ok,
           first_s=x_first, median_s=x_med, kernel_median_s=med)
    if n_ok != batch:
        raise AssertionError(f"rx_pipeline xla: {n_ok}/{batch} FCS-ok")

    wpipe, wx, wt0, wmpdu = bench.build_wideband_batch(wb_batch)
    wxd, wtd = jnp.asarray(wx), jnp.asarray(wt0)
    wout, first, med = timed(wpipe.step, wxd, wtd, n=10)
    n_ok = bench.fcs_rows_ok(wout["bits"], wpipe.psdu_len, wmpdu)
    report("rx_pipeline", cell="vht80_mcs9", batch=wb_batch,
           window=wx.shape[1], fcs_ok=n_ok, first_s=first, median_s=med,
           msps=wb_batch * wx.shape[1] / med / 1e6)
    if n_ok != wb_batch:
        raise AssertionError(f"vht80 mcs9: {n_ok}/{wb_batch} rows FCS-ok")

    # precision: 256-QAM LLRs at the default matmul precision (TF32 on
    # this card) against "highest"; decoded bits must be identical
    n_bits = wpipe.n_sym * wpipe.mod.nDBPS
    spy = _spy_llrs(make_rx_step(wpipe.mod, wpipe.n_sym), n_bits)
    bits_d, llr_d = jax.jit(spy)(wxd, wtd)
    with jax.default_matmul_precision("highest"):
        bits_h, llr_h = jax.jit(spy)(wxd, wtd)
    llr_d, llr_h = np.asarray(llr_d), np.asarray(llr_h)
    rel = float(np.max(np.abs(llr_d - llr_h)) / np.max(np.abs(llr_h)))
    same = bool(np.array_equal(np.asarray(bits_d), np.asarray(bits_h)))
    report("precision", cell="vht80_mcs9", llr_max_rel_diff=rel,
           tolerance=LLR_RTOL, bits_identical=same)
    if not same or rel > LLR_RTOL:
        raise AssertionError("precision check failed")


def phase_crc(b=1024):
    """The int32 @ int32 CRC-8 parity product compiles and runs."""
    import jax
    import jax.numpy as jnp
    from ieee80211_phy.rx import receiver
    mat, const = receiver._crc8_matrix()
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (b, 48)).astype(np.int32)
    bits[::2, 34:42] = (bits[::2, :34] @ mat + const) % 2
    want = np.all((bits[:, :34] @ mat + const) % 2 == bits[:, 34:42], -1)
    got = np.asarray(jax.jit(receiver._crc8_ok)(jnp.asarray(bits)))
    report("crc8_int32_matmul", batch=b, agree=bool(np.array_equal(got, want)),
           n_valid=int(got.sum()))
    if not np.array_equal(got, want):
        raise AssertionError("CRC-8 parity product differs from numpy")


def phase_tx(batch=1024, mu_batch=256):
    import jax.numpy as jnp

    import bench
    from ieee80211_phy.specs import F, Mod
    from ieee80211_phy.tx import gen_mpdu
    from ieee80211_phy.tx.golden import gen_ampdu_mu
    from ieee80211_phy.utils import c2r
    txp, psdus, mpdu = bench.build_tx_l_mcs0(batch)
    out, first, med = timed(txp.step, jnp.asarray(psdus))
    want = gen_mpdu(mpdu, Mod(F.L, 0)).waveform
    got = np.asarray(out)
    err = float(np.max(np.abs(got[..., 0] + 1j * got[..., 1] - want[None])))
    report("tx", cell="l_mcs0", batch=batch, max_abs_err=err,
           tolerance=TX_ATOL, first_s=first, median_s=med)
    if err > TX_ATOL:
        raise AssertionError(f"TxPipeline differs from golden by {err}")

    mu, (p0, p1), q, ampdus, mods = bench.build_mu_tx(mu_batch)
    out, first, med = timed(mu.step, (jnp.asarray(p0), jnp.asarray(p1)),
                            jnp.asarray(c2r(q)))
    want = gen_ampdu_mu(list(ampdus), mods, q).waveform
    got = np.asarray(out)
    err = float(np.max(np.abs(got[..., 0] + 1j * got[..., 1] - want[None])))
    report("tx", cell="mu_2user", batch=mu_batch, max_abs_err=err,
           tolerance=TX_ATOL, first_s=first, median_s=med)
    if err > TX_ATOL:
        raise AssertionError(f"MuTxPipeline differs from golden by {err}")


def _stream(name, rx, caps, check):
    """Warm (compiles) + gated run, then STREAM_RUNS timed runs of
    decode_captures: the rate of each, and of their median."""
    t = time.perf_counter()
    results = rx.decode_captures(caps)
    first = time.perf_counter() - t
    counts = [check(res) for res in results]
    ts = []
    for _ in range(STREAM_RUNS):
        t = time.perf_counter()
        rx.decode_captures(caps)
        ts.append(time.perf_counter() - t)
    total = sum(c.shape[-1] for c in caps)
    report("stream", cell=name, captures=len(caps), samples=total,
           fcs_ok_per_capture=counts, first_s=first, timed_s=ts,
           msps=total / float(np.median(ts)) / 1e6,
           msps_each=[total / dt / 1e6 for dt in ts])
    return counts


def phase_streams(n_copy=50, n_stream=6, mimo_reps=120, mu_reps=60):
    from ieee80211_phy.rx import SisoReceiver
    from ieee80211_phy.rx.mimo import MimoReceiver

    import bench
    n_api = 20
    cap = bench.build_api_capture(n_api)
    rx = SisoReceiver()
    t = time.perf_counter()
    res = rx.decode_capture(cap)
    n_ok = sum(r.fcs_ok for r in res)
    report("decode_capture", packets=n_api, fcs_ok=n_ok,
           first_s=time.perf_counter() - t)
    if n_ok != n_api:
        raise AssertionError(f"decode_capture: {n_ok}/{n_api} FCS-ok")

    def fcs(res):
        return sum(r.fcs_ok for r in res)

    caps = bench.build_stream(cap, n_copy, n_stream)
    for trig in ("host", "device"):
        counts = _stream(f"siso_{trig}_trigger", SisoReceiver(trigger=trig),
                         caps, fcs)
        if counts != [n_api * n_copy] * n_stream:
            raise AssertionError(f"siso {trig} stream: {counts}")

    caps2, want2 = bench.build_mimo_stream(mimo_reps, n_stream)
    counts = _stream("dual_chain", MimoReceiver(), caps2, fcs)
    if counts != [want2] * n_stream:
        raise AssertionError(f"dual-chain stream: {counts} != {want2}")

    caps6, want_mu, want_su = bench.build_mu_stream(mu_reps)
    counts = _stream("mu_sta", SisoReceiver(mu_pos=0, mu_gid=2), caps6,
                     lambda res: (sum(r.fcs_ok and r.mu for r in res),
                                  sum(r.fcs_ok and not r.mu for r in res)))
    if counts != [(want_mu, want_su)] * len(caps6):
        raise AssertionError(f"mu stream: {counts}")


def phase_files():
    """Captures written as examples/gen_test_captures.py writes them,
    decoded back, then a few requests through PhyService in-process."""
    import importlib.util

    from ieee80211_phy.api import PhyService
    from ieee80211_phy.api import descriptors as d
    from ieee80211_phy.mac import aggregate_vht, build_udp_mpdu
    from ieee80211_phy.rx import SisoReceiver
    from ieee80211_phy.rx.mimo import MimoReceiver
    from ieee80211_phy.specs import F, Mod
    from ieee80211_phy.utils import load_complex_bin
    spec = importlib.util.spec_from_file_location(
        "gen_test_captures",
        os.path.join(ROOT, "examples", "gen_test_captures.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with tempfile.TemporaryDirectory() as tmp:
        gen.main(tmp)

        def load(name):
            return load_complex_bin(os.path.join(tmp, name))
        decoded = {
            "siso": SisoReceiver().decode_capture(
                load("sig80211GenMultipleSiso_1x1_0.bin")),
            "beacon": SisoReceiver().decode_capture(
                load("sig80211GenBeacon_1x1_0.bin")),
            "wide40": SisoReceiver(sample_rate_hz=40e6).decode_capture(
                load("sig80211GenWideband_40MHz.bin")),
            "wide80": SisoReceiver(sample_rate_hz=80e6).decode_capture(
                load("sig80211GenWideband_80MHz.bin")),
            "mimo2x2": MimoReceiver().decode_capture(np.stack([
                load(f"sig80211GenMultipleMimo_2x2_{i}.bin")
                for i in range(2)])),
        }
    want = {"siso": 3, "beacon": 1, "wide40": 1, "wide80": 1, "mimo2x2": 1}
    got = {k: sum(r.fcs_ok for r in v) for k, v in decoded.items()}
    report("capture_files", fcs_ok=got, want=want)
    if got != want:
        raise AssertionError(f"capture files: {got} != {want}")

    mpdu = build_udp_mpdu(b"phy service smoke payload", gen.CFG)
    reqs = [d.pack_data(mpdu, Mod(F.L, 0)), d.pack_data(mpdu, Mod(F.HT, 3)),
            d.pack_data(aggregate_vht([mpdu]), Mod(F.VHT, 5))]
    svc = PhyService(mugid=0)
    gap = np.zeros(700, np.complex64)
    cap = np.concatenate([gap] + [np.concatenate([svc.handle_request(r)[0],
                                                  gap]) for r in reqs])
    recs = [d.unpack_rx_record(r) for r in svc.rx_capture(cap)]
    streamed = svc.rx_captures([cap, cap])
    fmts = sorted(r.fmt for r in recs if r.payload == mpdu)
    n_stream = [sum(getattr(d.unpack_rx_record(r), "payload", None) == mpdu
                    for r in rs) for rs in streamed]
    report("phy_service", records=len(recs), formats=fmts,
           streamed_per_capture=n_stream)
    if fmts != sorted(f.value for f in (F.L, F.HT, F.VHT)) \
            or n_stream != [3, 3]:
        raise AssertionError("PhyService loopback failed")


def four_cards():
    """__graft_entry__.dryrun_multichip(4): mesh dp=2 x sp=2 (ppermute
    halos, all_gather regroup), compared with the same captures decoded
    by the unsharded dual-chain receiver on one card."""
    import jax

    from __graft_entry__ import dryrun_multichip
    from ieee80211_phy.rx.mimo import MimoReceiver
    t = time.perf_counter()
    res = dryrun_multichip(4)
    wall = time.perf_counter() - t
    rx = MimoReceiver()
    for r, row in enumerate(res["capture"]):
        with jax.default_device(jax.devices()[0]):
            pkts, ndps = rx.decode_capture_full(row)
        one = sorted(m for p in pkts if p.fcs_ok for m in p.mpdus)
        mesh = sorted(res["mpdus"][r])
        report("four_cards_row", row=r, mesh_mpdus=len(mesh),
               one_card_mpdus=len(one), mesh_ndps=res["ndps"][r],
               one_card_ndps=len(ndps), same=one == mesh)
        if one != mesh or len(ndps) != res["ndps"][r]:
            raise AssertionError(f"row {r}: mesh and one card differ")
    report("four_cards", wall_s=wall)


def main():
    four = "--four-cards" in sys.argv[1:]
    with Phase("device"):
        phase_device(4 if four else 1)
    from ieee80211_phy.utils import runtime
    if four:
        with Phase("four_cards"):
            four_cards()
    else:
        for name, fn in (("viterbi", phase_viterbi), ("slice", phase_slice),
                         ("rx", phase_rx), ("crc", phase_crc),
                         ("tx", phase_tx), ("streams", phase_streams),
                         ("files", phase_files)):
            with Phase(name):
                fn()
    report("cache", **runtime.cache_stats())
    print(json.dumps({"ok": True, "device": runtime.device_info()}))


if __name__ == "__main__":
    main()
