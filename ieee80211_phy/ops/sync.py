"""Batched synchronization ops: STF trigger, LTF fine sync, CFO estimation.

Batched re-design of the reference front-end
(presiso hier block + lib/trigger_impl.cc + lib/sync_impl.cc): the sliding
auto-correlations are cumulative-sum differences over the whole capture (one
fused pass, no per-sample loop), and the LTF plateau search is an argmax /
edge-midpoint reduction over a static lag window.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Geometry of the 20 MHz preamble relative to the STF start (our TX layout,
# identical to the reference golden model): STF [0,160), LTF field [160,320)
# with double-GI [160,192) and two 64-sample periods [192,320), L-SIG at 320.
LTF_FIELD = 160
LTF_DATA = 192
LSIG = 320


from functools import lru_cache

import numpy as _np


@lru_cache(maxsize=None)
def _band_mat(n: int, w: int) -> "_np.ndarray":
    """Banded 0/1 matrix [n, n-w+1]: x @ B = moving sum of window w."""
    m = _np.zeros((n, n - w + 1), dtype=_np.float32)
    for i in range(n - w + 1):
        m[i:i + w, i] = 1.0
    return m


def _movsum(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Moving sum over trailing axis, output length N - w + 1.

    Small windows run as a banded-matrix matmul; large axes use the
    cumsum-difference form.
    """
    n = x.shape[-1]
    if n <= 2048:
        band = jnp.asarray(_band_mat(n, w))
        if jnp.iscomplexobj(x):
            re = jnp.matmul(jnp.real(x), band,
                            preferred_element_type=jnp.float32)
            im = jnp.matmul(jnp.imag(x), band,
                            preferred_element_type=jnp.float32)
            return jax.lax.complex(re, im)
        return jnp.matmul(x, band, preferred_element_type=jnp.float32)
    c = jnp.cumsum(x, axis=-1)
    zero = jnp.zeros_like(c[..., :1])
    c = jnp.concatenate([zero, c], axis=-1)
    return c[..., w:] - c[..., :-w]


def stf_autocorr(x: jnp.ndarray, lag: int = 16, win: int = 16) -> jnp.ndarray:
    """Normalized 16-lag auto-correlation magnitude of a capture.

    x: [..., N] complex. Returns [..., N - lag - win + 1] in [0, 1].
    (Parity: presiso delay-16/conj-multiply/moving-average front-end,
    examples/presiso.grc, and tools/pktRxExample.py:117-151.)
    """
    prod = x[..., :-lag] * jnp.conj(x[..., lag:])
    pwr = jnp.abs(x) ** 2
    num = jnp.abs(_movsum(prod, win))
    p1 = _movsum(pwr[..., :-lag], win)
    p2 = _movsum(pwr[..., lag:], win)
    den = jnp.sqrt(p1 * p2) + 1e-12
    return num / den


def _batch_slice(x: jnp.ndarray, start: jnp.ndarray, length: int
                 ) -> jnp.ndarray:
    """One contiguous dynamic slice per batch row: [B, N] -> [B, length]."""
    return jax.vmap(
        lambda xb, s: jax.lax.dynamic_slice(xb, (s,), (length,)))(x, start)


def window_starts(start: jnp.ndarray, n: int, length: int) -> jnp.ndarray:
    """The one clamp rule for per-packet window starts: into [0, n - length]
    (the range lax.dynamic_slice itself clamps to), applied before any
    slice so every window extractor treats out-of-range starts alike."""
    return jnp.clip(start.astype(jnp.int32), 0, n - length)


def batch_slice_iq(x2: jnp.ndarray, start: jnp.ndarray, length: int
                   ) -> jnp.ndarray:
    """Per-row window slice on float32 I/Q: [B, N, 2] -> [B, length, 2].

    Slices the FLAT [B, 2N] view (start doubled), so each row is one
    contiguous copy; complexify AFTER slicing. Starts are clamped by
    window_starts.
    """
    b, n, _ = x2.shape
    xf = x2.reshape(b, 2 * n)
    seg = jax.vmap(lambda xb, s: jax.lax.dynamic_slice(
        xb, (2 * s,), (2 * length,)))(xf, window_starts(start, n, length))
    return seg.reshape(b, length, 2)


def sync_front_iq(x2: jnp.ndarray, t0: jnp.ndarray, n_prod: int = 144,
                  lag: int = 16, n_lag: int = 176, thresh: float = 0.88,
                  q: int = 1):
    """sync_front taking the raw [B, N, 2] float32 I/Q (one FLAT window
    slice, then complexify — see batch_slice_iq)."""
    from ..utils.riq import r2c
    n_prod, lag, n_lag = n_prod * q, lag * q, n_lag * q
    win = n_lag + 192 * q
    w = r2c(batch_slice_iq(x2, t0, 80 * q + win))
    acc = jnp.sum(w[:, :n_prod] * jnp.conj(w[:, lag:lag + n_prod]), axis=-1)
    cfo_c = jnp.arctan2(jnp.imag(acc), jnp.real(acc)) / lag
    return _ltf_sync_window(w[:, 80 * q:], t0, cfo_c, n_lag, thresh, q)


def coarse_cfo(x: jnp.ndarray, t0: jnp.ndarray, n_prod: int = 144,
               lag: int = 16) -> jnp.ndarray:
    """Coarse CFO (rad/sample) from the STF: angle of the averaged lag-16
    product over the STF span. x: [B, N], t0: [B] STF start."""
    w = _batch_slice(x, t0, n_prod + lag)
    acc = jnp.sum(w[:, :n_prod] * jnp.conj(w[:, lag:lag + n_prod]), axis=-1)
    return jnp.arctan2(jnp.imag(acc), jnp.real(acc)) / lag


def _ltf_sync_window(y: jnp.ndarray, t0: jnp.ndarray, cfo_rad: jnp.ndarray,
                     n_lag: int, thresh: float, q: int = 1):
    """Core of ltf_sync given the pre-sliced window y = x[t0+80q :][:win].

    q = oversample factor vs 20 MHz (1/2/4 for 20/40/80 MHz captures); all
    preamble geometry scales by q. Returns (ltf_data_start, cfo_total, snr).
    The fine CFO reuses the complex lag-64q moving sum already computed for
    the correlation — the 128q-sample product sum starting at d_mid+16q is
    exactly movsum(prod, 64q)[d_mid+16q] — so no second window gather is
    needed.
    """
    p = 64 * q                                 # LTF period in samples
    win = n_lag + 2 * p + p
    y = y * cfo_ramp(cfo_rad, win)
    prod = y[:, :-p] * jnp.conj(y[:, p:])
    pwr = jnp.abs(y) ** 2
    # all four real moving sums as ONE banded matmul (stacked on the batch
    # axis): fewer kernel launches than four separate movsums
    b = y.shape[0]
    stacked = jnp.concatenate([jnp.real(prod), jnp.imag(prod),
                               pwr[:, :-p], pwr[:, p:]], axis=0)
    band = jnp.asarray(_band_mat(stacked.shape[-1], p))
    ms = jnp.matmul(stacked, band, preferred_element_type=jnp.float32)
    num = jax.lax.complex(ms[:b], ms[b:2 * b])
    p1 = ms[2 * b:3 * b]
    p2 = ms[3 * b:]
    ac = (jnp.abs(num) / (jnp.sqrt(p1 * p2) + 1e-12))[:, :n_lag]
    mx = jnp.max(ac, axis=-1)
    mask = ac >= thresh * mx[:, None]
    idx = jnp.arange(n_lag)[None, :]
    first = jnp.min(jnp.where(mask, idx, n_lag), axis=-1)
    last = jnp.max(jnp.where(mask, idx, -1), axis=-1)
    d_mid = (first + last) // 2
    # plateau center d=96q corresponds to LTF data start at t0+80q+d+16q;
    # bias 2q samples early: with the GI sampling shift of 8q the early side
    # has ~8q clean samples of margin while any late error causes ISI
    # (noise can move the plateau edges by +-1).
    ltf_start = t0 + 80 * q + d_mid + 16 * q - 2 * q
    acc = jnp.take_along_axis(num, (d_mid + 16 * q)[:, None], axis=-1)[:, 0]
    fine = jnp.arctan2(jnp.imag(acc), jnp.real(acc)) / p
    snr = 10.0 * jnp.log10(jnp.maximum(mx / jnp.maximum(1 - mx, 1e-6), 1e-6))
    return ltf_start, cfo_rad + fine, snr


def sync_front(x: jnp.ndarray, t0: jnp.ndarray, n_prod: int = 144,
               lag: int = 16, n_lag: int = 176, thresh: float = 0.88,
               q: int = 1):
    """Fused front-end: coarse STF CFO + LTF fine sync from ONE window
    gather (coarse_cfo + ltf_sync need overlapping slices; slicing
    [t0, t0+(80+n_lag+192)q) once serves both).

    q scales the whole preamble geometry for 40/80 MHz captures (the STF
    period is 16q samples, the LTF period 64q). Default args are in 20 MHz
    units and are multiplied by q.
    Returns (ltf_data_start [B], cfo_total_rad [B], snr_metric [B]).
    """
    n_prod, lag, n_lag = n_prod * q, lag * q, n_lag * q
    win = n_lag + 192 * q
    w = _batch_slice(x, t0, 80 * q + win)
    acc = jnp.sum(w[:, :n_prod] * jnp.conj(w[:, lag:lag + n_prod]), axis=-1)
    cfo_c = jnp.arctan2(jnp.imag(acc), jnp.real(acc)) / lag
    return _ltf_sync_window(w[:, 80 * q:], t0, cfo_c, n_lag, thresh, q)


def ltf_sync(x: jnp.ndarray, t0: jnp.ndarray, cfo_rad: jnp.ndarray,
             n_lag: int = 176, thresh: float = 0.88):
    """Fine timing + fine CFO from the L-LTF 64-lag auto-correlation.

    x: [B, N]; t0: [B] approximate STF start (from the trigger);
    cfo_rad: [B] coarse CFO (rad/sample, compensation sign).

    The 64-lag correlation over the window starting at t0+80 is a trapezoid
    whose plateau is centered where the 128-sample correlation window sits
    wholly inside the periodic LTF region; the midpoint of the
    above-threshold region locates the LTF independently of the trigger
    error. Returns (ltf_data_start [B], cfo_total_rad [B], snr_metric [B]).
    (Parity: lib/sync_impl.cc:156-196 ltf_autoCorrelation/ltf_cfo; lag range
    extended to cover both plateau edges so no empirical offset is needed.)
    """
    win = n_lag + 128 + 64
    y = _batch_slice(x, t0 + 80, win)                     # [B, win]
    return _ltf_sync_window(y, t0, cfo_rad, n_lag, thresh)


def cfo_ramp(cfo_rad: jnp.ndarray, n: int) -> jnp.ndarray:
    """exp(j * cfo * arange(n)) per row, [B] -> [B, n].

    Kept elementwise so that XLA can fuse the ramp into the downstream
    window extraction (a factored outer-product form materializes the
    product and blocks that fusion)."""
    ph = cfo_rad[:, None] * jnp.arange(n, dtype=jnp.float32)[None, :]
    return jax.lax.complex(jnp.cos(ph), jnp.sin(ph))


def apply_cfo_correction(x: jnp.ndarray, cfo_rad: jnp.ndarray) -> jnp.ndarray:
    """Multiply [B, N] by exp(j * cfo_rad * n) (compensation ramp)."""
    return x * cfo_ramp(cfo_rad, x.shape[-1])


# ---------------------------------------------------------------------------
# capture-level trigger ON DEVICE (the host scan is the dominant host cost
# of the streaming receiver; the same O(N) sliding correlation is
# embarrassingly parallel on the device)
# ---------------------------------------------------------------------------


def _movsum_i32(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Exact integer moving sum via int32 cumsum-difference (an f32 cumsum
    over multi-million-sample captures has ulp ~1 at 2^23 — enough to
    corrupt a plateau count)."""
    c = jnp.cumsum(x.astype(jnp.int32))
    c = jnp.concatenate([jnp.zeros(1, jnp.int32), c])
    return c[w:] - c[:-w]


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("k_max", "q", "plateau", "min_gap",
                                    "thresh"))
def trigger_scan_capture(cap: jnp.ndarray, scale: jnp.ndarray,
                         k_max: int = 4096, q: int = 1,
                         thresh: float = 0.5, plateau: int = 20,
                         min_gap: int = 400):
    """STF trigger scan of a whole device-resident capture, in-graph.

    cap: [Npad, 2] int8/float32 I/Q (the decode upload, reused); scale:
    dequant scale. Returns (t0s [k_max] int32 ascending — Npad sentinel
    for empty slots — and n_trig [] int32, which may exceed k_max when
    the capacity was hit).

    Same plateau/rising-edge semantics as the host/native scan
    (lib/trigger_impl.cc:75-110, native/phyrt.cc); the sequential
    min_gap suppression is replaced by a windowed form (a rise is kept
    iff NO other rise occurred in the preceding min_gap samples) — it
    differs from the sequential scan only for >=3 rises within 2 gaps,
    which real STF trains do not produce.
    """
    from ..utils.riq import r2c
    x = r2c(cap.astype(jnp.float32) * scale)
    n = x.shape[0]
    lag = 16 * q
    plateau, min_gap = plateau * q, min_gap * q
    ac = stf_autocorr(x[None], lag=lag, win=lag)[0]
    above = ac > thresh
    cnt = _movsum_i32(above, plateau)
    runp = cnt == plateau
    prev = jnp.concatenate([jnp.zeros(1, bool),
                            above[:-1]])[:runp.shape[0]]
    rise = runp & ~prev
    prior = _movsum_i32(
        jnp.concatenate([jnp.zeros(min_gap, bool), rise]), min_gap)
    keep = rise & (prior[:rise.shape[0]] == 0)
    (idx,) = jnp.nonzero(keep, size=k_max, fill_value=n)
    return idx.astype(jnp.int32), jnp.sum(keep.astype(jnp.int32))


# ---------------------------------------------------------------------------
# capture-level trigger (host-side helper, vectorized numpy)
# ---------------------------------------------------------------------------


def find_triggers_np(x: np.ndarray, thresh: float = 0.5, plateau: int = 20,
                     min_gap: int = 400, q: int = 1) -> np.ndarray:
    """Find STF trigger positions in a long 1-D capture.

    Host front-end analog of trigger_impl (lib/trigger_impl.cc:75-110):
    a trigger fires where the 16q-lag STF auto-correlation stays above
    `thresh` for `plateau` consecutive samples. q is the oversample factor
    vs 20 MHz (plateau/min_gap callers pass 20 MHz-unit values; they scale
    by q here). Returns approximate STF start indices (the rise point of
    each plateau). Uses the native C++ runtime (native/phyrt.cc) when
    available (20 MHz captures); numpy fallback below.
    """
    x = np.asarray(x)
    plateau, min_gap = plateau * q, min_gap * q
    from ..native import find_triggers as _native_triggers
    nt = _native_triggers(x, thresh=thresh, plateau=plateau,
                          min_gap=min_gap, lag=16 * q)
    if nt is not None:
        return nt
    lag = 16 * q
    prod = x[:-lag] * np.conj(x[lag:])
    pwr = np.abs(x) ** 2
    kern = np.ones(lag)
    num = np.abs(np.convolve(prod, kern, mode="valid"))
    p1 = np.convolve(pwr[:-lag], kern, mode="valid")
    p2 = np.convolve(pwr[lag:], kern, mode="valid")
    ac = num / (np.sqrt(p1 * p2) + 1e-12)
    above = ac > thresh
    # run-length: count consecutive True
    run = np.zeros(len(above), dtype=np.int64)
    cnt = 0
    starts = []
    last = -min_gap
    for i, a in enumerate(above):
        cnt = cnt + 1 if a else 0
        run[i] = cnt
        if cnt == plateau:
            s = i - plateau + 1
            if s - last >= min_gap:
                starts.append(s)
                last = s
    return np.asarray(starts, dtype=np.int64)
