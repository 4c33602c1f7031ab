"""Batched channel-coding ops (JAX): soft Viterbi, (de)puncture, scramble.

Batched re-design of the reference's streaming Viterbi
(/root/reference/lib/decode_impl.cc:164-302 vstb_* and
tools/phy80211header.py:998-1063 procViterbiDecoder): on a GPU the
64-state add-compare-select and traceback run in one Pallas kernel
(ops/pallas/viterbi.py); the plain-XLA form is a `lax.scan` over radix-2^k
trellis blocks with the state axis and the packet batch vectorized.
Puncturing becomes a static per-column select; the scrambler is a
closed-form PRBS table lookup (no sequential state).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..specs import CR, tables

NEG = -1e30
XLA_RADIX = 3    # trellis steps per scan iteration of the XLA decoder:
                 # the fastest on the CPU, where it is the decoder (PERF.md)


@lru_cache(maxsize=None)
def _radix_tables(k: int):
    """Tables for a radix-2^k trellis step (k input bits per scan iter).

    After k steps, new state s'' keeps the old state's high 6-k bits in its
    low bits and the k fresh inputs in its high bits; the dropped low k bits
    of the old state enumerate the 2^k candidate paths:
        p = ((s'' mod 2^(6-k)) << k) | path,  inputs b_j = bit (6-k+j) of s''.
    Returns (W0, W1): float32 [64, 2^k, k] output-bit weights of each step
    along each path.
    """
    assert 1 <= k <= 6
    npaths = 1 << k
    w0 = np.zeros((64, npaths, k), dtype=np.float32)
    w1 = np.zeros((64, npaths, k), dtype=np.float32)
    nxt = tables.SV_STATE_NEXT
    out2 = tables.SV_STATE_OUTPUT2
    mask = (1 << (6 - k)) - 1
    for s2 in range(64):
        bits = [(s2 >> (6 - k + j)) & 1 for j in range(k)]
        for path in range(npaths):
            p = ((s2 & mask) << k) | path
            s = p
            for j in range(k):
                o = out2[s, bits[j]]
                w0[s2, path, j] = (o >> 1) & 1
                w1[s2, path, j] = o & 1
                s = nxt[s, bits[j]]
            assert s == s2
    return w0, w1


@lru_cache(maxsize=None)
def depuncture_slots(cr: CR, n_steps: int) -> np.ndarray:
    """Flat indices into a zeroed [n_steps*2] LLR buffer for each surviving
    (punctured-stream) position."""
    pat = tables.PUNCTURE[cr].astype(bool)
    tiled = np.tile(pat, -(-2 * n_steps // len(pat)))[: 2 * n_steps]
    return np.nonzero(tiled)[0].astype(np.int32)


def n_punctured(cr: CR, n_steps: int) -> int:
    return int(len(depuncture_slots(cr, n_steps)))


def depuncture(llrs: jnp.ndarray, cr: CR, n_steps: int) -> jnp.ndarray:
    """[..., n_coded] punctured LLRs -> [..., n_steps, 2] with zeros inserted.

    The puncture pattern is periodic (period <= 10), so depuncturing is a
    reshape to pattern cycles + a static per-column select — no scatter.
    """
    pat = tables.PUNCTURE[cr].astype(bool)
    period = len(pat)
    n_keep = int(pat.sum())
    batch = llrs.shape[:-1]
    n_cyc = -(-2 * n_steps // period)
    need = n_cyc * n_keep
    have = llrs.shape[-1]
    if have < need:
        llrs = jnp.pad(llrs, [(0, 0)] * len(batch) + [(0, need - have)])
    elif have > need:
        llrs = llrs[..., :need]
    cyc = llrs.reshape(batch + (n_cyc, n_keep))
    zero = jnp.zeros(batch + (n_cyc, 1), llrs.dtype)
    cols = []
    ki = 0
    for p in pat:
        if p:
            cols.append(cyc[..., ki:ki + 1])
            ki += 1
        else:
            cols.append(zero)
    flat = jnp.concatenate(cols, axis=-1).reshape(batch + (n_cyc * period,))
    return flat[..., : 2 * n_steps].reshape(batch + (n_steps, 2))


def _viterbi_core(lp: jnp.ndarray, m0: jnp.ndarray, radix: int
                  ) -> jnp.ndarray:
    """ACS + traceback over depunctured LLR pairs.

    lp: [B, T, 2] (T divisible by radix), m0: [B, 64] initial metrics.
    Returns decoded bits [B, T] int32 (traceback from the best final state).
    """
    k = radix
    b, t_pad, _ = lp.shape
    assert t_pad % k == 0
    n_blk = t_pad // k
    w0, w1 = _radix_tables(k)                          # [64, 2^k, k]
    lpb = jnp.moveaxis(lp, 1, 0).reshape(n_blk, k, b, 2)
    # under shard_map the scan carry's varying-axes set must match the
    # data's; deriving m0 from lp makes this hold in sharded callers
    m0 = m0 + 0.0 * lp[:, :1, 0]
    n_low = 1 << (6 - k)
    n_path = 1 << k

    def step(m, llrk):
        l0 = llrk[:, :, 0]                              # [k, B]
        l1 = llrk[:, :, 1]
        hi = jax.lax.Precision.HIGHEST     # a reference: no TF32 on GPUs
        bm = (jnp.tensordot(l0.T, jnp.moveaxis(w0, -1, 0), axes=1,
                            precision=hi)
              + jnp.tensordot(l1.T, jnp.moveaxis(w1, -1, 0), axes=1,
                              precision=hi))
        mm = jnp.tile(m.reshape(b, n_low, n_path), (1, n_path, 1))
        cand = mm + bm                                  # [B, 64, 2^k]
        dec = jnp.argmax(cand, axis=-1).astype(jnp.int8)
        new_m = jnp.max(cand, axis=-1)
        new_m = new_m - jnp.max(new_m, axis=-1, keepdims=True)
        return new_m, dec

    m_fin, decs = jax.lax.scan(step, m0, lpb)          # decs [nBlk, B, 64]

    low_mask = n_low - 1
    shifts = jnp.arange(k, dtype=jnp.int32)

    def back(state, dec_t):
        path = jnp.take_along_axis(dec_t, state[:, None],
                                   axis=-1)[:, 0].astype(jnp.int32)
        bits = (state[:, None] >> (6 - k + shifts[None, :])) & 1  # [B, k]
        prev = ((state & low_mask) << k) + path
        return prev, bits

    s0 = jnp.argmax(m_fin, axis=-1).astype(jnp.int32)
    _, bits_rev = jax.lax.scan(back, s0, decs, reverse=True)
    return jnp.moveaxis(bits_rev, 0, 1).reshape(b, t_pad)


def viterbi_decode_xla(lp: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """The plain-XLA decoder: `_viterbi_core` over depunctured LLR pairs
    lp [B, n_bits, 2], padded with path-neutral zero LLRs to a multiple of
    XLA_RADIX. The reference the GPU kernel is tested against, and the
    decoder on every other backend."""
    b = lp.shape[0]
    radix = XLA_RADIX
    t_pad = -(-n_bits // radix) * radix
    if t_pad != n_bits:
        lp = jnp.pad(lp, ((0, 0), (0, t_pad - n_bits), (0, 0)))
    # Traceback starts from the best final state: L/HT streams carry
    # scrambled pad bits after the zero tail, so the encoder need not end
    # in state 0.
    m0 = jnp.full((b, 64), NEG, dtype=jnp.float32).at[:, 0].set(0.0)
    return _viterbi_core(lp, m0, radix)[:, :n_bits]


def viterbi_decode_pairs(lp: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """viterbi_decode for PRE-DEPUNCTURED LLR pairs [B, n_bits, 2]
    (punctured slots already zero). The generic multi-config decoder
    builds its trellis input with depuncturing folded into a per-window
    gather, so the per-CR depuncture is skipped.

    The one place that picks the decoder: the fused Pallas kernel on a
    GPU (ops/pallas/viterbi.py), the XLA scan elsewhere."""
    if jax.default_backend() == "gpu":
        from .pallas.viterbi import viterbi_decode_pallas
        return viterbi_decode_pallas(lp, n_bits)
    return viterbi_decode_xla(lp, n_bits)


def viterbi_decode(llrs: jnp.ndarray, cr: CR, n_bits: int) -> jnp.ndarray:
    """Soft Viterbi decode of a zero-terminated BCC stream.

    llrs: [B, n_coded] punctured soft bits (positive = bit 1, matching the
    reference's LLR sign convention). Returns decoded bits [B, n_bits] int32.
    """
    return viterbi_decode_pairs(depuncture(llrs, cr, n_bits), n_bits)


# ---------------------------------------------------------------------------
# scrambler (closed-form)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _seed_from_first7() -> np.ndarray:
    """Map the first 7 PRBS bits (LSB-first packed) -> scrambler seed."""
    inv = np.zeros(128, dtype=np.int32)
    for seed in range(1, 128):
        key = 0
        for i in range(7):
            key |= int(tables.SCRAMBLE_SEQ[seed, i]) << i
        inv[key] = seed
    return inv


@lru_cache(maxsize=None)
def _prbs_tiled(n: int) -> np.ndarray:
    reps = -(-n // 127)
    return np.stack([np.tile(tables.SCRAMBLE_SEQ[s], reps)[:n]
                     for s in range(128)]).astype(np.int32)


def descramble(bits: jnp.ndarray) -> jnp.ndarray:
    """Recover the scrambler seed from the first 7 (known-zero) service bits
    and remove the PRBS. bits: [B, N] -> [B, N] (first 7 bits zeroed).

    Parity: reference descramble (lib/decode_impl.cc:304-323) — but instead
    of running the LFSR, the seed indexes a precomputed PRBS table.
    """
    n = bits.shape[-1]
    prbs = jnp.asarray(_prbs_tiled(n), dtype=jnp.float32)   # [128, N]
    inv = jnp.asarray(_seed_from_first7())                  # [128]
    key = jnp.sum(bits[:, :7].astype(jnp.int32)
                  * (1 << jnp.arange(7, dtype=jnp.int32)), axis=-1)
    seed = inv[key]
    # PRBS row select as a one-hot matmul instead of a row gather (exact
    # at any matmul precision: one nonzero 0/1 term per output), then XOR
    # in arithmetic form: a^b = a + b - 2ab for a,b in {0,1}.
    onehot = (seed[:, None] == jnp.arange(128)[None, :]).astype(jnp.float32)
    p = jnp.matmul(onehot, prbs, preferred_element_type=jnp.float32)
    b = bits.astype(jnp.float32)
    return (b + p - 2.0 * b * p).astype(jnp.int32)


def scramble_seed_of(bits: jnp.ndarray) -> jnp.ndarray:
    inv = jnp.asarray(_seed_from_first7())
    key = jnp.sum(bits[:, :7].astype(jnp.int32)
                  * (1 << jnp.arange(7, dtype=jnp.int32)), axis=-1)
    return inv[key]
