"""Pallas kernel (Triton route): 64-state soft Viterbi for NVIDIA GPUs.

The dominant RX cost (SURVEY.md §3.1, lib/decode_impl.cc:205-281) as one
fused kernel per tile of packets:

  * layout: one packet per lane. A program owns BLOCK packets; the 64
    path metrics of each live in registers as 64 separate [BLOCK] vectors,
    so the trellis butterfly (predecessors of s' are 2*(s' mod 32) + d) is
    plain Python indexing at trace time and needs no data movement;
  * branch metrics: the four (o0, o1) output pairs give four sums of the
    step's two LLRs, computed elementwise;
  * survivors: the 64 decision bits of a step are packed into two int32
    words per packet and written to device memory ([T, 2, B]: 8 bytes per
    step and packet, which stays in L2 at the headline shape);
  * traceback runs in the same kernel from the best final state, reading
    each step's two words back;
  * both loops take UNROLL steps per iteration and issue the next
    iteration's loads (LLRs forward, survivor words backward) before this
    iteration's work, so device-memory latency overlaps compute (2.5x on
    the H100 against loading each step where it is used);
  * metrics are renormalised (max subtracted) every RENORM steps, which
    keeps float32 exact enough on 33k-step trellises.

BLOCK and UNROLL were chosen on an H100 with
`python -m ieee80211_phy.perf.viterbi_sweep` (PERF.md).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ...specs import tables

NEG = -1e30
BLOCK = 32       # packets per program (one warp, one packet per lane)
RENORM = 32      # steps between metric renormalisations
UNROLL = 4       # trellis steps per loop iteration; loads run one ahead


@lru_cache(maxsize=None)
def _prev_out() -> tuple:
    """Per state s' and predecessor choice d: the index o = (o0 << 1) | o1
    of the two coded output bits on the transition into s'."""
    po = tables.SV_PREV_OUTPUT2
    return tuple((int(po[s, 0]), int(po[s, 1])) for s in range(64))


def _kernel(n_steps: int):
    prev_out = _prev_out()
    n_grp = n_steps // UNROLL

    def acs(l0, l1, m):
        """One trellis step: new metrics and the two survivor words."""
        bm = (jnp.zeros_like(l0), l1, l0, l0 + l1)    # o = (o0 << 1) | o1
        new = []
        words = [None, None]
        for s in range(64):
            p = 2 * (s % 32)
            o0, o1 = prev_out[s]
            a = m[p] + bm[o0]
            b = m[p + 1] + bm[o1]
            take = b > a
            new.append(jnp.where(take, b, a))
            bit = take.astype(jnp.int32) << (s % 32)
            w = s // 32
            words[w] = bit if words[w] is None else words[w] | bit
        return tuple(new), words

    def kernel(llr_ref, bits_ref, surv_ref):
        # Loads are issued one group of UNROLL steps ahead of their use
        # (carried through the loop), so their latency overlaps the
        # previous group's work instead of stalling every step.
        def load_llrs(g):
            t0 = jnp.minimum(g, n_grp - 1) * UNROLL
            return tuple(llr_ref[t0 + u, c, :]
                         for u in range(UNROLL) for c in range(2))

        def fwd_group(g, carry):
            m, cur = carry[:64], carry[64:]
            nxt = load_llrs(g + 1)
            for u in range(UNROLL):
                m, words = acs(cur[2 * u], cur[2 * u + 1], m)
                surv_ref[g * UNROLL + u, 0, :] = words[0]
                surv_ref[g * UNROLL + u, 1, :] = words[1]
            return m + nxt

        def fwd_block(j, carry):
            carry = jax.lax.fori_loop(j * (RENORM // UNROLL),
                                      (j + 1) * (RENORM // UNROLL),
                                      fwd_group, carry)
            m = carry[:64]
            top = m[0]
            for v in m[1:]:
                top = jnp.maximum(top, v)
            return tuple(v - top for v in m) + carry[64:]

        zero = jnp.zeros((BLOCK,), jnp.float32)
        m0 = (zero,) + tuple(zero + NEG for _ in range(63))
        carry = jax.lax.fori_loop(0, n_steps // RENORM, fwd_block,
                                  m0 + load_llrs(0))
        m = carry[:64]
        # best final state: first index of the maximum (argmax tie rule)
        best, state = m[0], jnp.zeros((BLOCK,), jnp.int32)
        for s in range(1, 64):
            upd = m[s] > best
            best = jnp.where(upd, m[s], best)
            state = jnp.where(upd, s, state)

        def load_surv(g):
            t0 = jnp.maximum(g, 0) * UNROLL
            return tuple(surv_ref[t0 + u, c, :]
                         for u in range(UNROLL) for c in range(2))

        def back_group(i, carry):
            state, cur = carry[0], carry[1:]
            g = n_grp - 1 - i
            nxt = load_surv(g - 1)
            for u in reversed(range(UNROLL)):
                w = jnp.where(state >= 32, cur[2 * u + 1], cur[2 * u])
                d = jax.lax.shift_right_logical(w, state & 31) & 1
                bits_ref[g * UNROLL + u, :] = (state >> 5).astype(jnp.int8)
                state = ((state & 31) << 1) | d
            return (state,) + nxt

        jax.lax.fori_loop(0, n_grp, back_group,
                          (state,) + load_surv(n_grp - 1))

    return kernel


@lru_cache(maxsize=None)
def _build_call(n_steps: int, b_pad: int, interpret: bool):
    spec = pl.BlockSpec((n_steps, 2, BLOCK), lambda i: (0, 0, i))
    return pl.pallas_call(
        _kernel(n_steps),
        out_shape=(jax.ShapeDtypeStruct((n_steps, b_pad), jnp.int8),
                   jax.ShapeDtypeStruct((n_steps, 2, b_pad), jnp.int32)),
        grid=(b_pad // BLOCK,),
        in_specs=[spec],
        out_specs=(pl.BlockSpec((n_steps, BLOCK), lambda i: (0, i)), spec),
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="viterbi_acs_traceback",
    )


def viterbi_decode_pallas(lp: jnp.ndarray, n_bits: int,
                          interpret: bool = False) -> jnp.ndarray:
    """Decode depunctured LLR pairs lp [B, n_bits, 2] (positive = bit 1)
    -> bits [B, n_bits] int32, traceback from the best final state.

    The batch is padded to a multiple of BLOCK and the trellis to a
    multiple of RENORM with zero LLRs, which are path-neutral.
    interpret=True runs the kernel through the Pallas interpreter (CPU
    tests)."""
    b = lp.shape[0]
    b_pad = -(-b // BLOCK) * BLOCK
    t_pad = -(-n_bits // RENORM) * RENORM
    lp = jnp.pad(lp.astype(jnp.float32),
                 ((0, b_pad - b), (0, t_pad - n_bits), (0, 0)))
    bits, _ = _build_call(t_pad, b_pad, interpret)(
        jnp.transpose(lp, (1, 2, 0)))
    return bits[:n_bits, :b].T.astype(jnp.int32)
