"""Viterbi decoder sweep on a GPU: the XLA scan at each radix-2^k step and
the Pallas kernel at each (BLOCK, UNROLL) setting, at the widths
chip_smoke.py checks.

    python -m ieee80211_phy.perf.viterbi_sweep [--rounds 2] [--out FILE]

Every variant must decode the true bits exactly at LLR noise SIGMA, where
all of them make no errors at these widths; one that does not raises. Each
round times every width and variant in turn: a first call that compiles,
then the median of N_XLA or N_KERNEL calls by the host clock. One JSON
line per width, variant and round.
"""
from __future__ import annotations

import argparse
import json
import time
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coding
from ..ops.pallas import viterbi as V
from ..specs import CR
from ..tx.golden import bcc
from ..utils import runtime

SIGMA = 0.2
WIDTHS = (("lsig", 1024, 24, CR.CR12),
          ("vht20_mcs7", 1024, 4680, CR.CR56),
          ("vht20_cr34", 1024, 4680, CR.CR34),
          ("vht80_mcs9", 256, 15600, CR.CR56),
          ("trellis_limit", 64, 32782, CR.CR12))
RADICES = (1, 2, 3, 4)
KERNELS = ((32, 2), (32, 4), (32, 8), (16, 4), (8, 4))   # (BLOCK, UNROLL)
N_XLA, N_KERNEL = 3, 10


def _case(b, n_bits, cr, seed):
    """Random zero-terminated BCC streams -> (true bits, depunctured LLR
    pairs [b, n_bits, 2])."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(b, n_bits)).astype(np.int32)
    bits[:, -6:] = 0
    coded = np.stack([bcc(row, cr) for row in bits])
    llr = (coded * 2.0 - 1.0) + rng.normal(0, SIGMA, coded.shape)
    return bits, coding.depuncture(jnp.asarray(llr, jnp.float32), cr, n_bits)


def _time(fn, lp, n):
    """-> (output of the first call, median seconds of n more)."""
    out = jax.block_until_ready(fn(lp))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn(lp))
        ts.append(time.perf_counter() - t)
    return out, float(np.median(ts))


def _variants(n_bits, interpret):
    """(name, patch, fn): each decoder under the module constants it is
    traced with."""
    for k in RADICES:
        yield (f"xla_r{k}", mock.patch.object(coding, "XLA_RADIX", k),
               partial(coding.viterbi_decode_xla, n_bits=n_bits), N_XLA)
    for block, unroll in KERNELS:
        yield (f"kernel_b{block}_u{unroll}",
               mock.patch.multiple(V, BLOCK=block, UNROLL=unroll),
               partial(V.viterbi_decode_pallas, n_bits=n_bits,
                       interpret=interpret), N_KERNEL)


def sweep(widths=WIDTHS, rounds=2, interpret=False):
    """Yields one result dict per round, width and variant."""
    cases = {name: _case(b, n, cr, seed)
             for seed, (name, b, n, cr) in enumerate(widths)}
    for r in range(rounds):
        for name, b, n, cr in widths:
            bits, lp = cases[name]
            for var, patch, fn, n_calls in _variants(n, interpret):
                with patch:
                    V._build_call.cache_clear()
                    out, med = _time(jax.jit(fn), lp, n_calls)
                V._build_call.cache_clear()
                errs = int(np.sum(np.asarray(out) != bits))
                if errs:
                    raise AssertionError(f"{name} {var}: {errs} bit errors")
                yield {"round": r, "width": name, "batch": b, "n_bits": n,
                       "cr": cr.name, "variant": var, "median_s": med}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write all results to this JSON file")
    args = ap.parse_args(argv)
    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(runtime.gpu_name_and_power_limit(), flush=True)
    rows = []
    for row in sweep(rounds=args.rounds):
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": runtime.gpu_name_and_power_limit(),
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
