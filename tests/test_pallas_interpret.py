"""The GPU Viterbi kernel (ops/pallas/viterbi.py) in Pallas interpret mode.

On a GPU every decode runs the kernel; CPU CI runs the XLA scan. This file
runs the SAME kernel code through the Pallas interpreter and checks it
against the encoder's true bits, the XLA reference and the reference
project's decoder: every code rate at batches below, at and above one
tile (BLOCK packets), the 24-bit SIG decode, batch and trellis padding,
long trellises, and the one dispatch point in ops/coding.py. (Interpret mode cannot show what the
GPU compiler refuses: chip_smoke.py compiles the kernel on the card.)
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ieee80211_phy.ops import coding
from ieee80211_phy.ops.pallas import viterbi as V
from ieee80211_phy.specs import CR
from ieee80211_phy.tx.golden import bcc

from reference_oracle import get_oracle, quiet

CRS = [CR.CR12, CR.CR23, CR.CR34, CR.CR56]


def _case(seed, batch, n_bits, cr, sigma=0.2):
    """Random zero-terminated BCC streams -> (true bits, punctured LLRs)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(batch, n_bits)).astype(np.int32)
    bits[:, -6:] = 0  # zero tail
    coded = np.stack([bcc(row, cr) for row in bits])
    llr = (coded * 2.0 - 1.0) + rng.normal(0, sigma, coded.shape)
    return bits, jnp.asarray(llr, jnp.float32)


def _kernel(llr, cr, n_bits):
    lp = coding.depuncture(llr, cr, n_bits)
    return np.asarray(V.viterbi_decode_pallas(lp, n_bits, interpret=True))


@pytest.mark.parametrize("batch", [5, V.BLOCK, V.BLOCK + 8])
@pytest.mark.parametrize("cr", CRS)
def test_kernel_decodes_every_rate_and_tile(cr, batch):
    """A part tile, one whole tile, and a second part tile."""
    bits, llr = _case(batch * 10 + cr.value, batch, 200, cr)
    np.testing.assert_array_equal(_kernel(llr, cr, 200), bits)


@pytest.mark.parametrize("n_bits", [24, 48, 130, 400])
@pytest.mark.parametrize("cr", CRS)
def test_kernel_matches_xla_reference(cr, n_bits):
    """Bit-identical to the XLA scan at a noise level where both make
    errors: the same trellis, the same tie rule (lower predecessor)."""
    _, llr = _case(n_bits + cr.value, 4, n_bits, cr, sigma=0.9)
    want = np.asarray(coding.viterbi_decode(llr, cr, n_bits))
    np.testing.assert_array_equal(_kernel(llr, cr, n_bits), want)


@pytest.mark.parametrize("cr", [CR.CR12, CR.CR34])
def test_kernel_matches_reference_decoder(cr):
    """Exact agreement with the reference soft Viterbi on noisy LLRs."""
    p8h = get_oracle("phy80211header")
    refcr = {CR.CR12: p8h.CR.CR12, CR.CR34: p8h.CR.CR34}[cr]
    _, llr = _case(2, 1, 96, cr, sigma=0.4)
    with quiet():
        ref = p8h.procViterbiDecoder(list(np.asarray(llr[0])), 96, refcr)
    np.testing.assert_array_equal(_kernel(llr, cr, 96)[0], np.asarray(ref))


def test_kernel_sig_length_trellis():
    """24-bit L-SIG decode, batch not a multiple of the tile."""
    bits, llr = _case(12, 33, 24, CR.CR12)
    np.testing.assert_array_equal(_kernel(llr, CR.CR12, 24), bits)


@pytest.mark.parametrize("batch", [1, 7, V.BLOCK + 1, 2 * V.BLOCK + 1])
def test_kernel_batch_padding(batch):
    bits, llr = _case(batch, batch, 120, CR.CR23)
    got = _kernel(llr, CR.CR23, 120)
    assert got.shape == (batch, 120) and got.dtype == np.int32
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("n_bits", [V.RENORM - 1, V.RENORM, V.RENORM + 1,
                                    3 * V.RENORM - 1])
def test_kernel_trellis_padding(n_bits):
    """Trellis lengths around the renormalisation period: the zero-LLR
    padding steps must not move the traceback."""
    bits, llr = _case(n_bits, 3, n_bits, CR.CR12)
    np.testing.assert_array_equal(_kernel(llr, CR.CR12, n_bits), bits)


def test_kernel_long_trellis():
    """Many renormalisations with large LLRs: metrics stay bounded."""
    bits, llr = _case(11, 2, 4000, CR.CR34)
    np.testing.assert_array_equal(_kernel(llr * 50.0, CR.CR34, 4000), bits)


def test_kernel_unterminated_stream():
    """Traceback starts from the best final state: L/HT streams carry
    scrambled pad bits after the zero tail, so the encoder need not end
    in state 0."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(4, 150)).astype(np.int32)
    bits[:, 100:106] = 0
    coded = np.stack([bcc(row, CR.CR12) for row in bits])
    llr = jnp.asarray(coded * 2.0 - 1.0, jnp.float32)
    np.testing.assert_array_equal(_kernel(llr, CR.CR12, 150), bits)


def test_kernel_takes_pre_depunctured_pairs():
    """The generic decoder hands over LLR pairs with punctured slots
    already zero (coding.viterbi_decode_pairs)."""
    bits, llr = _case(3, 6, 180, CR.CR56)
    lp = coding.depuncture(llr, CR.CR56, 180)
    got = np.asarray(V.viterbi_decode_pallas(lp, 180, interpret=True))
    np.testing.assert_array_equal(got, bits)


def test_kernel_under_jit_default_tile():
    """Jitted like every caller does, with the default tile."""
    bits, llr = _case(4, 40, 64, CR.CR12)
    lp = coding.depuncture(llr, CR.CR12, 64)
    f = jax.jit(partial(V.viterbi_decode_pallas, n_bits=64, interpret=True))
    np.testing.assert_array_equal(np.asarray(f(lp)), bits)


def test_dispatch_cpu_runs_the_xla_scan(monkeypatch):
    calls = []
    monkeypatch.setattr(V, "viterbi_decode_pallas",
                        lambda *a, **k: calls.append(1))
    bits, llr = _case(6, 2, 48, CR.CR12)
    got = np.asarray(coding.viterbi_decode(llr, CR.CR12, 48))
    assert not calls
    np.testing.assert_array_equal(got, bits)


def test_dispatch_gpu_runs_the_kernel(monkeypatch):
    calls = []
    real = V.viterbi_decode_pallas

    def kernel(lp, n_bits):
        calls.append(lp.shape)
        return real(lp, n_bits, interpret=True)
    monkeypatch.setattr(V, "viterbi_decode_pallas", kernel)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    bits, llr = _case(7, 3, 48, CR.CR34)
    got = np.asarray(coding.viterbi_decode(llr, CR.CR34, 48))
    assert calls == [(3, 48, 2)]
    np.testing.assert_array_equal(got, bits)
