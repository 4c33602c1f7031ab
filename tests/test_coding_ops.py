"""Unit tests for JAX coding ops vs the reference Viterbi/scrambler."""
import jax.numpy as jnp
import numpy as np
import pytest

from ieee80211_phy.ops import coding
from ieee80211_phy.specs import CR
from ieee80211_phy.tx.golden import bcc, bcc_encode, puncture, scramble

from reference_oracle import get_oracle, quiet


@pytest.fixture(scope="module")
def p8h():
    return get_oracle("phy80211header")


def test_bcc_vs_reference(p8h):
    rng = np.random.default_rng(0)
    with quiet():
        for cr, refcr in [(CR.CR12, p8h.CR.CR12), (CR.CR23, p8h.CR.CR23),
                          (CR.CR34, p8h.CR.CR34), (CR.CR56, p8h.CR.CR56)]:
            bits = rng.integers(0, 2, 120).tolist()
            ref = p8h.procBcc(bits, refcr)
            np.testing.assert_array_equal(bcc(np.asarray(bits), cr),
                                          np.asarray(ref))


@pytest.mark.parametrize("cr", [CR.CR12, CR.CR23, CR.CR34, CR.CR56])
def test_viterbi_clean_roundtrip(cr):
    rng = np.random.default_rng(1)
    n_bits = 240
    batch = []
    llrs = []
    for b in range(4):
        bits = rng.integers(0, 2, n_bits)
        bits[-6:] = 0  # zero-terminate
        coded = bcc(bits, cr)
        llr = coded * 2.0 - 1.0
        llr = llr + rng.normal(0, 0.15, len(llr))
        batch.append(bits)
        llrs.append(llr)
    out = coding.viterbi_decode(jnp.asarray(np.stack(llrs), dtype=jnp.float32),
                                cr, n_bits)
    np.testing.assert_array_equal(np.asarray(out), np.stack(batch))


@pytest.mark.parametrize("cr,refpunc", [(CR.CR12, None), (CR.CR34, None)])
def test_viterbi_vs_reference_decoder(p8h, cr, refpunc):
    """Exact agreement with the reference soft Viterbi on noisy LLRs."""
    rng = np.random.default_rng(2)
    n_bits = 96
    refcr = {CR.CR12: p8h.CR.CR12, CR.CR34: p8h.CR.CR34}[cr]
    bits = rng.integers(0, 2, n_bits)
    bits[-6:] = 0
    coded = bcc(bits, cr)
    llr = (coded * 2.0 - 1.0) + rng.normal(0, 0.4, len(coded))
    with quiet():
        ref = p8h.procViterbiDecoder(list(llr), n_bits, refcr)
    out = coding.viterbi_decode(jnp.asarray(llr[None], dtype=jnp.float32),
                                cr, n_bits)[0]
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_descramble_roundtrip():
    rng = np.random.default_rng(3)
    for seed in (1, 93, 127):
        data = rng.integers(0, 2, 400)
        data[:7] = 0   # service field starts with zeros
        scr = scramble(data, seed)
        out = coding.descramble(jnp.asarray(scr[None]))[0]
        np.testing.assert_array_equal(np.asarray(out), data)


def test_depuncture_shapes():
    lp = coding.depuncture(jnp.ones((2, 9)), CR.CR34, 6)
    assert lp.shape == (2, 6, 2)
    # pattern 110110 over 12 slots -> kept slots 0,1,2,5,6,7,8,11
    slots = coding.depuncture_slots(CR.CR34, 6)
    np.testing.assert_array_equal(slots, [0, 1, 2, 5, 6, 7, 8, 11])


@pytest.mark.parametrize("n_bits", [120, 121, 122, 123])
@pytest.mark.parametrize("cr", [CR.CR12, CR.CR23, CR.CR34, CR.CR56])
def test_viterbi_xla_every_radix(cr, n_bits):
    """The XLA reference decodes exactly at trellis lengths that are and
    are not multiples of its radix-2^k step (XLA_RADIX)."""
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (3, n_bits)).astype(np.int32)
    bits[:, -6:] = 0
    coded = np.stack([bcc(row, cr) for row in bits])
    llr = jnp.asarray((coded * 2.0 - 1.0)
                      + rng.normal(0, 0.2, coded.shape), jnp.float32)
    lp = coding.depuncture(llr, cr, n_bits)
    out = coding.viterbi_decode_xla(lp, n_bits)
    assert out.shape == (3, n_bits)
    np.testing.assert_array_equal(np.asarray(out), bits)

