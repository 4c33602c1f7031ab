"""Per-packet window extraction: sync.batch_slice_iq, receiver.capture_windows
and receiver.capture_windows_mimo against numpy slicing, with the one clamp
rule they share (sync.window_starts)."""
import jax.numpy as jnp
import numpy as np
import pytest

from ieee80211_phy.ops import sync
from ieee80211_phy.rx.receiver import capture_windows, capture_windows_mimo

SHAPES = [
    (8, 500, 120),       # small, unaligned everything
    (32, 2320, 2080),    # the headline RxPipeline window
    (5, 300, 300),       # full-length slice
    (16, 1096, 1096),    # full-length, row not a power of two
    (3, 129, 64),        # tiny
]


def _np_clamp(st, n, length):
    return np.clip(st, 0, n - length)


@pytest.mark.parametrize("b,n,length", SHAPES)
def test_batch_slice_iq_matches_numpy(b, n, length):
    rng = np.random.default_rng(b * 1000 + length)
    x = rng.standard_normal((b, n, 2)).astype(np.float32)
    st = rng.integers(0, n - length + 1, b).astype(np.int32)
    got = np.asarray(sync.batch_slice_iq(jnp.asarray(x), jnp.asarray(st),
                                         length))
    want = np.stack([x[r, s:s + length] for r, s in enumerate(st)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,n,length", SHAPES)
def test_capture_windows_matches_numpy(b, n, length):
    rng = np.random.default_rng(b + n)
    cap = rng.standard_normal((n, 2)).astype(np.float32)
    st = rng.integers(0, n - length + 1, b).astype(np.int32)
    got = np.asarray(capture_windows(jnp.asarray(cap), jnp.asarray(st),
                                     length))
    want = np.stack([cap[s:s + length] for s in st])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,n,length", SHAPES)
def test_capture_windows_mimo_matches_numpy(b, n, length):
    rng = np.random.default_rng(b + 7 * n)
    cap = rng.integers(-128, 128, (2, n, 2)).astype(np.int8)
    st = rng.integers(0, n - length + 1, b).astype(np.int32)
    got = np.asarray(capture_windows_mimo(jnp.asarray(cap), jnp.asarray(st),
                                          length))
    assert got.dtype == np.int8
    want = np.stack([cap[:, s:s + length] for s in st])
    np.testing.assert_array_equal(got, want)


BOUNDARY = np.array([0, 700 - 256, 1, 700 - 257, 7, 128, 129, 255, 300],
                    dtype=np.int32)


def test_batch_slice_iq_boundary_starts():
    rng = np.random.default_rng(0)
    b, n, length = len(BOUNDARY), 700, 256
    x = rng.standard_normal((b, n, 2)).astype(np.float32)
    got = np.asarray(sync.batch_slice_iq(jnp.asarray(x),
                                         jnp.asarray(BOUNDARY), length))
    want = np.stack([x[r, s:s + length] for r, s in enumerate(BOUNDARY)])
    np.testing.assert_array_equal(got, want)


def test_capture_windows_boundary_starts():
    cap = np.arange(700 * 2, dtype=np.float32).reshape(700, 2)
    got = np.asarray(capture_windows(jnp.asarray(cap),
                                     jnp.asarray(BOUNDARY), 256))
    np.testing.assert_array_equal(
        got, np.stack([cap[s:s + 256] for s in BOUNDARY]))


def test_capture_windows_mimo_boundary_starts():
    cap = np.arange(2 * 700 * 2, dtype=np.float32).reshape(2, 700, 2)
    got = np.asarray(capture_windows_mimo(jnp.asarray(cap),
                                          jnp.asarray(BOUNDARY), 256))
    np.testing.assert_array_equal(
        got, np.stack([cap[:, s:s + 256] for s in BOUNDARY]))


OUT_OF_RANGE = np.array([-5, -1, 0, 444, 445, 600, 10_000], np.int32)


def test_window_starts_clamp_rule():
    got = np.asarray(sync.window_starts(jnp.asarray(OUT_OF_RANGE), 700, 256))
    np.testing.assert_array_equal(got, [0, 0, 0, 444, 444, 444, 444])


def test_batch_slice_iq_clamps_out_of_range_starts():
    b, n, length = len(OUT_OF_RANGE), 700, 256
    x = np.arange(b * n * 2, dtype=np.float32).reshape(b, n, 2)
    got = np.asarray(sync.batch_slice_iq(jnp.asarray(x),
                                         jnp.asarray(OUT_OF_RANGE), length))
    st = _np_clamp(OUT_OF_RANGE, n, length)
    np.testing.assert_array_equal(
        got, np.stack([x[r, s:s + length] for r, s in enumerate(st)]))


def test_capture_windows_clamps_out_of_range_starts():
    cap = np.arange(700 * 2, dtype=np.float32).reshape(700, 2)
    got = np.asarray(capture_windows(jnp.asarray(cap),
                                     jnp.asarray(OUT_OF_RANGE), 256))
    st = _np_clamp(OUT_OF_RANGE, 700, 256)
    np.testing.assert_array_equal(got, np.stack([cap[s:s + 256]
                                                 for s in st]))


def test_capture_windows_mimo_clamps_out_of_range_starts():
    cap = np.arange(2 * 700 * 2, dtype=np.float32).reshape(2, 700, 2)
    got = np.asarray(capture_windows_mimo(jnp.asarray(cap),
                                          jnp.asarray(OUT_OF_RANGE), 256))
    st = _np_clamp(OUT_OF_RANGE, 700, 256)
    np.testing.assert_array_equal(got, np.stack([cap[:, s:s + 256]
                                                 for s in st]))
