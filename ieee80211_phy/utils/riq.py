"""Real<->complex boundary helpers.

Framework convention: every jit/device boundary carries float32 arrays with
a trailing I/Q axis of size 2, and complex math happens *inside* XLA
programs via jax.lax.complex. Real pairs also let the int8 capture ingest
and the flat per-row window slices (ops/sync.batch_slice_iq) share one
layout.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def c2r(x) -> np.ndarray:
    """Host-side: complex array -> float32 [..., 2]."""
    x = np.asarray(x)
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def r2c(x2: jnp.ndarray) -> jnp.ndarray:
    """In-graph: float [..., 2] -> complex."""
    return jax.lax.complex(x2[..., 0], x2[..., 1])


def r_of(x: jnp.ndarray) -> jnp.ndarray:
    """In-graph: complex -> float [..., 2] (for returning IQ data)."""
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)
