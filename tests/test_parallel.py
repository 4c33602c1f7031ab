"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import __graft_entry__ as ge
from ieee80211_phy.ops import sync
from ieee80211_phy.parallel import make_phy_mesh, sharded_frontend


def test_entry_compiles_and_decodes():
    fn, (x, t0) = ge.entry()
    out = jax.jit(fn)(jnp.asarray(x), jnp.asarray(t0))
    jax.block_until_ready(out)
    assert bool(np.asarray(out["lsig_ok"]).all())


def test_dryrun_multichip_8():
    ge.dryrun_multichip(8)


def test_dryrun_multichip_2():
    ge.dryrun_multichip(2)


def test_halo_frontend_matches_unsharded():
    """Time-sharded correlator with halo == single-device correlator."""
    rng = np.random.default_rng(0)
    from ieee80211_phy.utils import c2r
    x = (rng.standard_normal((4, 2048)) + 1j * rng.standard_normal((4, 2048))
         ).astype(np.complex64)
    mesh = make_phy_mesh(8, sp=4)
    ac_sharded = np.asarray(sharded_frontend(mesh, jnp.asarray(c2r(x))))
    ac_ref = np.asarray(sync.stf_autocorr(jnp.asarray(x)))
    n = ac_ref.shape[1]
    np.testing.assert_allclose(ac_sharded[:, :n], ac_ref, atol=1e-4)
    assert np.all(ac_sharded[:, n:] == 0)


def test_scaling_harness_smoke():
    """Sharded RX runs at 1/2/4 virtual devices and decodes correctly."""
    from ieee80211_phy.perf.scaling import measure_scaling
    rates = measure_scaling(device_counts=[1, 2], batch_per_device=8,
                            iters=1)
    assert set(rates) == {1, 2}
    assert all(r > 0 for r in rates.values())
