"""Mesh / sharding layer: sharded execution must be bitwise-consistent with
single-device execution (runs on the 8-virtual-device CPU backend configured
in conftest.py — the standard fake-multi-device harness, SURVEY.md section 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.models import lbl
from mwr_fast_forward_operators_and_lbls_tpu.parallel import mesh as mesh_mod
from mwr_fast_forward_operators_and_lbls_tpu.parallel import sharding as shard_mod


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return mesh_mod.make_mesh(jax.devices()[:8], spectral=2)


def test_mesh_axes(mesh8):
    assert dict(mesh8.shape) == {"data": 4, "spectral": 2}
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(jax.devices()[:8], data=3, spectral=2)


def test_forward_sharded_matches_single(mesh8):
    profiles = lbl.demo_batch(8, n_levels=60)
    cfg = lbl.LBLConfig(model="R17", elevations_deg=(90.0, 14.4))
    ref = lbl.forward_batch(profiles, cfg)
    out = shard_mod.forward_sharded(profiles, mesh8, cfg)
    np.testing.assert_allclose(np.asarray(out["tb"]), np.asarray(ref["tb"]),
                               rtol=0, atol=1e-4)


def test_forward_sharded_pads_odd_batch(mesh8):
    profiles = lbl.demo_batch(5, n_levels=40)
    cfg = lbl.LBLConfig(elevations_deg=(90.0,))
    out = shard_mod.forward_sharded(profiles, mesh8, cfg)
    assert out["tb"].shape[0] == 5


@pytest.mark.slow
def test_spectral_sharded_matches_dense(mesh8):
    profiles = lbl.demo_batch(2, n_levels=40)
    f = jnp.linspace(51.0, 59.0, 24)  # not divisible by 2 after pad check
    tb_sharded = shard_mod.forward_spectral_sharded(
        profiles, f, mesh8, elevations_deg=(90.0,))
    # dense single-device reference
    ref = jax.vmap(
        lambda z, p, t, r, w: lbl.forward_single(z, p, t, r, w, f, 90.0)["tb"]
    )(profiles["z"], profiles["p"], profiles["t"], profiles["rho"], profiles["lwc"])
    np.testing.assert_allclose(np.asarray(tb_sharded[:, 0]), np.asarray(ref),
                               rtol=0, atol=1e-4)


def test_srf_convolve_normalizes():
    tb = jnp.stack([jnp.full((6,), 100.0), jnp.linspace(0, 5, 6)])
    w = jnp.array([[1.0, 1, 1, 0, 0, 0], [0, 0, 0, 2, 2, 2]])
    out = shard_mod.srf_convolve(tb, w)
    np.testing.assert_allclose(np.asarray(out[0]), [100.0, 100.0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out[1, 1]), np.mean([3.0, 4.0, 5.0]),
                               atol=1e-5)


@pytest.mark.slow
def test_graft_entry_dryrun():
    import __graft_entry__ as g
    fn, args = g.entry()
    tb = jax.jit(fn)(*args)
    assert tb.shape == (8, 10, 14)
    g.dryrun_multichip(8)


def test_scaling_harness(mesh8):
    from mwr_fast_forward_operators_and_lbls_tpu.parallel import scaling
    cfg = lbl.LBLConfig(model="R98", elevations_deg=(90.0,), outputs=("tb",))
    rows = scaling.measure(per_device_batch=2, n_levels=24,
                           device_counts=(1, 2), config=cfg, iters=3)
    assert [r["n_devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["spectra_per_s"] > 0 for r in rows)


def test_sharded_forward_compiles_once_per_mesh_and_config(mesh8):
    """Repeated sharded calls reuse one jitted program instead of tracing
    the forward again on every call."""
    cfg = lbl.LBLConfig(model="R98", elevations_deg=(90.0,), outputs=("tb",))
    placed = shard_mod.shard_profiles(lbl.demo_batch(8, n_levels=24), mesh8)
    shard_mod.forward_sharded_placed(placed, mesh8, cfg)
    fwd = shard_mod._sharded_forward(mesh8, cfg)
    n = fwd._cache_size()
    shard_mod.forward_sharded_placed(placed, mesh8, cfg)
    assert shard_mod._sharded_forward(mesh8, cfg) is fwd
    assert fwd._cache_size() == n == 1
