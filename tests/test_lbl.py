"""End-to-end LBL forward-operator tests (the reference's cross-model
consistency protocol, SURVEY.md section 4, promoted to assertions)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.models import lbl


@pytest.fixture(scope="module")
def small_cfg():
    return lbl.LBLConfig(elevations_deg=(90.0, 30.0, 4.2))


@pytest.fixture(scope="module")
def out(demo_batch, small_cfg):
    return lbl.forward_batch(demo_batch, small_cfg)


def test_shapes(out, demo_batch, small_cfg):
    B, L = demo_batch["z"].shape
    E, F = 3, 14
    assert out["tb"].shape == (B, E, F)
    assert out["tau_total"].shape == (B, E, F)
    assert out["trans_level"].shape == (B, E, F, L)
    assert np.all(np.isfinite(np.asarray(out["tb"])))


def test_tb_physical_range(out):
    tb = np.asarray(out["tb"])
    assert tb.min() > 2.7
    assert tb.max() < 330.0


def test_opaque_channels_near_surface_temperature(out, demo_batch):
    # 56.66-58.0 GHz: tau >> 1 -> TB within a few K of the lowest-level T.
    tb = np.asarray(out["tb"])[:, 0, -3:]  # zenith, last 3 channels
    t_sfc = np.asarray(demo_batch["t"])[:, 0]
    assert np.all(np.abs(tb - t_sfc[:, None]) < 8.0)


def test_tb_increases_toward_horizon_in_kband(out):
    # Longer slant path -> more emission in semi-transparent K-band channels.
    tb = np.asarray(out["tb"])
    assert np.all(tb[:, 1, :7] > tb[:, 0, :7])   # 30 deg > zenith
    assert np.all(tb[:, 2, :7] > tb[:, 1, :7])   # 4.2 deg > 30 deg


def test_tau_increases_toward_horizon(out):
    tau = np.asarray(out["tau_total"])
    assert np.all(np.diff(tau, axis=1) > 0)


def test_cloud_raises_window_tb(demo_batch, small_cfg):
    clear = dict(demo_batch)
    clear["lwc"] = jnp.zeros_like(demo_batch["lwc"])
    tb_clear = np.asarray(lbl.forward_batch(clear, small_cfg)["tb"])
    tb_cloud = np.asarray(lbl.forward_batch(demo_batch, small_cfg)["tb"])
    # 31.4 GHz zenith: cloud water adds several K.
    assert np.all(tb_cloud[:, 0, 6] > tb_clear[:, 0, 6] + 1.0)
    # Opaque 58 GHz barely changes.
    assert np.all(np.abs(tb_cloud[:, 0, 13] - tb_clear[:, 0, 13]) < 0.5)


def test_models_agree_within_a_kelvin_range(demo_batch, small_cfg):
    tbs = lbl.forward_all_models(demo_batch, small_cfg)
    r24 = np.asarray(tbs["R24"])
    for name, tb in tbs.items():
        diff = np.abs(np.asarray(tb) - r24)
        # Same Rosenkranz family: < 3 K at zenith (the reference's
        # model-vs-LBL bias envelope, BASELINE.md); slant paths amplify the
        # continuum deltas by the ~11x airmass at 4.2 deg elevation.
        assert diff[:, 0].max() < 5.0, f"{name} zenith dev {diff[:, 0].max():.2f} K"
        assert diff.max() < 8.0, f"{name} slant dev {diff.max():.2f} K"
    assert np.abs(np.asarray(tbs["R98"]) - r24).max() > 0.01


def test_forward_single_matches_batch(demo_batch, small_cfg):
    # a K-band / window / opaque channel subset: the single-profile compile
    # at all 14 channels added ~8 s for the same consistency claim
    sub = (22.24, 31.4, 58.0)
    idx = [list(small_cfg.freqs_ghz).index(f) for f in sub]
    p0 = {k: v[0] for k, v in demo_batch.items()}
    single = lbl.forward_single(
        p0["z"], p0["p"], p0["t"], p0["rho"], p0["lwc"],
        jnp.asarray(sub), 90.0, small_cfg.model,
    )
    batch = lbl.forward_batch(demo_batch, small_cfg)
    np.testing.assert_allclose(
        np.asarray(single["tb"]), np.asarray(batch["tb"])[0, 0, idx],
        rtol=0, atol=2e-3
    )


def test_flip_profile_roundtrip(demo_batch):
    flipped = lbl.flip_profile(demo_batch)
    back = lbl.flip_profile(flipped)
    for k in demo_batch:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(demo_batch[k]))


def test_forward_batch_matches_forward_single(demo_batch, small_cfg):
    """The batched forward agrees with the per-(profile, elevation)
    `forward_single` on every output."""
    got = lbl.forward_batch(demo_batch, small_cfg)
    assert set(got) == set(small_cfg.outputs)
    p1 = {k: v[1] for k, v in demo_batch.items()}
    sub = (22.24, 31.4, 58.0)
    idx = [list(small_cfg.freqs_ghz).index(f) for f in sub]
    single = lbl.forward_single(p1["z"], p1["p"], p1["t"], p1["rho"],
                                p1["lwc"], jnp.asarray(sub), 4.2,
                                small_cfg.model)
    for k, v in single.items():
        np.testing.assert_allclose(np.asarray(v),
                                   np.asarray(got[k])[1, 2][idx],
                                   rtol=1e-5, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("model", ["R98", "R03", "R16", "R17", "R19",
                                   "R19SD", "R20", "R20SD", "R24"])
@pytest.mark.slow
def test_forward_batch_all_nine_models_match_forward_single(model):
    """Every member of the nine-model sweep (old_merge2nc.py:417-435) —
    including the qSD variants and the second-order-mixing releases — runs
    batched and agrees with `forward_single`."""
    batch = lbl.demo_batch(2, n_levels=64)
    elevs = (90.0, 4.2)
    cfg = lbl.LBLConfig(model=model, elevations_deg=elevs, outputs=("tb",))
    got = np.asarray(lbl.forward_batch(batch, cfg)["tb"])
    assert np.isfinite(got).all()
    f = jnp.asarray(cfg.freqs_ghz)
    for b in range(2):
        for e, el in enumerate(elevs):
            one = lbl.forward_single(*(batch[k][b] for k in
                                       ("z", "p", "t", "rho", "lwc")),
                                     f, el, model)
            np.testing.assert_allclose(got[b, e], np.asarray(one["tb"]),
                                       rtol=0, atol=2e-3)


@pytest.mark.slow
def test_forward_batch_rows_are_independent(small_cfg):
    """An odd batch gives the same rows as the same profiles one at a
    time (nothing in the batch layout mixes profiles)."""
    cfg = lbl.LBLConfig(model=small_cfg.model,
                        elevations_deg=small_cfg.elevations_deg,
                        outputs=("tb",))
    batch = lbl.demo_batch(3, n_levels=64)
    got = lbl.forward_batch(batch, cfg)
    assert got["tb"].shape == (3, 3, 14)
    for i in range(3):
        one = lbl.forward_batch({k: v[i:i + 1] for k, v in batch.items()},
                                cfg)
        np.testing.assert_allclose(np.asarray(got["tb"])[i:i + 1],
                                   np.asarray(one["tb"]), rtol=0, atol=2e-3)


def test_fp32_pipeline_within_baseline_tolerance(demo_batch):
    """BASELINE.md target: < 0.05 K TB agreement vs the reference LBL.

    pyrtlib cannot be installed in this environment, so the controlled
    proxy is the same spectroscopy + RTE evaluated in float64: the fp32
    production path must stay within half the 0.05 K budget of the
    float64 truth, leaving the other half for genuine model differences.
    """
    import jax

    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl

    # zenith + mid + the lowest slant cover the airmass range; the full
    # 10-elevation sweep triples the float64 XLA forward for no extra claim
    elevs = (90.0, 30.0, 4.2)
    cfg32 = lbl.LBLConfig(model="R24", outputs=("tb",), elevations_deg=elevs)
    tb32 = np.asarray(lbl.forward_batch(demo_batch, cfg32)["tb"])
    with jax.enable_x64(True):
        cfg64 = lbl.LBLConfig(model="R24", dtype="float64", outputs=("tb",),
                              elevations_deg=elevs)
        tb64 = np.asarray(lbl.forward_batch(demo_batch, cfg64)["tb"])
    err = np.abs(tb32 - tb64.astype(np.float64)).max()
    assert err < 0.025, f"fp32 pipeline drifts {err:.4f} K from float64"


@pytest.mark.slow
def test_forward_batch_include_o3_matches_forward_single():
    """The optional ozone term (ARMS-gb parity, ARMS_gb_processing.py:94-99)
    runs batched as in `forward_single` with the same ozone profile."""
    from mwr_fast_forward_operators_and_lbls_tpu.constants import afgl

    batch = lbl.demo_batch(2, n_levels=64)
    clim = afgl.CLIMATOLOGIES["midlatitude_summer"]
    batch["o3_ppmv"] = jnp.asarray(np.interp(
        np.asarray(batch["z"]) / 1000.0, clim["z_km"], clim["o3_ppmv"]),
        jnp.float32)
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 4.2),
                        outputs=("tb",), include_o3=True)
    got = np.asarray(lbl.forward_batch(batch, cfg)["tb"])
    one = lbl.forward_single(*(batch[k][1] for k in
                               ("z", "p", "t", "rho", "lwc")),
                             jnp.asarray(cfg.freqs_ghz), 4.2, "R24",
                             o3_ppmv=batch["o3_ppmv"][1])
    np.testing.assert_allclose(got[1, 1], np.asarray(one["tb"]),
                               rtol=0, atol=2e-3)
    # and O3 must actually change the TB vs the no-O3 configuration
    no_o3 = np.asarray(lbl.forward_batch(
        batch, lbl.LBLConfig(model="R24", elevations_deg=(90.0, 4.2),
                             outputs=("tb",)))["tb"])
    assert np.abs(got - no_o3).max() > 1e-5
