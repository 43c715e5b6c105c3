"""High-res monochromatic forward tests (BASELINE config 4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.models import lbl, spectral


@pytest.fixture(scope="module")
def profiles():
    return lbl.demo_batch(3, n_levels=48)


def test_spectral_matches_channel_forward(profiles):
    """Evaluating the monochromatic path AT the channel centers must agree
    with the channel forward operator."""
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 14.4),
                        outputs=("tb", "tau_total"))
    ref = lbl.forward_batch(profiles, cfg)
    f = jnp.asarray(cfg.freqs_ghz)
    got = spectral.forward_spectral(profiles, f, (90.0, 14.4), "R24")
    np.testing.assert_allclose(np.asarray(got["tb"]), np.asarray(ref["tb"]),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(np.asarray(got["tau_total"]),
                               np.asarray(ref["tau_total"]),
                               rtol=1e-3, atol=5e-3)


@pytest.mark.slow
def test_spectral_chunking_is_seamless(profiles):
    f = jnp.linspace(22.0, 32.0, 300)
    a = spectral.forward_spectral(profiles, f, (90.0,), "R98", freq_chunk=128)
    b = spectral.forward_spectral(profiles, f, (90.0,), "R98", freq_chunk=4096)
    assert a["tb"].shape == (3, 1, 300)
    np.testing.assert_allclose(np.asarray(a["tb"]), np.asarray(b["tb"]),
                               rtol=0, atol=1e-4)


def test_spectrum_line_structure_and_srf(profiles):
    """ONE 512-point spectrum serves both checks (merged to share the
    forward_spectral compile): the 22.235 GHz water line and 60 GHz O2
    complex must appear, and the SRF convolution must reduce correctly."""
    f = jnp.linspace(20.0, 62.0, 512)
    out = spectral.forward_spectral(profiles, f, (90.0,), "R24")
    tau = np.asarray(out["tau_total"])[0, 0]
    fn = np.asarray(f)
    i22 = np.argmin(np.abs(fn - 22.235)); i26 = np.argmin(np.abs(fn - 26.0))
    assert tau[i22] > 1.2 * tau[i26]          # water-vapor line peak
    assert tau[np.argmin(np.abs(fn - 60.0))] > 10 * tau[i26]  # opaque O2 band

    w = jnp.ones((2, 512)) * jnp.array([[1.0], [0.0]])
    w = w.at[1, 60:68].set(1.0)
    tb_c = spectral.srf_convolve(out["tb"], w)
    assert tb_c.shape == (3, 1, 2)
    np.testing.assert_allclose(np.asarray(tb_c[..., 0]),
                               np.asarray(out["tb"].mean(-1)), rtol=1e-5)
