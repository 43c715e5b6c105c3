"""RTE integration tests: analytic limits of the downwelling equation."""

import jax
import jax.numpy as jnp
import numpy as np

from mwr_fast_forward_operators_and_lbls_tpu.constants import physics as phys
from mwr_fast_forward_operators_and_lbls_tpu.ops import rte


def test_transparent_atmosphere_gives_cosmic_background():
    L, F = 50, 3
    alpha = jnp.zeros((F, L))
    ds = jnp.full((L - 1,), 0.5)
    t = jnp.full((L,), 250.0)
    f = jnp.asarray([22.24, 31.4, 58.0])
    out = rte.downwelling_tb(alpha, ds, t, f)
    np.testing.assert_allclose(np.asarray(out["tb"]), phys.T_COSMIC, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out["tau_total"]), 0.0, atol=1e-8)


def test_opaque_isothermal_atmosphere_gives_air_temperature():
    L, F = 50, 2
    t_iso = 275.0
    alpha = jnp.full((F, L), 5.0)  # Np/km, tau_total >> 1
    ds = jnp.full((L - 1,), 1.0)
    t = jnp.full((L,), t_iso)
    f = jnp.asarray([22.24, 58.0])
    out = rte.downwelling_tb(alpha, ds, t, f)
    np.testing.assert_allclose(np.asarray(out["tb"]), t_iso, atol=0.01)


def test_planck_inversion_roundtrip():
    f = jnp.asarray([22.24, 58.0, 183.3])
    for t in [2.7, 100.0, 300.0]:
        b = rte.planck_tb(t, f)
        np.testing.assert_allclose(np.asarray(rte.inverse_planck_tb(b, f)), t, rtol=1e-6)


def test_emission_factors_match_float64_truth():
    d32 = jnp.asarray(np.logspace(-7, 0.7, 200), dtype=jnp.float32)
    g_bot, g_top = rte._emission_factors(d32)
    d = np.logspace(-7, 0.7, 200)
    em = np.exp(-d)
    g_top_true = (1.0 - (1.0 + d) * em) / d
    g_bot_true = (1.0 - em) - g_top_true
    np.testing.assert_allclose(np.asarray(g_top), g_top_true, atol=2e-6)
    np.testing.assert_allclose(np.asarray(g_bot), g_bot_true, atol=2e-6)


def test_emission_factors_sum_to_total_absorption():
    d = jnp.asarray([1e-6, 1e-3, 0.1, 1.0, 5.0])
    g_bot, g_top = rte._emission_factors(d)
    np.testing.assert_allclose(
        np.asarray(g_bot + g_top), -np.expm1(-np.asarray(d)), rtol=1e-5
    )


def test_trans_level_monotone_decreasing():
    L, F = 30, 2
    alpha = jnp.full((F, L), 0.1)
    ds = jnp.full((L - 1,), 1.0)
    t = jnp.linspace(288.0, 220.0, L)[None, :].repeat(F, 0)[0]
    out = rte.downwelling_tb(alpha, ds, t, jnp.asarray([22.0, 31.0]))
    tr = np.asarray(out["trans_level"])
    assert tr.shape == (F, L)
    np.testing.assert_allclose(tr[:, 0], 1.0)
    assert np.all(np.diff(tr, axis=-1) < 0)


def test_mean_radiating_temperature_bounded_by_profile():
    L = 40
    alpha = jnp.full((1, L), 0.05)
    ds = jnp.full((L - 1,), 0.5)
    t = jnp.linspace(290.0, 230.0, L)
    out = rte.downwelling_tb(alpha, ds, t, jnp.asarray([31.4]))
    tmr = float(out["t_mr"][0])
    assert 230.0 < tmr < 290.0


def test_upwelling_opaque_matches_downwelling_limit():
    L = 50
    t_iso = 260.0
    alpha = jnp.full((1, L), 5.0)
    ds = jnp.full((L - 1,), 1.0)
    t = jnp.full((L,), t_iso)
    up = rte.upwelling_tb(alpha, ds, t, jnp.asarray([50.0]))
    np.testing.assert_allclose(np.asarray(up["tb"]), t_iso, atol=0.05)


def test_spectral_rte_matches_channel_rte():
    """The two XLA formulations of the downwelling RTE that the framework
    keeps — the per-profile `rte.downwelling_tb` (channel forward) and the
    frequency-minor batch RTE of the spectral path — agree on the same
    absorption, including an opaque channel."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from mwr_fast_forward_operators_and_lbls_tpu.models import spectral
    from mwr_fast_forward_operators_and_lbls_tpu.ops import rte

    rng = np.random.default_rng(0)
    nf, l, b = 5, 60, 4
    alpha = np.abs(rng.normal(0.05, 0.05, (b, l, nf))).astype("f4")
    alpha[..., -1] *= 40.0
    alpha = jnp.asarray(alpha)
    ds = jnp.asarray(np.abs(rng.normal(0.5, 0.1, (b, l - 1))).astype("f4"))
    t = jnp.asarray((250 + 40 * rng.random((b, l))).astype("f4"))
    f = jnp.asarray(np.linspace(20.0, 60.0, nf), jnp.float32)
    tb, tau = spectral._rte_freq_minor(alpha, ds, t, f)
    ref = jax.vmap(lambda a, d, tt: rte.downwelling_tb(a.T, d, tt, f))(
        alpha, ds, t)
    np.testing.assert_allclose(np.asarray(tb), np.asarray(ref["tb"]),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(tau), np.asarray(ref["tau_total"]),
                               rtol=1e-5)


def test_downwelling_adjoint_matches_autodiff():
    """The closed-form RTE adjoint (suffix-sum form, the native
    replacement for RTTOV-gb's hand-written Fortran K code) must equal
    reverse-mode AD through the production RTE to fp32 round-off."""
    rng = np.random.default_rng(3)
    b_n, e_n, f_n, l_n = 2, 3, 4, 24
    alpha = jnp.asarray(np.abs(rng.normal(0.05, 0.02, (b_n, f_n, l_n))))
    ds = jnp.asarray(np.abs(rng.normal(0.4, 0.1, (b_n, e_n, l_n - 1))))
    t = jnp.asarray(rng.normal(260.0, 20.0, (b_n, l_n)))
    f = jnp.asarray([22.24, 31.4, 54.94, 58.0])

    g_alpha, g_t, g_ds = rte.downwelling_tb_adjoint(alpha, ds, t, f)

    def tb_sum(a_befl, t_befl, ds_befl):
        def one(a_l, t_l, ds_l, fi):
            return rte.downwelling_tb(a_l[None], ds_l, t_l, fi[None])["tb"][0]
        tb = jax.vmap(jax.vmap(jax.vmap(one, (0, 0, 0, 0)),
                               (0, 0, 0, None)), (0, 0, 0, None))(
            a_befl, t_befl, ds_befl, f)
        return jnp.sum(tb)

    a_b = jnp.broadcast_to(alpha[:, None], (b_n, e_n, f_n, l_n))
    t_b = jnp.broadcast_to(t[:, None, None], (b_n, e_n, f_n, l_n))
    d_b = jnp.broadcast_to(ds[:, :, None], (b_n, e_n, f_n, l_n - 1))
    r_alpha, r_t, r_ds = jax.grad(tb_sum, argnums=(0, 1, 2))(a_b, t_b, d_b)

    np.testing.assert_allclose(np.asarray(g_alpha), np.asarray(r_alpha),
                               rtol=5e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(r_t),
                               rtol=5e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(g_ds), np.asarray(r_ds),
                               rtol=5e-6, atol=1e-9)
