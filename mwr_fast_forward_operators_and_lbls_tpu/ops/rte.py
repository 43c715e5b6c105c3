"""Non-scattering microwave radiative transfer along a slant path.

The physics the reference obtains from PyRTlib's downwelling RTE
(`rte.satellite = False`, /root/reference/python_src/proc/
PyRTlib_processing.py:126): thermal emission of each layer, attenuated by the
opacity between the layer and the ground-based radiometer, plus the cosmic
background attenuated by the whole column.  Planck radiance throughout
(converted to Planck-equivalent brightness temperature at the end), with a
linear-in-tau source function inside each layer (Schroeder & Westwater 1991).

Everything is expressed per frequency so the same functions serve the
14-channel HATPRO forward operator and the 50k-point monochromatic grid; the
frequency axis is the leading axis of `alpha`.
"""

import jax
import jax.numpy as jnp

from ..constants import physics as phys


def planck_tb(t_k, f_ghz):
    """Planck radiance expressed in temperature units [K].

    B*(T) = (h f / k) / (exp(h f / k T) - 1).  Inverts with `inverse_planck_tb`.
    """
    x = phys.HK_GHZ * f_ghz
    return x / jnp.expm1(x / t_k)


def inverse_planck_tb(b, f_ghz):
    """Invert `planck_tb`: brightness temperature [K] from radiance-in-K."""
    x = phys.HK_GHZ * f_ghz
    return x / jnp.log1p(x / b)


def layer_opacities(alpha, ds_km):
    """Trapezoidal layer opacities [nepers] from level absorption.

    Args:
      alpha: (..., L) absorption [Np/km] at the L levels (ground -> top).
      ds_km: (..., L-1) slant path through each layer [km].
    Returns:
      (..., L-1) opacity per layer.
    """
    return 0.5 * (alpha[..., :-1] + alpha[..., 1:]) * ds_km


def _emission_factors(dtau):
    """Linear-in-tau layer emission weights (g_bot, g_top).

    For a layer of opacity d with source B varying linearly from B_bot to
    B_top (tau measured from the layer bottom), the emission reaching the
    layer bottom is  g_bot*B_bot + g_top*B_top  with
        g_bot = 1 - e^-d - g_top,   g_top = (1 - (1+d) e^-d) / d.
    A second-order Taylor series covers d -> 0.
    """
    # The exact numerator 1-(1+d)e^-d ~ d^2/2 cancels catastrophically in
    # float32 below d ~ 0.03; a 3-term Taylor series covers that range to
    # ~1e-7 absolute (next term d^4/30).  In float64 the cancellation is
    # benign down to ~2e-4, where the same series is exact to round-off —
    # keeping the float64 path at ~1e-13 so the analytic golden anchors
    # (tests/test_golden.py) hold without tolerance windows.
    small = dtau < (2e-4 if dtau.dtype == jnp.float64 else 0.03)
    d = jnp.where(small, 1.0, dtau)  # avoid 0/0 in the untaken branch
    em = jnp.exp(-d)
    g_top_exact = (1.0 - (1.0 + d) * em) / d
    g_top_series = dtau * (0.5 - dtau / 3.0 + dtau * dtau / 8.0)
    g_top = jnp.where(small, g_top_series, g_top_exact)
    # 1 - e^-d, series-protected below the same threshold so the single exp
    # above is the only transcendental in this function.
    g_total_series = dtau * (1.0 - dtau * (0.5 - dtau / 6.0))
    g_total = jnp.where(small, g_total_series, 1.0 - em)
    g_bot = g_total - g_top
    return g_bot, g_top


@jax.named_scope("rte")
def downwelling_tb(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Downwelling brightness temperature at the observer (ground) level.

    Args:
      alpha: (F, L) absorption [Np/km] at levels, ground -> top.
      ds_km: (L-1,) or (F, L-1) slant path lengths [km].
      t_k:   (L,) level temperatures [K].
      f_ghz: (F,) frequencies [GHz].
      t_cosmic: cosmic background temperature [K].

    Returns:
      dict with
        tb:        (F,) Planck-equivalent brightness temperature [K]
        tau_total: (F,) total slant opacity [nepers]
        trans_level: (F, L) transmittance ground -> each level
        t_mr:      (F,) mean radiating temperature [K]
    """
    dtau = layer_opacities(alpha, ds_km)  # (F, L-1)
    return downwelling_tb_from_dtau(dtau, t_k, f_ghz, t_cosmic)


@jax.named_scope("rte")
def downwelling_tb_from_dtau(dtau, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Downwelling TB given per-layer slant opacities directly.

    Shared RTE core for the LBL (which derives `dtau` from level absorption)
    and the fast predictor-regression operator (which predicts `dtau`
    directly, the RTTOV-gb formulation the reference consumes via text
    protocol, /root/reference/python_src/proc/RTTOV_gb_processing.py:167-305).

    Args:
      dtau: (F, L-1) layer opacities [nepers], ground -> top.
      t_k:  (L,) level temperatures [K].
      f_ghz: (F,) frequencies [GHz].
    """
    f = f_ghz[:, None] if jnp.ndim(f_ghz) else f_ghz
    # Cumulative opacity from the ground to the *bottom* of each layer.
    tau_below = jnp.cumsum(dtau, axis=-1) - dtau
    tau_total = tau_below[..., -1] + dtau[..., -1]
    trans_below = jnp.exp(-tau_below)           # (F, L-1)
    trans_level = jnp.exp(
        -jnp.concatenate([jnp.zeros_like(dtau[..., :1]), jnp.cumsum(dtau, axis=-1)], axis=-1)
    )                                            # (F, L)

    b = planck_tb(t_k, f)                        # (F, L) source at levels
    g_bot, g_top = _emission_factors(dtau)       # (F, L-1)
    layer_emission = g_bot * b[..., :-1] + g_top * b[..., 1:]

    atm = jnp.sum(layer_emission * trans_below, axis=-1)
    cosmic = planck_tb(t_cosmic, f_ghz) * jnp.exp(-tau_total)
    radiance = atm + cosmic
    tb = inverse_planck_tb(radiance, f_ghz)

    # Mean radiating temperature: Tmr = atm_radiance / (1 - e^-tau), in Tb units.
    t_mr = inverse_planck_tb(
        atm / jnp.maximum(-jnp.expm1(-tau_total), 1e-10), f_ghz
    )
    return {"tb": tb, "tau_total": tau_total, "trans_level": trans_level, "t_mr": t_mr}


def _planck_dT(t_k, f):
    """d planck_tb / dT = (x/T)^2 e^{x/T} / expm1(x/T)^2."""
    x = phys.HK_GHZ * f
    u = x / t_k
    em = jnp.expm1(u)
    return u * u * (em + 1.0) / (em * em)


def _inverse_planck_dB(b, f):
    """d inverse_planck_tb / dB = x^2 / (b (b+x) log1p(x/b)^2)."""
    x = phys.HK_GHZ * f
    lg = jnp.log1p(x / b)
    return x * x / (b * (b + x) * lg * lg)


def _emission_factor_derivs(dtau):
    """(dg_bot/dd, dg_top/dd) for `_emission_factors`.

    Exact: g_top' = e^-d - g_top/d,  g_bot' = g_top/d; series-protected in
    the same small-d range as the forward (the exact forms hit 0/0 and
    catastrophic cancellation as d -> 0).
    """
    small = dtau < (2e-4 if dtau.dtype == jnp.float64 else 0.03)
    d = jnp.where(small, 1.0, dtau)
    em = jnp.exp(-d)
    g_top_over_d = jnp.where(
        small,
        0.5 - dtau / 3.0 + dtau * dtau / 8.0,
        (1.0 - (1.0 + d) * em) / (d * d))
    dg_top = jnp.where(
        small,
        0.5 - (2.0 / 3.0) * dtau + 0.375 * dtau * dtau,
        em - g_top_over_d)
    return g_top_over_d, dg_top  # = (dg_bot/dd, dg_top/dd)


def downwelling_tb_adjoint(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Hand-written adjoint of the downwelling RTE: exact dTB/d(alpha, t, ds)
    for every (batch, elevation, frequency) in one vectorized pass.

    The replacement for RTTOV-gb's hand-coded Fortran K/adjoint
    (the reference parses its K-matrix from text output,
    RTTOV_gb_processing.py:287-301).  Autodiff through the cumulative-
    opacity scan materializes large reverse-mode intermediates; the closed
    form needs only elementwise algebra plus one prefix sum and one suffix
    sum along layers:

        W_k = dR/d(dtau_k) = E'_k T_k - S_k - C0 Ttot,
        S_k = sum_{j>k} E_j T_j     (suffix sum: downstream layers lose
                                     transmission when layer k thickens)

    with E_k = g_bot B_k + g_top B_{k+1}, T_k the ground-to-layer-bottom
    transmittance and E'_k the emission-factor derivative.  Then
        dTB/dalpha_l = dtb/dR * (W ds)/2 gathered from layers l-1, l
        dTB/dt_l     = dtb/dR * (g_bot_l T_l + g_top_{l-1} T_{l-1}) B'(t_l)
        dTB/dds_k    = dtb/dR * W_k * alpha_mid_k.

    Args:
      alpha: (B, F, L) level absorption [Np/km], ground -> top.
      ds_km: (B, E, L-1) slant path lengths [km].
      t_k:   (B, L) level temperatures [K].
      f_ghz: (F,).
    Returns:
      (g_alpha (B,E,F,L), g_t (B,E,F,L) Planck path only, g_ds (B,E,F,L-1)).
    """
    alpha_mid = 0.5 * (alpha[..., :-1] + alpha[..., 1:])  # (B,F,K)
    g_mid, g_t, g_ds = downwelling_tb_adjoint_mid(
        alpha_mid, ds_km, t_k, f_ghz, t_cosmic)
    # spread the layer adjoint onto the two bounding levels
    half = 0.5 * g_mid
    zeros = jnp.zeros_like(half[..., :1])
    g_alpha = (jnp.concatenate([half, zeros], -1)
               + jnp.concatenate([zeros, half], -1))
    return g_alpha, g_t, g_ds


def downwelling_tb_adjoint_mid(alpha_mid, ds_km, t_k, f_ghz,
                               t_cosmic=phys.T_COSMIC):
    """`downwelling_tb_adjoint` for LAYER-MEAN extinction inputs.

    The fast operator predicts alpha directly at layer midpoints
    (models/fast.py::predict_extinction), so its closed-form K-matrix
    chains through dTB/d(alpha_mid) without the level-spreading step.
    Same algebra as `downwelling_tb_adjoint` (see that docstring).

    Args:
      alpha_mid: (B, F, K=L-1) layer-mean extinction [Np/km].
      ds_km: (B, E, K) slant path lengths [km].
      t_k:   (B, L) level temperatures [K].
      f_ghz: (F,).
    Returns:
      (g_alpha_mid (B,E,F,K), g_t (B,E,F,L) Planck path only,
       g_ds (B,E,F,K)).
    """
    f = f_ghz[None, None, :, None]                        # (1,1,F,1)
    dtau = alpha_mid[:, None] * ds_km[:, :, None, :]      # (B,E,F,K)
    ctau = jnp.cumsum(dtau, axis=-1)
    t_below = jnp.exp(-(ctau - dtau))                     # (B,E,F,K)
    trans_total = jnp.exp(-ctau[..., -1:])                # (B,E,F,1)

    b = planck_tb(t_k[:, None, None, :], f)               # (B,1,F,L)
    g_bot, g_top = _emission_factors(dtau)
    e_k = g_bot * b[..., :-1] + g_top * b[..., 1:]        # (B,E,F,K)
    et = e_k * t_below
    atm = jnp.sum(et, axis=-1, keepdims=True)
    suffix = atm - jnp.cumsum(et, axis=-1)                # S_k
    cosmic0 = planck_tb(t_cosmic, f)
    radiance = atm + cosmic0 * trans_total
    dtb_dr = _inverse_planck_dB(radiance, f)              # (B,E,F,1)

    dg_bot, dg_top = _emission_factor_derivs(dtau)
    e_prime = dg_bot * b[..., :-1] + dg_top * b[..., 1:]
    w = e_prime * t_below - suffix - cosmic0 * trans_total  # (B,E,F,K)

    g_alpha_mid = dtb_dr * w * ds_km[:, :, None, :]
    zeros = jnp.zeros_like(w[..., :1])
    bprime = _planck_dT(t_k[:, None, None, :], f)         # (B,1,F,L)
    gbt = g_bot * t_below
    gtt = g_top * t_below
    g_t = dtb_dr * (jnp.concatenate([gbt, zeros], -1)
                    + jnp.concatenate([zeros, gtt], -1)) * bprime
    g_ds = dtb_dr * w * alpha_mid[:, None]
    return g_alpha_mid, g_t, g_ds


def upwelling_tb(alpha, ds_km, t_k, f_ghz, t_surface=None, emissivity=1.0,
                 t_cosmic=phys.T_COSMIC):
    """Upwelling TB at the top of the column (satellite view), for parity with
    PyRTlib's `satellite=True` mode.  Surface treated as specular with the
    given emissivity; t_surface defaults to the lowest level temperature."""
    dtau = layer_opacities(alpha, ds_km)
    tau_total = jnp.sum(dtau, axis=-1)
    # Opacity from each layer *top* to the column top.
    tau_above = jnp.flip(jnp.cumsum(jnp.flip(dtau, -1), -1), -1) - dtau
    trans_above = jnp.exp(-tau_above)

    f = f_ghz[:, None] if jnp.ndim(f_ghz) else f_ghz
    b = planck_tb(t_k, f)
    # Looking down: emission weights mirror (top boundary takes g_bot role).
    g_bot, g_top = _emission_factors(dtau)
    layer_emission = g_bot * b[..., 1:] + g_top * b[..., :-1]
    atm_up = jnp.sum(layer_emission * trans_above, axis=-1)

    ts = t_k[..., 0] if t_surface is None else t_surface
    down = downwelling_tb(alpha, ds_km, t_k, f_ghz, t_cosmic)
    surface = (
        emissivity * planck_tb(ts, f_ghz)
        + (1.0 - emissivity) * planck_tb(down["tb"], f_ghz)
    ) * jnp.exp(-tau_total)
    return {"tb": inverse_planck_tb(atm_up + surface, f_ghz), "tau_total": tau_total}
