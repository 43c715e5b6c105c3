"""Water-vapor absorption coefficient (Rosenkranz line-by-line + continuum).

Native JAX implementation of the physics the reference obtains through
PyRTlib's `rte.execute()` (/root/reference/python_src/proc/
PyRTlib_processing.py:121-151).  Structure follows the published Rosenkranz
`abh2o` formulation: Van Vleck-Weisskopf resonances with Clough's 750-GHz
local-line cutoff, plus foreign/self continuum terms.

All inputs broadcast against each other; the line summation happens over an
internal trailing axis, so the op is usable pointwise for any batch layout
(frequencies x layers x profiles) under jit/vmap/pjit.
"""

import jax.numpy as jnp
import numpy as np

from ...constants.h2o_lines import H2O_MODELS, H2OModel

# Quadratic-speed-dependent Lorentzian via 16-node generalized Gauss-Laguerre
# (alpha = 1/2) quadrature.  The qSD profile is the Maxwell-Boltzmann speed
# average of Lorentzians with width Gamma(v) = G0 + G2*((v/vp)^2 - 3/2):
#   pi*L(df) = Re <1/(C + G2*u^2)>,  C = G0 - 1.5*G2 + i*df,
# and with x = u^2 that average is exactly (2/sqrt(pi)) * sum_i w_i/(C+G2*x_i)
# on the alpha=1/2 Laguerre nodes.  16 nodes reproduce the profile to
# ~2.5e-13 relative over the full atmospheric (G0, G2, df) range — all in
# real arithmetic (no complex error function), so it vmaps and fuses like any
# other elementwise op.
_GL_X = np.array([
    0.14739918461631113, 0.5909018112431884, 1.3344875116145762,
    2.3850115520046535, 3.752567873874768, 5.451062939568397,
    7.499085532907372, 9.921219136072429, 12.750055460117064,
    16.029386360375128, 19.819512877102024, 24.206680643468307,
    29.321456103352332, 35.37955078717556, 42.79325597075464,
    52.618366255753244,
])
_GL_W = np.array([
    9.7740989137130668e-02, 2.5230790121227259e-01, 2.7241982515207869e-01,
    1.7166350712629086e-01, 6.9540261026554209e-02, 1.8734808778456017e-02,
    3.3812292389549530e-03, 4.0525569008016644e-04, 3.1561318148868834e-05,
    1.5413042593641668e-06, 4.4749378027620335e-08, 7.1360371637515934e-10,
    5.5328497841369325e-12, 1.7037275146911221e-14, 1.4182495888448438e-17,
    1.2137123039229566e-21,
]) * 1.1283791670955126  # 2/sqrt(pi)


def _qsd_resonance(df, gamma0, gamma2):
    """pi x quadratic-speed-dependent Lorentzian at detuning df [GHz].

    Reduces to the Lorentzian gamma0/(df^2+gamma0^2) as gamma2 -> 0.
    Inputs broadcast; a trailing quadrature axis is reduced internally.
    """
    dtype = gamma0.dtype
    x = jnp.asarray(_GL_X, dtype)
    w = jnp.asarray(_GL_W, dtype)
    cr = (gamma0 - 1.5 * gamma2)[..., None] + gamma2[..., None] * x
    ci = df[..., None]
    return jnp.sum(w * cr / (cr * cr + ci * ci), axis=-1)


def h2o_absorption(f_ghz, p_hpa, t_k, rho_gm3, model: H2OModel = H2O_MODELS["R98"]):
    """Water-vapor absorption [Np/km].

    Args:
      f_ghz:   frequency [GHz] (broadcastable).
      p_hpa:   total pressure [hPa].
      t_k:     temperature [K].
      rho_gm3: water-vapor density [g/m^3].
      model:   H2OModel line table / continuum coefficients.

    Returns:
      alpha [nepers/km], broadcast shape of the inputs.
    """
    dtype = jnp.result_type(f_ghz, p_hpa, t_k, rho_gm3, jnp.float32)
    f = jnp.asarray(f_ghz, dtype)[..., None]  # trailing line axis
    p = jnp.asarray(p_hpa, dtype)[..., None]
    t = jnp.asarray(t_k, dtype)[..., None]
    rho = jnp.asarray(rho_gm3, dtype)[..., None]

    fl = jnp.asarray(model.fl, dtype)
    s1 = jnp.asarray(model.s1, dtype)
    b2 = jnp.asarray(model.b2, dtype)
    w3 = jnp.asarray(model.w3, dtype)
    x = jnp.asarray(model.x, dtype)
    ws = jnp.asarray(model.ws, dtype)
    xs = jnp.asarray(model.xs, dtype)

    ti = 300.0 / t
    pvap = rho * t / 217.0  # vapor partial pressure [hPa]
    pda = p - pvap          # dry-air partial pressure [hPa]
    den = 3.344e16 * rho    # molecules / cm^3 per (g/m^3)
    ti2 = ti ** 2.5

    width = w3 * pda * ti**x + ws * pvap * ti**xs
    wsq = width * width
    s = s1 * ti2 * jnp.exp(b2 * (1.0 - ti))

    df1 = f - fl
    df2 = f + fl
    base = width / (model.cutoff_ghz**2 + wsq)  # Clough local-line base
    near1 = width / (df1 * df1 + wsq)
    if model.has_sd:
        # Speed-dependent lines (R19SD/R20SD): qSD shape on the near-resonant
        # term; the mirror term and cutoff base stay Lorentzian (gamma2 is
        # negligible hundreds of GHz off resonance).
        gamma2 = (jnp.asarray(model.w2, dtype) * pda * ti**x
                  + jnp.asarray(model.ws2, dtype) * pvap * ti**xs)
        sd_mask = jnp.asarray((model.w2 != 0.0) | (model.ws2 != 0.0))
        near1 = jnp.where(sd_mask, _qsd_resonance(df1, width, gamma2), near1)
    res = jnp.where(
        jnp.abs(df1) < model.cutoff_ghz, near1 - base, 0.0
    ) + jnp.where(
        jnp.abs(df2) < model.cutoff_ghz, width / (df2 * df2 + wsq) - base, 0.0
    )
    line_sum = jnp.sum(s * res * (f / fl) ** 2, axis=-1)

    ti_ = ti[..., 0]
    f_ = f[..., 0]
    pvap_ = pvap[..., 0]
    pda_ = pda[..., 0]
    con = (
        model.cf * ti_**model.xcf * pda_ + model.cs * ti_**model.xcs * pvap_
    ) * pvap_ * f_ * f_

    return 0.3183e-4 * den[..., 0] * line_sum + con
