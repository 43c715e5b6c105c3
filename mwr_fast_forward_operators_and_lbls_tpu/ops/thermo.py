"""Vectorized thermodynamic / humidity conversions (JAX).

JAX re-implementation of the conversion helpers the reference keeps in
two places: the Clausius-Clapeyron family in
/root/reference/python_src/preproc/preprocessing4all.py:104-152 and the wider
library in /root/reference/python_src/merge_data_into_netCDF/Sc_module.py:79-314.
All functions are pure, broadcasting, and differentiable — usable inside jit,
vmap, and the Jacobian (K-matrix) transforms.

Unit conventions (matching the harmonized dataset schema, SURVEY.md section 1):
  pressure        p      [hPa]
  temperature     t      [K]
  mixing ratio    mr     [g/kg]  (mass of vapor per mass of dry air)
  relative hum.   rh     [%]
  vapor pressure  e      [hPa]
  vapor density   rho    [g/m^3]
  volume ratio    ppmv   [ppm by volume]
"""

import jax.numpy as jnp

from ..constants import physics as phys


def es_clausius_clapeyron(t):
    """Saturation vapor pressure [hPa] via the reference's CC form.

    es = 6.1078 * exp(L/Rv * (1/273.15 - 1/T)), the exact expression used in
    preprocessing4all.py:104-152 (there in Pa with 610.78).
    """
    return 6.1078 * jnp.exp(phys.LV / phys.RV * (1.0 / phys.T0C - 1.0 / t))


def es_magnus(t):
    """Saturation vapor pressure [hPa], Magnus form over water (Sc_module.py:79-91)."""
    tc = t - phys.T0C
    return 6.1078 * jnp.exp(17.08085 * tc / (234.175 + tc))


def es_ice(t):
    """Saturation vapor pressure [hPa] over ice (Magnus, Murray 1967 coefficients)."""
    tc = t - phys.T0C
    return 6.1071 * jnp.exp(22.4429 * tc / (272.44 + tc))


def rh_to_e(rh, t, over_ice=False):
    """Relative humidity [%] -> vapor pressure [hPa]."""
    es = jnp.where(over_ice, es_ice(t), es_clausius_clapeyron(t)) if isinstance(
        over_ice, jnp.ndarray
    ) else (es_ice(t) if over_ice else es_clausius_clapeyron(t))
    return rh / 100.0 * es


def e_to_rh(e, t):
    """Vapor pressure [hPa] -> relative humidity [%] (over water)."""
    return 100.0 * e / es_clausius_clapeyron(t)


def e_to_mr(e, p):
    """Vapor pressure [hPa] -> mixing ratio [g/kg]."""
    return 1000.0 * phys.EPSILON * e / (p - e)


def mr_to_e(mr, p):
    """Mixing ratio [g/kg] -> vapor pressure [hPa]."""
    r = mr / 1000.0
    return p * r / (phys.EPSILON + r)


def rh_to_mr(rh, p, t):
    """Relative humidity [%] -> mixing ratio [g/kg]."""
    return e_to_mr(rh_to_e(rh, t), p)


def mr_to_rh(mr, p, t):
    """Mixing ratio [g/kg] -> relative humidity [%]."""
    return e_to_rh(mr_to_e(mr, p), t)


def mr_to_ppmv(mr):
    """Mixing ratio [g/kg] -> volume mixing ratio [ppmv]."""
    return mr * 1000.0 * phys.MD / phys.MW


def ppmv_to_mr(ppmv):
    """Volume mixing ratio [ppmv] -> mixing ratio [g/kg]."""
    return ppmv / 1000.0 * phys.MW / phys.MD


def e_to_rho(e, t):
    """Vapor pressure [hPa] -> absolute humidity / vapor density [g/m^3].

    rho = e*100 / (Rv*T) * 1000 = 216.679 * e / T  — the `RHO = E*100/(461.5*T)`
    convention of the Rosenkranz codes (there in kg/m^3).
    """
    return 1e5 / phys.RV * e / t


def rho_to_e(rho, t):
    """Vapor density [g/m^3] -> vapor pressure [hPa]."""
    return rho * t * phys.RV / 1e5


def mr_to_rho(mr, p, t):
    """Mixing ratio [g/kg] -> vapor density [g/m^3]."""
    return e_to_rho(mr_to_e(mr, p), t)


def specific_to_mr(q):
    """Specific humidity [g/kg] -> mixing ratio [g/kg]."""
    return q / (1.0 - q / 1000.0)


def mr_to_specific(mr):
    """Mixing ratio [g/kg] -> specific humidity [g/kg]."""
    return mr / (1.0 + mr / 1000.0)


def virtual_temperature(t, mr):
    """Virtual temperature [K] from T [K] and mixing ratio [g/kg]."""
    r = mr / 1000.0
    return t * (1.0 + r / phys.EPSILON) / (1.0 + r)


def iwv_from_profile(rho_gm3, z_m, axis=-1):
    """Integrated water vapor [kg/m^2] by trapezoid over height [m].

    Mirrors Sc_module.py:214-221 (there a rectangle rule; trapezoid here).
    """
    rho = rho_gm3 * 1e-3  # kg/m^3
    dz = jnp.diff(z_m, axis=axis)
    mid = 0.5 * (
        jnp.take(rho, jnp.arange(1, rho.shape[axis]), axis=axis)
        + jnp.take(rho, jnp.arange(0, rho.shape[axis] - 1), axis=axis)
    )
    return jnp.sum(mid * dz, axis=axis)


def barometric_pressure(p0, t, z0, z):
    """Barometric extrapolation of pressure [hPa] (Sc_module.py:308-314)."""
    return p0 * jnp.exp(-phys.G0 * (z - z0) / (phys.RD * t))


def density_moist(p, t, mr):
    """Moist-air density [kg/m^3] from p [hPa], T [K], mixing ratio [g/kg]."""
    return p * 100.0 / (phys.RD * virtual_temperature(t, mr))


def potential_temperature(t, p, p0=1000.0):
    """theta = T (p0/p)^(R/cp) [K]."""
    return t * (p0 / p) ** 0.2854


def bulk_richardson(z_m, t_k, p_hpa, mr_gkg, u_ms, v_ms):
    """Bulk Richardson number between the surface level and each level.

    Ri_b = (g/thetav_0) * (thetav - thetav_0) * (z - z_0) / (u^2 + v^2)
    (the stability diagnostic of the reference's thermo library,
    /root/reference/python_src/merge_data_into_netCDF/Sc_module.py:73-75).
    Level 0 is the surface; wind components relative to the surface flow.
    """
    thv = virtual_temperature(potential_temperature(t_k, p_hpa), mr_gkg)
    du2 = u_ms**2 + v_ms**2
    num = 9.80665 / thv[..., :1] * (thv - thv[..., :1]) * (z_m - z_m[..., :1])
    return num / jnp.maximum(du2, 1e-6)
