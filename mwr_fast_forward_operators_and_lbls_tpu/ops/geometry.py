"""Slant-path geometry through a spherically stratified refracting atmosphere.

Replaces the ray-tracing PyRTlib performs inside `rte.execute()` for the
reference's 10 elevation angles, 90 deg down to 4.2 deg
(/root/reference/python_src/preproc/preprocessing4all.py:40,
PyRTlib_processing.py:99-126).  At 4.2 deg elevation the airmass is ~13 and
refractive bending contributes several percent of the path — sec(zenith) is
not good enough, so we trace through spherical shells with Snell's law for a
radially stratified medium:  n * r * cos(elevation) = const.

Everything is closed-form per layer (no iteration), fully vectorized, and
differentiable, so the K-matrix sees d(path)/d(T,q) through the refractivity.
"""

import jax
import jax.numpy as jnp

from ..constants import physics as phys


def refractivity(p_hpa, t_k, e_hpa):
    """Radio refractivity N [ppm] (Rueeger 2002 'best average' coefficients).

    N = 77.6890 pd/T + 71.2952 e/T + 375463 e/T^2, pd = p - e.
    """
    pd = p_hpa - e_hpa
    return 77.6890 * pd / t_k + 71.2952 * e_hpa / t_k + 375463.0 * e_hpa / (t_k * t_k)


def refractive_index(p_hpa, t_k, e_hpa):
    """n = 1 + N*1e-6."""
    return 1.0 + 1e-6 * refractivity(p_hpa, t_k, e_hpa)


@jax.named_scope("geometry")
def slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """Per-layer slant path lengths [km] from ground to top.

    Args:
      z_m:    level heights above MSL [m], ascending, shape (L,).
      p_hpa:  level pressures [hPa], shape (L,).
      t_k:    level temperatures [K], shape (L,).
      e_hpa:  level vapor pressures [hPa], shape (L,).
      elevation_deg: scalar elevation angle [deg] (90 = zenith).

    Returns:
      ds_km: shape (L-1,) slant distance through each layer [km].

    For each shell [r_i, r_i+1] with mean refractive index n_i, the straight
    chord consistent with the Snell invariant k = n0*r0*cos(el) is
        ds = sqrt(r_top^2 - rk^2) - sqrt(r_bot^2 - rk^2),   rk = k / n_i,
    which reduces to dz at zenith and to the refraction-bent path at low
    elevation.  Level-0 is the observer (ground) level.
    """
    z = jnp.asarray(z_m)
    n = refractive_index(p_hpa, t_k, e_hpa)
    r = phys.EARTH_RADIUS + z

    el = jnp.deg2rad(elevation_deg)
    k = n[0] * r[0] * jnp.cos(el)  # Snell invariant [m]

    n_layer = 0.5 * (n[:-1] + n[1:])
    rk = k / n_layer
    r_bot, r_top = r[:-1], r[1:]

    # Cancellation-safe evaluation: the naive seg_top - seg_bot subtracts two
    # ~R_E-sized square roots and loses the layer thickness in float32.  Use
    #   ds = (r_top^2 - rk^2) - (r_bot^2 - rk^2)     over    (seg_top + seg_bot)
    #      = dz * (r_top + r_bot) / (seg_top + seg_bot),
    # with the sqrt arguments themselves factored as (r-rk)(r+rk).  At zenith
    # (rk = 0) this reduces to ds = dz exactly.
    seg_top = jnp.sqrt(jnp.maximum((r_top - rk) * (r_top + rk), 0.0))
    seg_bot = jnp.sqrt(jnp.maximum((r_bot - rk) * (r_bot + rk), 0.0))
    # dz from z directly — (R_E + z) quantizes layer thicknesses to the
    # ~0.5 m float32 ulp of the Earth radius.
    dz = z[1:] - z[:-1]
    ds_m = dz * (r_top + r_bot) / jnp.maximum(seg_top + seg_bot, 1.0)
    return ds_m * 1e-3


def slant_path_sensitivities(z_m, n, elevation_deg):
    """Closed-form partials of the per-layer slant paths.

    The layer path ds_i (see `slant_path_lengths`) depends on the refractive
    index ONLY through the layer mean n_layer_i = (n_i + n_{i+1})/2 and the
    scalar Snell invariant k = n_0 * r_0 * cos(el) — the Jacobian
    d(ds)/d(n levels) is tridiagonal-local plus a rank-one level-0 column.
    This returns the two dense factors the K-matrix assembly needs
    (models/jacobians.py::kmatrix_batch_fast), replacing per-channel
    autodiff pullbacks through the geometry:

      dds_dnlayer: d(ds_i [km]) / d(n_layer_i)        shape (..., L-1)
      dds_dk:      d(ds_i [km]) / d(k [m])            shape (..., L-1)

    Args:
      z_m:  (..., L) level heights [m] (ascending).
      n:    (..., L) refractive index per level.
      elevation_deg: (...) elevation angle(s) [deg], broadcastable against
        the leading dims of z_m/n.
    """
    z = jnp.asarray(z_m)
    r = phys.EARTH_RADIUS + z
    el = jnp.deg2rad(jnp.asarray(elevation_deg))[..., None]
    k = n[..., :1] * r[..., :1] * jnp.cos(el)

    n_layer = 0.5 * (n[..., :-1] + n[..., 1:])
    rk = k / n_layer
    r_bot, r_top = r[..., :-1], r[..., 1:]
    seg_top = jnp.sqrt(jnp.maximum((r_top - rk) * (r_top + rk), 0.0))
    seg_bot = jnp.sqrt(jnp.maximum((r_bot - rk) * (r_bot + rk), 0.0))
    dz = z[..., 1:] - z[..., :-1]
    denom = seg_top + seg_bot

    # d(ds_m)/d(rk) = dz*(r_top+r_bot)/denom^2 * rk*(1/seg_top + 1/seg_bot),
    # gated where the primal's sqrt/denominator clamps were active.
    inv_top = jnp.where(seg_top > 0.0, 1.0 / jnp.maximum(seg_top, 1e-30),
                        0.0)
    inv_bot = jnp.where(seg_bot > 0.0, 1.0 / jnp.maximum(seg_bot, 1e-30),
                        0.0)
    denom_c = jnp.maximum(denom, 1.0)
    dds_drk = jnp.where(
        denom > 1.0,
        dz * (r_top + r_bot) / (denom_c * denom_c) * rk
        * (inv_top + inv_bot),
        0.0)
    dds_dnlayer = dds_drk * (-rk / n_layer) * 1e-3
    dds_dk = dds_drk * (1.0 / n_layer) * 1e-3
    return dds_dnlayer, dds_dk


def airmass(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """Total slant path divided by vertical path (diagnostic)."""
    ds = slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg)
    dz = jnp.diff(jnp.asarray(z_m)) * 1e-3
    return jnp.sum(ds) / jnp.sum(dz)


def local_zenith_angles(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """Local zenith angle [deg] at each level along the refracted ray."""
    z = jnp.asarray(z_m)
    n = refractive_index(p_hpa, t_k, e_hpa)
    r = phys.EARTH_RADIUS + z
    el = jnp.deg2rad(elevation_deg)
    k = n[0] * r[0] * jnp.cos(el)
    cos_el_local = jnp.clip(k / (n * r), 0.0, 1.0)
    return 90.0 - jnp.rad2deg(jnp.arccos(cos_el_local))
