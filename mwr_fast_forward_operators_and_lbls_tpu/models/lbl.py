"""Batched line-by-line forward operator: profiles -> brightness temperatures.

This replaces the reference's hot loop — the
sequential `for time x crop x elevation x model: rte.execute()` nest in
/root/reference/python_src/proc/PyRTlib_processing.py:99-151 ("Dieser Code
ist sehr langsam").  Here the whole nest is one jitted, vmapped computation:

    profiles (B, L) x elevations (E) x frequencies (F)  ->  TB (B, E, F)

with layer optical depths, transmittances, and mean radiating temperature as
secondary outputs (the RTTOV-gb parity outputs, RTTOV_gb_processing.py:364-434).

Profiles enter ground -> top (ascending z).  The harmonized dataset stores
levels TOA -> ground (preprocessing4all.py:530-531); `flip_profile` converts.
"""

import functools
from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import hatpro
from ..ops import geometry, rte, thermo
from ..ops.absorption import total_absorption


@dataclass(frozen=True)
class LBLConfig:
    """Static configuration of the LBL forward operator (hashable; all fields
    participate in the jit cache key)."""

    model: str = "R24"
    freqs_ghz: tuple = tuple(hatpro.HATPRO_FREQS_GHZ.tolist())
    elevations_deg: tuple = tuple(hatpro.ELEVATIONS_DEG.tolist())
    include_liquid: bool = True
    dtype: str = "float32"
    # Which outputs to materialize.  trans_level is (B, E, F, L) — by far the
    # largest output and its layout restoration dominates the forward wall
    # time, so throughput-oriented callers should ask only for what they need.
    outputs: tuple = ("tb", "tau_total", "t_mr", "trans_level")
    # Add ozone absorption from the profiles' "o3_ppmv" entry (falls back to
    # AFGL climatology interpolated in z) — the ARMS-gb capability.
    include_o3: bool = False


def flip_profile(profile: dict) -> dict:
    """Reverse the level axis (last axis) of every per-level variable."""
    return {k: v[..., ::-1] for k, v in profile.items()}


def forward_single(z_m, p_hpa, t_k, rho_gm3, lwc_gm3, f_ghz, elevation_deg,
                   model: str = "R24", o3_ppmv=None):
    """TB + opacity diagnostics for ONE profile at ONE elevation.

    Args:
      z_m, p_hpa, t_k, rho_gm3, lwc_gm3: (L,) level arrays, ground -> top.
        rho is water-vapor density [g/m^3], lwc cloud liquid [g/m^3].
      f_ghz: (F,) frequencies.
      elevation_deg: scalar elevation angle.
      model: absorption-model name (any of the nine H2O_MODELS keys).
      o3_ppmv: optional (L,) ozone profile [ppmv] (ARMS-gb parity).

    Returns dict of tb (F,), tau_total (F,), trans_level (F, L), t_mr (F,).
    """
    e_hpa = thermo.rho_to_e(rho_gm3, t_k)
    alpha = total_absorption(
        f_ghz[:, None], p_hpa[None, :], t_k[None, :], rho_gm3[None, :],
        lwc_gm3[None, :] if lwc_gm3 is not None else None, model=model,
        o3_ppmv=o3_ppmv[None, :] if o3_ppmv is not None else None,
    )
    ds_km = geometry.slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg)
    return rte.downwelling_tb(alpha, ds_km, t_k, f_ghz)


@functools.partial(jax.jit, static_argnames=("config",))
def forward_batch(profiles: dict, config: LBLConfig = LBLConfig()):
    """Vectorized forward: dict of (B, L) arrays -> dict of batched outputs.

    Args:
      profiles: dict with keys "z" [m], "p" [hPa], "t" [K], "rho" [g/m^3]
        and optionally "lwc" [g/m^3]; each (B, L), levels ground -> top.
      config: static LBLConfig.

    Returns:
      dict with tb (B, E, F), tau_total (B, E, F), t_mr (B, E, F),
      trans_level (B, E, F, L).
    """
    dtype = jnp.dtype(config.dtype)
    f = jnp.asarray(config.freqs_ghz, dtype)
    elevs = jnp.asarray(config.elevations_deg, dtype)

    z = profiles["z"].astype(dtype)
    p = profiles["p"].astype(dtype)
    t = profiles["t"].astype(dtype)
    rho = profiles["rho"].astype(dtype)
    lwc = profiles.get("lwc")
    lwc = jnp.zeros_like(rho) if (lwc is None or not config.include_liquid) \
        else lwc.astype(dtype)

    o3 = None
    if config.include_o3:
        o3 = profiles.get("o3_ppmv")
        if o3 is None:
            from ..constants import afgl
            clim = afgl.CLIMATOLOGIES["midlatitude_summer"]
            o3 = jnp.interp(z / 1000.0, jnp.asarray(clim["z_km"], dtype),
                            jnp.asarray(clim["o3_ppmv"], dtype))
        o3 = o3.astype(dtype)

    def one(zi, pi, ti, ri, li, oi=None):
        def at_elev(el):
            return forward_single(zi, pi, ti, ri, li, f, el, config.model,
                                  o3_ppmv=oi)
        return jax.vmap(at_elev)(elevs)

    if o3 is None:
        out = jax.vmap(one)(z, p, t, rho, lwc)
    else:
        out = jax.vmap(one)(z, p, t, rho, lwc, o3)
    return {k: v for k, v in out.items() if k in config.outputs}


def forward_all_models(profiles: dict, config: LBLConfig = LBLConfig(),
                       models: Sequence[str] = ("R98", "R17", "R20", "R24")):
    """TBs for several absorption models (the reference runs 4 per profile,
    PyRTlib_processing.py:121-151; its zenith study sweeps all nine —
    old_merge2nc.py:417-435 — pass
    `models=constants.h2o_lines.ZENITH_SWEEP_MODELS` for that).
    Returns {model: tb (B, E, F)}."""
    out = {}
    for m in models:
        cfg = LBLConfig(model=m, freqs_ghz=config.freqs_ghz,
                        elevations_deg=config.elevations_deg,
                        include_liquid=config.include_liquid, dtype=config.dtype)
        out[m] = forward_batch(profiles, cfg)["tb"]
    return out


def demo_profile(n_levels: int = hatpro.N_LEVELS, seed: int = 0) -> dict:
    """A physically plausible synthetic midlatitude profile (ground -> top),
    for tests/benchmarks when campaign NetCDFs are unavailable."""
    rng = np.random.default_rng(seed)
    z = np.linspace(0.0, 25_000.0, n_levels)
    t = 288.0 - 6.5e-3 * np.minimum(z, 11_000.0) - 0.0005e-3 * np.maximum(z - 11_000.0, 0)
    t = t + rng.normal(0, 0.5, n_levels).cumsum() * 0.05
    p = 1013.0 * np.exp(-z / 7800.0)
    rh = np.clip(75.0 - z / 1000.0 * 2.0 + rng.normal(0, 3.0, n_levels), 2.0, 98.0)
    e = rh / 100.0 * 6.1078 * np.exp(17.08085 * (t - 273.15) / (234.175 + (t - 273.15)))
    rho = 216.679 * e / t
    lwc = np.zeros(n_levels)
    cloud = (z > 1000.0) & (z < 1600.0)
    lwc[cloud] = 0.2
    return {
        "z": z.astype(np.float32),
        "p": p.astype(np.float32),
        "t": t.astype(np.float32),
        "rho": rho.astype(np.float32),
        "lwc": lwc.astype(np.float32),
    }


def demo_batch(batch: int, n_levels: int = hatpro.N_LEVELS, seed: int = 0) -> dict:
    profs = [demo_profile(n_levels, seed + i) for i in range(batch)]
    return {k: jnp.stack([jnp.asarray(p[k]) for p in profs]) for k in profs[0]}
