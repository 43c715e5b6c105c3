"""ARMS-gb NetCDF-protocol interop (FWD_Test input/output schema).

The reference feeds ARMS-gb one NetCDF per elevation with a fixed schema —
`Times_Number`/`Levels_Number`/`Profiles_Number` scalars, float32 `Level_*`
columns (TOA->ground), surface scalars duplicated under `Obs_*` names,
placeholder `Obs_BT`/`Sim_BT`/`OMB` arrays, and `GMRZenith` carrying the
*elevation* angle (/root/reference/python_src/proc/
ARMS_gb_processing.py:103-212) — then reads `Sim_BT` back and maps exact
zeros to NaN (:286-297, :348).

This module reads and writes that schema with the framework's own NetCDF
codec, adds the AFGL O3 column the reference interpolates from climatology
(`get_O3_profile`, :94-99), and provides `simulate_input_nc` — read an
ARMS-gb input file, run the native forward, write `Sim_BT` — so an ARMS-gb
deployment can swap `make && ./FWD_Test` for this framework.
"""

from __future__ import annotations

import numpy as np

from ..constants import afgl
from ..data.dataset import Dataset
from ..data import netcdf

N_CHANNELS = 14


def o3_profile_ppmv(level_z_m: np.ndarray,
                    climatology: str = "midlatitude_summer") -> np.ndarray:
    """AFGL O3 [ppmv] interpolated to level heights [m] — the reference's
    `get_O3_profile` replacement for the old constant 0.06 ppmv
    (ARMS_gb_processing.py:94-99,132-136)."""
    clim = afgl.CLIMATOLOGIES[climatology]
    return np.interp(np.asarray(level_z_m) / 1000.0,
                     clim["z_km"], clim["o3_ppmv"])


def write_input_nc(path: str, *, level_pressure, level_temperature,
                   level_h2o, level_ppmv, level_liquid, level_z, level_rh,
                   surface_pressure, temperature_2m, h2o_2m,
                   surface_altitude, elevation_deg, profile_indices=None,
                   times=None, clear_sky: bool = True,
                   level_o3=None) -> Dataset:
    """Write one ARMS-gb input file (schema of `write_armsgb_input_nc`,
    ARMS_gb_processing.py:154-212).  Level arrays are (N_Levels, N_Profiles)
    TOA->ground; surface arrays are (N_Profiles,)."""
    lp = np.asarray(level_pressure, np.float32)
    n_levels, n_profiles = lp.shape
    liq = np.asarray(level_liquid, np.float32)
    if clear_sky:
        liq = np.zeros_like(liq)
    if profile_indices is None:
        profile_indices = np.arange(n_profiles)
    profile_indices = np.asarray(profile_indices, np.int32)
    n_times = len(profile_indices)
    if times is None:
        times = np.zeros(n_times)
    if level_o3 is None:
        level_o3 = np.broadcast_to(
            o3_profile_ppmv(np.asarray(level_z)[:, 0])[:, None],
            lp.shape).astype(np.float32)
    placeholder = np.zeros((N_CHANNELS, n_times), np.float64)

    f32 = lambda a: np.asarray(a, np.float32)
    lev = ("N_Levels", "N_Profiles")
    ds = Dataset({
        "Times_Number": (("N_Data",), np.array([n_times], np.int32)),
        "Levels_Number": (("N_Data",), np.array([n_levels], np.int32)),
        "Profiles_Number": (("N_Data",), np.array([n_profiles], np.int32)),
        "Level_Pressure": (lev, lp, {"units": "hPa"}),
        "Level_Temperature": (lev, f32(level_temperature), {"units": "K"}),
        "Level_H2O": (lev, f32(level_h2o), {"units": "g/kg"}),
        "Level_ppmvs": (lev, f32(level_ppmv), {"units": "ppmv"}),
        "Level_Liquid": (lev, liq, {"units": "kg/kg"}),
        "Level_z": (lev, f32(level_z), {"units": "m"}),
        "Level_O3": (lev, f32(level_o3)),
        "Level_RH": (lev, f32(level_rh), {"units": "%"}),
        "times": (("N_Times",), np.asarray(times)),
        "Obs_Surface_Pressure": (("N_Times",), f32(surface_pressure)),
        "Obs_Temperature_2M": (("N_Times",), f32(temperature_2m)),
        "Obs_H2O_2M": (("N_Times",), f32(h2o_2m)),
        "Surface_Pressure": (("N_Profiles",), f32(surface_pressure)),
        "Temperature_2M": (("N_Profiles",), f32(temperature_2m)),
        "H2O_2M": (("N_Profiles",), f32(h2o_2m)),
        "Surface_Altitude": (("N_Profiles",), f32(surface_altitude)),
        "Obs_BT": (("N_Channels", "N_Times"), placeholder.copy()),
        "Sim_BT": (("N_Channels", "N_Times"), placeholder.copy()),
        "OMB": (("N_Channels", "N_Times"), placeholder.copy()),
        "QC_Flag": (("N_Times",), np.zeros(n_times)),
        "Profile_Index": (("N_Times",), profile_indices.astype(np.float64)),
        # The schema stores the *elevation* angle under this name
        # (ARMS_gb_processing.py:186: "GMRZenith": 90-ZA with ZA=90-elev).
        "GMRZenith": (("N_Times",),
                      np.full(n_times, elevation_deg, np.float32)),
    })
    netcdf.write(path, ds)
    return ds


def read_input_nc(path: str) -> dict:
    """Read an ARMS-gb input file into the framework's forward-profile
    convention: (B, L) arrays ground->top plus per-profile metadata."""
    ds = netcdf.read(path)
    flip = lambda name: np.asarray(ds[name].data, np.float64).T[:, ::-1]
    p = flip("Level_Pressure")
    t = flip("Level_Temperature")
    out = {
        "p": p, "t": t, "z": flip("Level_z"),
        "mr_gkg": flip("Level_H2O"),
        "ppmv": flip("Level_ppmvs"),
        "liquid_kgkg": flip("Level_Liquid"),
        "elevation_deg": float(np.asarray(ds["GMRZenith"].data).ravel()[0]),
        "profile_index": np.asarray(ds["Profile_Index"].data, np.int64),
        "surface_altitude": np.asarray(ds["Surface_Altitude"].data, np.float64),
    }
    if "Level_O3" in ds.variables:
        out["o3_ppmv"] = flip("Level_O3")
    return out


def read_sim_bt(path: str, zero_is_missing: bool = True) -> np.ndarray:
    """Read `Sim_BT` (N_Channels, N_Times) from an ARMS-gb output file; the
    reference treats exact zeros as missing (ARMS_gb_processing.py:348)."""
    ds = netcdf.read(path)
    bt = np.asarray(ds["Sim_BT"].data, np.float64)
    if zero_is_missing:
        bt = np.where(bt == 0.0, np.nan, bt)
    return bt


def simulate_input_nc(in_path: str, out_path: str, model: str = "R24",
                      include_o3: bool = False) -> np.ndarray:
    """Act as `FWD_Test`: read an ARMS-gb input NetCDF, run the native forward
    at the file's elevation angle, write the file back with `Sim_BT` filled.

    Returns the simulated TBs (N_Channels, N_Times).
    """
    import jax.numpy as jnp

    from ..models import lbl
    from ..ops import thermo

    prof = read_input_nc(in_path)
    p, t = prof["p"], prof["t"]
    e = np.asarray(thermo.mr_to_e(prof["mr_gkg"], p))
    rho = np.asarray(thermo.e_to_rho(e, t))
    rho_air = np.asarray(thermo.density_moist(p, t, prof["mr_gkg"]))
    lwc = prof["liquid_kgkg"] * rho_air * 1000.0
    cfg = lbl.LBLConfig(model=model,
                        elevations_deg=(prof["elevation_deg"],),
                        outputs=("tb",), include_o3=include_o3)
    profiles = {k: jnp.asarray(v) for k, v in
                (("z", prof["z"]), ("p", p), ("t", t),
                 ("rho", rho), ("lwc", lwc))}
    if include_o3 and "o3_ppmv" in prof:
        profiles["o3_ppmv"] = jnp.asarray(prof["o3_ppmv"])
    tb = np.asarray(lbl.forward_batch(profiles, cfg)["tb"])[:, 0, :]  # (B, F)

    ds = netcdf.read(in_path)
    sim = ds["Sim_BT"].data.astype(np.float64)
    sim[:, :tb.shape[0]] = tb.T
    ds["Sim_BT"] = (("N_Channels", "N_Times"), sim)
    netcdf.write(out_path, ds)
    return sim
