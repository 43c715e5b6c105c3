"""Preprocessing pipeline: raw campaign files -> harmonized CF-1.8 dataset.

The L1 stage of the reference (summarize_many_profiles / produce_dataset /
clean_dataset / interpolate_azimuths / replace_nan_lats_and_lons,
/root/reference/python_src/preproc/preprocessing4all.py:576-1245), rebuilt
on this framework's ingest modules.  The output schema is the reference's
canonical data contract (SURVEY.md section 1):

  dims: time, N_Levels=180, Crop=2, elevation=10, azimuth=72, N_Channels=14
  profile variables (N_Levels, time, Crop), stored TOA -> ground
  TBs_<instrument> (time, elevation, azimuth, N_Channels)
  <Inst>_{z,ta,hua} (time, N_Levels) + <Inst>_{IWV,LWP} (time,)
  surface/meta variables (time[, Crop])

Internally everything is ground -> top; the level axis is flipped once at
dataset-assembly time to match the reference storage order
(preprocessing4all.py:530-531).
"""

from __future__ import annotations

import glob as globmod
from dataclasses import dataclass, field

import numpy as np

from ..constants import hatpro
from . import cloud, mwr, radiosonde
from .dataset import Dataset, Variable, concat

INSTRUMENT_VARS = {  # dataset-name prefix per instrument key
    "dwdhat": "Dwdhat", "foghat": "Foghat", "sunhat": "Sunhat",
    "tophat": "Tophat", "joyhat": "Joyhat", "hamhat": "Hamhat",
}


@dataclass
class SondeRecord:
    time: np.datetime64
    campaign: str
    location: str
    profiles: dict = field(default_factory=dict)   # {crop_idx: SondeProfile}
    mwr_data: dict = field(default_factory=dict)   # {instrument: {...}}
    qual_flag: float = 0.0
    lat: float = np.nan
    lon: float = np.nan


def process_sonde(path: str, campaign: str, location: str,
                  mwr_files: dict | None = None,
                  crop_variants: bool = True) -> SondeRecord:
    """One sonde file -> harmonized record with both crop variants.

    Crop=False keeps the full profile (ground mount); Crop=True restarts the
    profile at the 132 m level (roof mount, preprocessing4all.py:1227,253).
    """
    reader = (radiosonde.read_radiosonde_txt if path.endswith(".txt")
              else radiosonde.read_radiosonde_nc)
    launch = radiosonde.parse_launch_datetime(path)
    rec = SondeRecord(time=launch, campaign=campaign, location=location)

    for crop_idx, crop in enumerate((False, True) if crop_variants
                                    else (False,)):
        prof = reader(path, crop_at_132m=crop)
        prof = radiosonde.extend_with_climatology(prof)
        if prof.valid:
            water = cloud.derive_cloud_features(
                prof.z_m, prof.p_hpa, prof.t_k, prof.rh_pct)
            prof.lwc_kg_kg = water["lwc_kg_kg"]
            prof.ice_kg_kg = water["iwc_kg_kg"]
            prof.lwp_kg_m2 = water["lwp_kg_m2"]
            rec.lat, rec.lon = prof.lat, prof.lon
        rec.profiles[crop_idx] = radiosonde.harmonize_levels(prof)

    if mwr_files:
        rec.mwr_data = mwr.get_mwr_data(launch, mwr_files)
        quals = [d["qual"] for d in rec.mwr_data.values()
                 if np.isfinite(d["qual"])]
        rec.qual_flag = float(np.mean(quals)) if quals else 0.0
        for d in rec.mwr_data.values():
            if not np.isfinite(rec.lat) and np.isfinite(d["lat"]):
                rec.lat, rec.lon = d["lat"], d["lon"]
    return rec


def build_dataset(records: list, n_levels: int = hatpro.N_LEVELS) -> Dataset:
    """Assemble the canonical harmonized dataset from per-sonde records
    (produce_dataset, preprocessing4all.py:1111-1245)."""
    n = len(records)
    ne, na, nc = hatpro.N_ELEVATIONS, hatpro.N_AZIMUTHS, hatpro.N_CHANNELS

    lev = {k: np.full((n_levels, n, 2), np.nan) for k in
           ("p", "t", "mr", "ppmv", "liq", "ice", "z", "rh")}
    srf = {k: np.full((n, 2), np.nan) for k in ("p", "t", "mr", "alt", "lwp")}
    tbs = {inst: np.full((n, ne, na, nc), np.nan) for inst in INSTRUMENT_VARS}
    ret = {inst: np.full((n, 4, n_levels), np.nan) for inst in INSTRUMENT_VARS}
    iwv = {inst: np.full(n, np.nan) for inst in INSTRUMENT_VARS}
    lwp = {inst: np.full(n, np.nan) for inst in INSTRUMENT_VARS}
    times = np.empty(n, "datetime64[s]")
    lats = np.full(n, np.nan)
    lons = np.full(n, np.nan)
    quals = np.full(n, np.nan)
    camps = np.empty(n, dtype="U32")
    locs = np.empty(n, dtype="U32")

    for i, rec in enumerate(records):
        times[i] = rec.time
        lats[i], lons[i] = rec.lat, rec.lon
        quals[i] = rec.qual_flag
        camps[i], locs[i] = rec.campaign, rec.location
        for crop_idx, prof in rec.profiles.items():
            flip = slice(None, None, -1)  # store TOA -> ground
            lev["p"][:, i, crop_idx] = prof.p_hpa[flip]
            lev["t"][:, i, crop_idx] = prof.t_k[flip]
            lev["mr"][:, i, crop_idx] = prof.mr_gkg[flip]
            lev["ppmv"][:, i, crop_idx] = prof.ppmv[flip]
            lev["z"][:, i, crop_idx] = prof.z_m[flip]
            lev["rh"][:, i, crop_idx] = prof.rh_pct[flip]
            if prof.lwc_kg_kg is not None:
                lev["liq"][:, i, crop_idx] = prof.lwc_kg_kg[flip]
            if prof.ice_kg_kg is not None:
                lev["ice"][:, i, crop_idx] = prof.ice_kg_kg[flip]
            srf["p"][i, crop_idx] = prof.p_hpa[0]
            srf["t"][i, crop_idx] = prof.t_k[0]
            srf["mr"][i, crop_idx] = prof.mr_gkg[0]
            srf["alt"][i, crop_idx] = prof.surface_altitude_km
            srf["lwp"][i, crop_idx] = prof.lwp_kg_m2
        for inst, d in rec.mwr_data.items():
            tbs[inst][i] = d["tbs"]
            ret[inst][i] = d["profiles"]
            iwv[inst][i] = d["iwv"]
            lwp[inst][i] = d["lwp"]

    ds = Dataset(attrs={
        "Conventions": "CF-1.8",
        "title": "Harmonized radiosonde + MWR dataset "
                 "(mwr_fast_forward_operators_and_lbls_tpu)",
        "source": "radiosonde ingest + RPG-HATPRO L1/L2 matching",
    })
    ds["time"] = (("time",),
                  times.astype("datetime64[s]").astype("f8"),
                  {"units": "seconds since 1970-01-01 00:00:00",
                   "standard_name": "time"})
    ds["N_Levels"] = (("N_Levels",), np.arange(n_levels, dtype="i4"), {})
    ds["Crop"] = (("Crop",), np.array([0, 1], "i1"),
                  {"long_name": "profile cropped at 132 m (roof mount)"})
    ds["elevation"] = (("elevation",), hatpro.ELEVATIONS_DEG,
                       {"units": "degree", "standard_name": "sensor_zenith_angle",
                        "long_name": "elevation angle above horizon"})
    ds["azimuth"] = (("azimuth",), hatpro.AZIMUTHS_DEG, {"units": "degree"})
    ds["N_Channels"] = (("N_Channels",), np.arange(nc, dtype="i4"), {})
    ds["frequency"] = (("N_Channels",), hatpro.HATPRO_FREQS_GHZ,
                       {"units": "GHz", "long_name": "channel center frequency"})

    ldims = ("N_Levels", "time", "Crop")
    ds["Level_Pressure"] = (ldims, lev["p"], {"units": "hPa"})
    ds["Level_Temperature"] = (ldims, lev["t"],
                               {"units": "K", "standard_name": "air_temperature"})
    ds["Level_H2O"] = (ldims, lev["mr"],
                       {"units": "g/kg", "long_name": "water vapor mixing ratio"})
    ds["Level_ppmvs"] = (ldims, lev["ppmv"], {"units": "ppmv"})
    ds["Level_Liquid"] = (ldims, lev["liq"],
                          {"units": "kg/kg", "long_name": "cloud liquid water"})
    ds["Level_Ice"] = (ldims, lev["ice"], {"units": "kg/kg"})
    ds["Level_z"] = (ldims, lev["z"],
                     {"units": "m", "standard_name": "height"})
    ds["Level_RH"] = (ldims, lev["rh"],
                      {"units": "%", "standard_name": "relative_humidity"})

    for inst, prefix in INSTRUMENT_VARS.items():
        ds[f"TBs_{inst}"] = (
            ("time", "elevation", "azimuth", "N_Channels"), tbs[inst],
            {"units": "K", "long_name":
             f"observed brightness temperatures {prefix}"})
        ds[f"{prefix}_z"] = (("time", "N_Levels"), ret[inst][:, 0, :],
                             {"units": "m"})
        ds[f"{prefix}_ta"] = (("time", "N_Levels"), ret[inst][:, 1, :],
                              {"units": "K"})
        ds[f"{prefix}_hua"] = (("time", "N_Levels"), ret[inst][:, 3, :],
                               {"units": "kg m-3"})
        ds[f"{prefix}_IWV"] = (("time",), iwv[inst], {"units": "kg m-2"})
        ds[f"{prefix}_LWP"] = (("time",), lwp[inst], {"units": "kg m-2"})

    ds["Surface_Pressure"] = (("time", "Crop"), srf["p"], {"units": "hPa"})
    ds["Temperature_2M"] = (("time", "Crop"), srf["t"], {"units": "K"})
    ds["H2O_2M"] = (("time", "Crop"), srf["mr"], {"units": "g/kg"})
    ds["Surface_Altitude"] = (("time", "Crop"), srf["alt"], {"units": "km"})
    ds["LWP_radiosonde"] = (("time", "Crop"), srf["lwp"], {"units": "kg m-2"})
    ds["qual_flag"] = (("time",), quals, {})
    ds["Latitude"] = (("time",), lats, {"units": "degrees_north"})
    ds["Longitude"] = (("time",), lons, {"units": "degrees_east"})
    ds["Campaign"] = (("time",), camps, {})
    ds["Location"] = (("time",), locs, {})
    ds["Profile_Index"] = (("time",), np.arange(n, dtype="i4"), {})
    return ds


def clean_dataset(ds: Dataset) -> Dataset:
    """Drop timesteps whose profiles are NaN in *both* crop variants or whose
    instrument TBs are all-NaN (clean_dataset, preprocessing4all.py:840-867)."""
    z = ds["Level_z"].data
    n = z.shape[1]
    keep = np.ones(n, bool)
    for i in range(n):
        if np.isnan(z[:, i, 0]).any() and np.isnan(z[:, i, 1]).any():
            keep[i] = False
        tb_all_nan = all(
            np.isnan(ds[f"TBs_{inst}"].data[i]).all()
            for inst in INSTRUMENT_VARS if f"TBs_{inst}" in ds)
        if tb_all_nan:
            keep[i] = False
    return ds.sel_mask("time", keep)


def interpolate_azimuths(ds: Dataset,
                         instruments=("foghat", "joyhat"),
                         elevation_index: int = 1) -> Dataset:
    """Azimuth-gap interpolation for the 30-degree-step scanners at the 30
    deg elevation (interpolate_azimuths, preprocessing4all.py:871-879)."""
    for inst in instruments:
        name = f"TBs_{inst}"
        if name in ds:
            block = ds[name].data[:, elevation_index, :, :]
            ds[name].data[:, elevation_index, :, :] = \
                mwr.interpolate_azimuths(block)
    return ds


def replace_nan_lats_and_lons(ds: Dataset) -> Dataset:
    """Fill NaN coordinates from same-location neighbors
    (preprocessing4all.py:883-903)."""
    loc = ds["Location"].data
    for name in ("Latitude", "Longitude"):
        vals = ds[name].data
        for i in range(vals.size):
            if np.isnan(vals[i]):
                if i > 0 and np.isfinite(vals[i - 1]) and loc[i - 1] == loc[i]:
                    vals[i] = vals[i - 1]
                elif (i + 1 < vals.size and np.isfinite(vals[i + 1])
                      and loc[i + 1] == loc[i]):
                    vals[i] = vals[i + 1]
    return ds


def preprocess_files(sonde_files: list, campaign: str, location: str,
                     mwr_files: dict | None = None) -> Dataset:
    """Full L1 stage for one campaign/site batch of sonde files."""
    records = [process_sonde(f, campaign, location, mwr_files)
               for f in sorted(sonde_files)]
    ds = build_dataset(records)
    ds = clean_dataset(ds)
    ds = interpolate_azimuths(ds)
    ds = replace_nan_lats_and_lons(ds)
    return ds


def preprocess_campaigns(campaign_specs: list) -> Dataset:
    """Multi-campaign driver (the reference's __main__ loop over 5
    site/campaign globs, preprocessing4all.py:1251-1401).

    campaign_specs: [{"pattern": glob, "campaign": str, "location": str,
                      "mwr_files": {inst: [paths]} | None}, ...]
    """
    parts = []
    for spec in campaign_specs:
        files = sorted(globmod.glob(spec["pattern"]))
        if not files:
            continue
        parts.append(preprocess_files(files, spec["campaign"],
                                      spec["location"],
                                      spec.get("mwr_files")))
    if not parts:
        raise ValueError("no sonde files matched any pattern")
    return concat(parts, dim="time")


# -- bridge to the forward operators ----------------------------------------

def profiles_for_forward(ds: Dataset, crop: int = 0) -> dict:
    """Canonical dataset -> forward-operator profile dict (ground -> top).

    Returns {"z","p","t","rho","lwc"} as (time, N_Levels) float32 arrays —
    the input contract of models.lbl.forward_batch.  NaN profiles stay NaN
    (screened downstream exactly as the reference's check_for_nans,
    PyRTlib_processing.py:71-79).
    """
    flip = slice(None, None, -1)
    p = ds["Level_Pressure"].data[flip, :, crop].T.astype("f4")
    t = ds["Level_Temperature"].data[flip, :, crop].T.astype("f4")
    mr = ds["Level_H2O"].data[flip, :, crop].T.astype("f4")       # g/kg
    z = ds["Level_z"].data[flip, :, crop].T.astype("f4")
    liq = ds["Level_Liquid"].data[flip, :, crop].T.astype("f4")   # kg/kg

    e = (mr / 1000.0) * p / (0.622 + mr / 1000.0)                 # hPa
    rho = 216.679 * e / t                                          # g/m^3
    air_density = p * 100.0 / (287.04 * t)                         # kg/m^3
    lwc = np.nan_to_num(liq, nan=0.0) * air_density * 1000.0       # g/m^3
    return {"z": z, "p": p, "t": t, "rho": rho.astype("f4"),
            "lwc": lwc.astype("f4")}
