"""Synthetic raw campaign files for tests and demos.

The reference's validation data (FESSTVaL / Socles / Vital I radiosonde and
MWR NetCDFs) is not shipped with either repo, so this module fabricates
physically plausible raw files in the same on-disk dialects the ingest layer
supports — ARMS-style NetCDF (`Height/Temperature/Pressure/Humidity`),
DWD-style NetCDF (`zg/ta/pa/hur`, Pa), GRAW `*_Profile.txt` — plus HATPRO
L1 (TB) / L2 (retrieval) files, so the full preprocess -> forward -> evaluate
pipeline is exercisable end-to-end anywhere.
"""

from __future__ import annotations

import numpy as np

from ..constants import hatpro
from .dataset import Dataset
from . import netcdf


def synthetic_sounding(seed: int = 0, n_samples: int = 4000,
                       top_m: float = 18_000.0, cloudy: bool = True):
    """High-resolution raw sounding (ascending), ~2500+ samples like a real
    ascent; returns dict of arrays."""
    rng = np.random.default_rng(seed)
    z = np.linspace(92.0, top_m, n_samples)
    # add ~8 repeated ground samples (pre-launch clutter the crop logic eats)
    z = np.concatenate([np.full(8, z[0]) + rng.normal(0, 0.5, 8), z])
    t0 = 286.0 + rng.normal(0, 3.0)
    t = t0 - 6.2e-3 * np.minimum(z - z[0], 11_000.0) \
        - 1.0e-3 * np.maximum(z - z[0] - 11_000.0, 0.0) * 0.1
    t += np.cumsum(rng.normal(0, 0.03, z.size))
    p = 1008.0 * np.exp(-(z - 0.0) / 7900.0)
    rh = np.clip(70.0 + 10.0 * np.sin(z / 900.0) - z / 1200.0
                 + rng.normal(0, 2.0, z.size), 1.0, 99.0)
    if cloudy:
        in_cloud = (z > 1200.0) & (z < 2100.0)
        rh[in_cloud] = 96.5 + rng.normal(0, 0.5, in_cloud.sum())
    return {"z": z, "t": t, "p": p, "rh": rh,
            "lat": 52.17 + rng.normal(0, 0.01),
            "lon": 14.12 + rng.normal(0, 0.01)}


def write_sonde_nc_arms(path: str, seed: int = 0, **kw) -> str:
    """ARMS dialect: Height[m] / Temperature[K] / Pressure[hPa] / Humidity[%]."""
    s = synthetic_sounding(seed, **kw)
    ds = Dataset(attrs={"source": "synthetic radiosonde (ARMS dialect)"})
    n = s["z"].size
    ds["Height"] = (("Time",), s["z"].astype("f4"), {"units": "m"})
    ds["Temperature"] = (("Time",), s["t"].astype("f4"), {"units": "K"})
    ds["Pressure"] = (("Time",), s["p"].astype("f4"), {"units": "hPa"})
    ds["Humidity"] = (("Time",), s["rh"].astype("f4"), {"units": "%"})
    ds["Latitude"] = (("Time",), np.full(n, s["lat"], "f4"), {})
    ds["Longitude"] = (("Time",), np.full(n, s["lon"], "f4"), {})
    netcdf.write(path, ds)
    return path


def write_sonde_nc_dwd(path: str, seed: int = 0, **kw) -> str:
    """DWD dialect: zg[m] / ta[K] / pa[Pa] / hur[frac]."""
    s = synthetic_sounding(seed, **kw)
    ds = Dataset(attrs={"source": "synthetic radiosonde (DWD dialect)"})
    ds["zg"] = (("time",), s["z"].astype("f4"), {"units": "m"})
    ds["ta"] = (("time",), s["t"].astype("f4"), {"units": "K"})
    ds["pa"] = (("time",), (s["p"] * 100.0).astype("f4"), {"units": "Pa"})
    ds["hur"] = (("time",), (s["rh"] / 100.0).astype("f4"), {"units": "1"})
    ds["lat"] = (("time",), np.full(s["z"].size, s["lat"], "f4"), {})
    ds["lon"] = (("time",), np.full(s["z"].size, s["lon"], "f4"), {})
    ds["zsl_start"] = (("one",), np.array([s["z"][0]], "f4"), {})
    netcdf.write(path, ds)
    return path


def write_sonde_txt_graw(path: str, seed: int = 0, **kw) -> str:
    """GRAW `*_Profile.txt`: 20 header rows, whitespace table, 10 footer rows."""
    s = synthetic_sounding(seed, **kw)
    with open(path, "w") as fh:
        for i in range(20):
            fh.write(f"# synthetic GRAW header line {i}\n")
        for i in range(s["z"].size):
            fh.write(
                f"{i:6d} {s['p'][i]:9.2f} {s['t'][i]-273.15:8.2f} "
                f"{s['rh'][i]:7.2f} {5.0:6.1f} {180.0:6.1f} "
                f"{s['lon']:9.4f} {s['lat']:9.4f} {s['z'][i]:9.1f} "
                f"{s['z'][i]:9.1f} {5.0:5.1f} {45.0:7.2f} {90.0:7.2f} "
                f"{s['z'][i]*1.2:9.1f}\n")
        for i in range(10):
            fh.write(f"# synthetic GRAW footer line {i}\n")
    return path


def write_mwr_l1(path: str, launch: np.datetime64, seed: int = 0,
                 n_scans: int = 40) -> str:
    """HATPRO L1 file: TBs on a BL elevation scan around the launch time."""
    rng = np.random.default_rng(seed)
    base = launch.astype("datetime64[s]").astype("i8")
    times = base + rng.integers(-840, 840, n_scans)  # within 14 min
    times.sort()
    elevs = np.tile(hatpro.ELEVATIONS_DEG, int(np.ceil(n_scans / 10)))[:n_scans]
    azis = np.full(n_scans, 0.0)
    tbs = (30.0 + 220.0 * (1.0 - np.cos(np.deg2rad(90 - elevs)))[:, None]
           + rng.normal(0, 0.3, (n_scans, 14)))
    tbs = np.clip(tbs, 10.0, 310.0)
    ds = Dataset(attrs={"source": "synthetic HATPRO L1"})
    ds["time"] = (("time",), times.astype("f8"),
                  {"units": "seconds since 1970-01-01 00:00:00"})
    ds["ele"] = (("time",), elevs.astype("f4"), {"units": "degree"})
    ds["azi"] = (("time",), azis.astype("f4"), {"units": "degree"})
    ds["tb"] = (("time", "frequency"), tbs.astype("f4"), {"units": "K"})
    ds["frequency"] = (("frequency",), hatpro.HATPRO_FREQS_GHZ.astype("f4"),
                       {"units": "GHz"})
    ds["quality_flag"] = (("time",), np.zeros(n_scans, "i4"), {})
    netcdf.write(path, ds)
    return path


def write_mwr_l2(path: str, launch: np.datetime64, product: str = "ta",
                 seed: int = 0, n_times: int = 10, n_height: int = 93) -> str:
    """HATPRO L2 retrieval file (ta | hua | prw | clwvi)."""
    rng = np.random.default_rng(seed)
    base = launch.astype("datetime64[s]").astype("i8")
    times = np.sort(base + rng.integers(-840, 840, n_times))
    z = np.linspace(112.0, 10_000.0, n_height)
    ds = Dataset(attrs={"source": f"synthetic HATPRO L2 {product}"})
    ds["time"] = (("time",), times.astype("f8"),
                  {"units": "seconds since 1970-01-01 00:00:00"})
    if product in ("ta", "hua"):
        ds["height"] = (("height",), z.astype("f4"), {"units": "m"})
        if product == "ta":
            vals = 288.0 - 6.5e-3 * z[None, :] + rng.normal(0, 0.5, (n_times, n_height))
        else:
            vals = 8e-3 * np.exp(-z[None, :] / 2500.0) \
                + rng.normal(0, 2e-4, (n_times, n_height))
        ds[product] = (("time", "height"), vals.astype("f4"), {})
    elif product == "prw":
        ds["prw"] = (("time",), (20.0 + rng.normal(0, 1.0, n_times)).astype("f4"),
                     {"units": "kg m-2"})
    elif product == "clwvi":
        ds["clwvi"] = (("time",),
                       np.abs(rng.normal(0.02, 0.01, n_times)).astype("f4"),
                       {"units": "kg m-2"})
    netcdf.write(path, ds)
    return path


def forward_stage_dataset(n_time: int = 1000, n_levels: int = hatpro.N_LEVELS,
                          seed: int = 0) -> Dataset:
    """Harmonized dataset of `n_time` launches x 2 crops, the input
    `pipeline.forward_stage` reads, built directly from the demo profiles
    (`models.lbl.demo_profile`) without raw files: the unit of the forward-
    stage benchmark."""
    from ..models import lbl

    profs = {k: np.stack([lbl.demo_profile(n_levels, seed + i)[k]
                          for i in range(n_time)])
             for k in ("z", "p", "t", "rho", "lwc")}

    def lev_var(x):              # (B, L) ground -> top  ->  (L, B, 2) TOA -> gnd
        a = np.asarray(x).T[::-1]
        return np.repeat(a[:, :, None], 2, axis=2).astype("f4")

    p, t, rho = profs["p"], profs["t"], profs["rho"]
    e = rho * t / 216.679
    mr = 1000.0 * 0.622 * e / np.maximum(p - e, 1e-3)
    air = p * 100.0 / (287.04 * t)
    liq = profs["lwc"] / 1000.0 / air
    dims = ("N_Levels", "time", "Crop")
    ds = Dataset()
    ds["Level_Pressure"] = (dims, lev_var(p), {"units": "hPa"})
    ds["Level_Temperature"] = (dims, lev_var(t), {"units": "K"})
    ds["Level_H2O"] = (dims, lev_var(mr), {"units": "g/kg"})
    ds["Level_z"] = (dims, lev_var(profs["z"]), {"units": "m"})
    ds["Level_Liquid"] = (dims, lev_var(liq), {"units": "kg/kg"})
    return ds
