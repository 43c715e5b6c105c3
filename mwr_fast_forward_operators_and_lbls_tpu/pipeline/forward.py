"""Forward stage: harmonized dataset -> model brightness temperatures.

The L2 layer of the reference pipeline — three separate processes driving
PyRTlib in-process and RTTOV-gb / ARMS-gb through file protocols
(/root/reference/python_src/proc/{PyRTlib,RTTOV_gb,ARMS_gb}_processing.py) —
collapsed into one jitted batched computation per model on the device.

Output variables appended to the dataset (reference parity,
RTTOV_gb_processing.py:364-434 and PyRTlib_processing.py:161-195):

    TBs_LBL_<model>   (time, N_Channels, elevation, Crop)   [K]
    TBs_Fast          (time, N_Channels, elevation, Crop)   [K]
    ttrans_Fast       (time, N_Channels, elevation, Crop)   surface-to-space
    levtrans_Fast     (time, N_Channels, N_Levels, elevation, Crop)
    Jacobian_{T,ppmv,liq}_LBL (time, N_Channels, elevation, N_Levels, Crop)

NaN-profile screening follows the reference's validity protocol
(check_for_nans, PyRTlib_processing.py:71-79): invalid profiles produce NaN
outputs rather than aborting the batch.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import hatpro
from ..data import preprocess
from ..data.dataset import Dataset, Variable
from ..models import fast as fast_mod
from ..models import jacobians as jac_mod
from ..models import lbl as lbl_mod


def _valid_mask(profiles: dict) -> np.ndarray:
    """(B,) True where every level of every variable is finite."""
    mask = np.ones(profiles["z"].shape[0], bool)
    for v in profiles.values():
        mask &= np.isfinite(np.asarray(v)).all(axis=1)
    return mask


def _screen(profiles: dict):
    """Replace invalid profiles by a benign stand-in so the batched kernel
    stays NaN-free; caller masks the outputs back to NaN."""
    mask = _valid_mask(profiles)
    if mask.all():
        return profiles, mask
    good = int(np.argmax(mask)) if mask.any() else None
    out = {}
    for k, v in profiles.items():
        v = np.array(v, copy=True)
        if good is None:
            stand_in = np.linspace(1.0, 2.0, v.shape[1], dtype=v.dtype)
            if k == "p":
                stand_in = np.linspace(1000.0, 100.0, v.shape[1], dtype=v.dtype)
            if k == "t":
                stand_in = np.full(v.shape[1], 250.0, v.dtype)
            if k == "z":
                stand_in = np.linspace(0.0, 20000.0, v.shape[1], dtype=v.dtype)
            v[~mask] = stand_in
        else:
            v[~mask] = v[good]
        out[k] = v
    return out, mask


def _upload(profiles: dict, compress: bool):
    """Ship one crop's profile payload to the device, asynchronously.

    compress=False: plain fp32 device_put (async — the DMA overlaps any
    in-flight device compute, which is what lets `forward_stage` pipeline
    crop k+1's upload behind crop k's program).

    compress=True (opt-in): fp16 ANOMALY encoding — each variable is sent
    as (v - median_profile) in float16 plus the (L,) fp32 reference row.
    Straight bf16/fp16 would be useless (T ~ 300 K rounds to ~0.15-1 K
    steps), but the anomalies span only tens of units, so fp16's 11-bit
    mantissa keeps the reconstruction error ~1e-2 units — measured < 0.02 K
    in TB (tests/test_pipeline.py::test_compressed_upload_tb_budget)
    against the pipeline's 0.05 K accuracy budget — while halving the
    host->device bytes.  Whether that pays on a given host link is a
    measurement, not a default.
    """
    if not compress:
        return {k: jax.device_put(jnp.asarray(np.asarray(v, np.float32)))
                for k, v in profiles.items()}, None
    ref = {k: np.median(np.asarray(v, np.float32), axis=0)
           for k, v in profiles.items()}
    payload = {k: jax.device_put(jnp.asarray(
        (np.asarray(v, np.float32) - ref[k]).astype(np.float16)))
        for k, v in profiles.items()}
    ref_dev = {k: jax.device_put(jnp.asarray(r)) for k, r in ref.items()}
    return payload, ref_dev


@functools.partial(jax.jit, static_argnames=("models", "with_jacobians",
                                             "batch_size"))
def _stage_device(dev: dict, fast_params, models: tuple,
                  with_jacobians: bool, batch_size: int,
                  ref: dict | None = None):
    """The whole forward stage for one crop as ONE device program.

    Pads the time axis to a whole number of `batch_size` chunks, then
    `lax.map`s the per-chunk forward for every model (the chunk body
    compiles once; the map serializes chunks on device with no host
    round-trip between them).  Every output stays device-resident; the
    caller issues a single `device_get` at the end — one dispatch and one
    pull per crop instead of one per chunk.  This is the unit the
    `forward_stage_device_ms` bench metric times.

    `ref`: per-variable (L,) fp32 reference rows for the fp16-anomaly
    payload (see `_upload`); reconstruction happens here on device.
    """
    if ref is not None:
        dev = {k: v.astype(jnp.float32) + ref[k][None, :]
               for k, v in dev.items()}
    n = dev["z"].shape[0]
    pad = (-n) % batch_size
    padded = {k: (jnp.concatenate([v, jnp.repeat(v[-1:], pad, axis=0)])
                  if pad else v) for k, v in dev.items()}
    chunks = {k: v.reshape(-1, batch_size, v.shape[1])
              for k, v in padded.items()}

    def unpad(x):  # (n_chunks, B, ...) -> (n, ...)
        return x.reshape(-1, *x.shape[2:])[:n]

    out = {"lbl": {}}
    for m in models:
        cfg = lbl_mod.LBLConfig(model=m, outputs=("tb",))
        mapped = jax.lax.map(lambda c, _cfg=cfg: lbl_mod.forward_batch(
            c, _cfg)["tb"], chunks)
        out["lbl"][m] = unpad(mapped)                        # (n, E, F)
    if fast_params is not None:
        fcfg = fast_mod.FastConfig()
        mapped = jax.lax.map(
            lambda c: fast_mod.fast_forward_batch(fast_params, c, fcfg),
            chunks)
        out["fast"] = {
            "tb": unpad(mapped["tb"]),
            "ttrans": jnp.exp(-unpad(mapped["tau_total"])),
            "levtrans": unpad(mapped["trans_level"]),
        }
    if with_jacobians:
        kcfg = lbl_mod.LBLConfig(model=models[-1])
        mapped = jax.lax.map(lambda c: jac_mod.kmatrix_batch_fast(
            c, kcfg, wrt=("t", "rho", "lwc")), chunks)
        out["jac"] = {name: unpad(v) for name, v in mapped.items()}
    return out


def forward_stage(ds: Dataset,
                  models: tuple = ("R98", "R17", "R20", "R24"),
                  fast_params: dict | None = None,
                  with_jacobians: bool = False,
                  batch_size: int = 256,
                  compress_upload: bool = False) -> Dataset:
    """Run the native LBL (all `models`) and optionally the fast operator and
    K-matrix over every (time, Crop) profile at the 10 BL-scan elevations;
    append results to `ds` in the reference layout.

    compress_upload: opt-in fp16-anomaly payload encoding (see `_upload`) —
    halves the host->device bytes at a measured < 0.02 K TB cost."""
    n_time = ds.dims["time"]
    n_lev = ds.dims["N_Levels"]
    nc, ne = hatpro.N_CHANNELS, hatpro.N_ELEVATIONS

    lbl_out = {m: np.full((n_time, nc, ne, 2), np.nan, "f4") for m in models}
    fast_tb = np.full((n_time, nc, ne, 2), np.nan, "f4")
    fast_ttrans = np.full((n_time, nc, ne, 2), np.nan, "f4")
    fast_levtrans = np.full((n_time, nc, n_lev, ne, 2), np.nan, "f4")
    jac = {name: np.full((n_time, nc, ne, n_lev, 2), np.nan, "f4")
           for name in ("t", "rho", "lwc")} if with_jacobians else {}

    # Upload + dispatch BOTH crops before pulling either result: device_put
    # and jit dispatch are asynchronous, so crop 1's host->device DMA and
    # program overlap crop 0's device compute, and crop 0's result pull
    # overlaps crop 1's compute — the stage wall becomes
    # ~ max(total upload, total compute) + one pull instead of their sum.
    bs = min(batch_size, max(n_time, 1))
    inflight = []
    for crop in (0, 1):
        raw = preprocess.profiles_for_forward(ds, crop=crop)
        profiles, mask = _screen(raw)
        if not mask.any():
            continue
        dev, ref = _upload(profiles, compress_upload)
        inflight.append((crop, mask, _stage_device(
            dev, fast_params, tuple(models), bool(with_jacobians),
            bs, ref)))

    for crop, mask, res_dev in inflight:
        res = jax.device_get(res_dev)
        for m in models:
            tb = np.array(res["lbl"][m])        # (n, E, F) — writable copy
            tb[~mask] = np.nan
            lbl_out[m][..., crop] = np.transpose(tb, (0, 2, 1))
        if fast_params is not None:
            tb = np.array(res["fast"]["tb"])
            tt = np.array(res["fast"]["ttrans"])
            lt = np.array(res["fast"]["levtrans"])
            tb[~mask] = np.nan
            tt[~mask] = np.nan
            lt[~mask] = np.nan
            fast_tb[..., crop] = np.transpose(tb, (0, 2, 1))
            fast_ttrans[..., crop] = np.transpose(tt, (0, 2, 1))
            fast_levtrans[..., crop] = np.transpose(lt, (0, 2, 3, 1))
        if with_jacobians:
            for name in jac:
                kk = np.array(res["jac"][name])     # (n, E, F, L)
                kk[~mask] = np.nan
                jac[name][..., crop] = np.transpose(kk, (0, 2, 1, 3))

    mdims = ("time", "N_Channels", "elevation", "Crop")
    for m in models:
        ds[f"TBs_LBL_{m}"] = Variable(
            mdims, lbl_out[m],
            {"units": "K",
             "long_name": f"native LBL brightness temperatures ({m} "
                          "absorption)",
             "comment": "replaces TBs_PyRTlib_" + m})
    if fast_params is not None:
        ds["TBs_Fast"] = Variable(mdims, fast_tb, {
            "units": "K",
            "long_name": "fast predictor-regression operator TBs",
            "comment": "replaces TBs_RTTOV_gb / TBs_ARMS_gb"})
        ds["ttrans_Fast"] = Variable(mdims, fast_ttrans, {
            "long_name": "surface-to-space transmittance"})
        ds["levtrans_Fast"] = Variable(
            ("time", "N_Channels", "N_Levels", "elevation", "Crop"),
            fast_levtrans, {"long_name": "level-to-surface transmittance"})
    name_map = {"t": "T", "rho": "rho", "lwc": "liq"}
    for name, arr in jac.items():
        ds[f"Jacobian_{name_map[name]}_LBL"] = Variable(
            ("time", "N_Channels", "elevation", "N_Levels", "Crop"), arr,
            {"long_name": f"dTB/d{name} K-matrix (autodiff)",
             "comment": "replaces Jacobian_*_RTTOV_gb (Fortran adjoint)"})
    return ds
