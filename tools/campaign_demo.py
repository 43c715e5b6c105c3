"""Campaign-scale end-to-end proof run: ~520 sondes x 3 campaigns through
the COMPLETE chain on real hardware.

The reference demonstrably processed ~520 matched sondes x 2 crops x 10
elevations through preprocess -> ARMS -> RTTOV -> PyRTlib -> summarize ->
plots (/root/reference/run_all_procs.sh:1-12, sequential CPU Python, with
the author noting the LBL stage alone as "very slow",
PyRTlib_processing.py:84).  This tool fabricates a same-scale synthetic
multi-campaign raw archive (the real FESSTVaL/Socles/Vital-I files are not
distributable), then runs this framework's in-process equivalent with
per-stage wall-clock accounting:

    generate raws -> preprocess (3 campaign globs, MWR matching, cloud
    water) -> distill fast operator -> forward (4 LBL releases + fast
    operator, single device dispatch per crop) -> analysis dataset ->
    FULL evaluation matrix (campaign x location x seasonal window x sky)

and writes a summary (`--summary`) with stage timings and
artifact counts.

Run:  python tools/campaign_demo.py [--n-sondes 520] [--workdir /tmp/...]
      [--models R98,R17,R20,R24] [--keep-raws]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mwr_fast_forward_operators_and_lbls_tpu.data import (  # noqa: E402
    netcdf, preprocess, synthetic)

CAMPAIGNS = [
    # (campaign, location, instrument, share of sondes)
    ("FESSTVaL", "Falkenberg", "foghat", 0.40),
    ("Socles", "Lindenberg", "sunhat", 0.30),
    ("Vital-I", "Juelich", "joyhat", 0.30),
]


def generate_raws(root: str, n_sondes: int, seed0: int = 0) -> list:
    """Write the synthetic raw archive; returns preprocess_campaigns specs."""
    rng = np.random.default_rng(seed0)
    # launches spread over May-July so the seasonal windows are populated
    t_start = np.datetime64("2024-05-02T00:00:00")
    t_end = np.datetime64("2024-07-30T00:00:00")
    span_s = (t_end - t_start) / np.timedelta64(1, "s")
    specs = []
    k = 0
    for ci, (camp, loc, inst, share) in enumerate(CAMPAIGNS):
        n = int(round(n_sondes * share))
        cdir = os.path.join(root, camp)
        os.makedirs(cdir, exist_ok=True)
        mwr_paths = []
        for i in range(n):
            launch = (t_start + np.timedelta64(
                int(span_s * (i + 0.5) / n + rng.integers(-3600, 3600)), "s")
            ).astype("datetime64[s]")
            stamp = (str(launch).replace("-", "").replace(":", "")
                     .replace("T", "_"))
            synthetic.write_sonde_nc_arms(
                os.path.join(cdir, f"{stamp}.nc"), seed=seed0 + k,
                cloudy=bool(k % 3))   # ~2/3 cloudy, 1/3 clear
            mwr_paths.append(synthetic.write_mwr_l1(
                os.path.join(cdir, f"mwr_l1_{i:04d}.nc"), launch,
                seed=seed0 + k))
            mwr_paths.append(synthetic.write_mwr_l2(
                os.path.join(cdir, f"mwr_l2_prw_{i:04d}.nc"), launch,
                product="prw", seed=seed0 + k))
            mwr_paths.append(synthetic.write_mwr_l2(
                os.path.join(cdir, f"mwr_l2_clwvi_{i:04d}.nc"), launch,
                product="clwvi", seed=seed0 + k))
            k += 1
        specs.append({"pattern": os.path.join(cdir, "2024*_*.nc"),
                      "campaign": camp, "location": loc,
                      "mwr_files": {inst: sorted(mwr_paths)}})
    return specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-sondes", type=int, default=520)
    ap.add_argument("--workdir", default="/tmp/mwr_campaign_demo")
    ap.add_argument("--models", default="R98,R17,R20,R24")
    ap.add_argument("--summary", default=None,
                    help="write the markdown summary here")
    ap.add_argument("--keep-raws", action="store_true")
    args = ap.parse_args(argv)

    import jax  # deferred so --help works without a backend

    from mwr_fast_forward_operators_and_lbls_tpu.parallel import (
        compile_cache)

    from mwr_fast_forward_operators_and_lbls_tpu.eval import report
    from mwr_fast_forward_operators_and_lbls_tpu.models import fast
    from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
        forward_stage, merge)

    os.makedirs(args.workdir, exist_ok=True)
    # persistent compile cache: reruns skip first-compiles
    cache_dir = compile_cache.enable()
    cache_warm = compile_cache.entry_count(cache_dir)
    raws = os.path.join(args.workdir, "raw")
    timings = {}
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    specs = generate_raws(raws, args.n_sondes)
    timings["generate_raws_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = preprocess.preprocess_campaigns(specs)
    harmonized = os.path.join(args.workdir, "harmonized.nc")
    netcdf.write(harmonized, ds)
    timings["preprocess_s"] = time.perf_counter() - t0
    dims = dict(ds.dims)
    print(f"preprocess: {dims}  ({timings['preprocess_s']:.1f} s)")

    t0 = time.perf_counter()
    params = fast.distill_on_dataset(ds, fast.FastConfig())
    timings["distill_s"] = time.perf_counter() - t0
    print(f"distill: {timings['distill_s']:.1f} s")

    models = tuple(args.models.split(","))
    t0 = time.perf_counter()
    ds = forward_stage(ds, models=models, fast_params=params)
    results = os.path.join(args.workdir, "results.nc")
    netcdf.write(results, ds)
    timings["forward_s"] = time.perf_counter() - t0
    n_spectra = dims["time"] * 2 * 10 * (len(models) + 1)
    print(f"forward: {len(models)} LBL models + fast, {n_spectra} spectra "
          f"({timings['forward_s']:.1f} s incl. NetCDF write)")

    t0 = time.perf_counter()
    ds = merge.analysis_dataset(ds)
    analysis = os.path.join(args.workdir, "analysis.nc")
    netcdf.write(analysis, ds)
    timings["analysis_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    manifest = report.full_report(ds, os.path.join(args.workdir, "matrix"))
    timings["full_report_s"] = time.perf_counter() - t0
    timings["total_s"] = time.perf_counter() - t_all

    summary = {
        "n_sondes_requested": args.n_sondes,
        "dims": dims,
        "backend": jax.default_backend(),
        "compile_cache_entries_at_start": cache_warm,
        "compile_cache_entries_at_end": compile_cache.entry_count(cache_dir),
        "models": list(models) + ["Fast"],
        "n_forward_spectra": n_spectra,
        "matrix_cells": len(manifest["cells"]),
        "matrix_figures": manifest["n_figures_total"],
        "matrix_skipped_empty": len(manifest["skipped"]),
        "timings_s": {k: round(v, 1) for k, v in timings.items()},
    }
    print(json.dumps(summary))

    if args.summary:
        camps = ", ".join(f"{c} ({loc})" for c, loc, _, _ in CAMPAIGNS)
        with open(args.summary, "w") as fh:
            fh.write(
                "# Campaign-scale end-to-end run\n\n"
                f"Synthetic multi-campaign archive — {camps} — at the "
                "reference's production scale (~520 matched sondes x 2 "
                "crops x 10 elevations, run_all_procs.sh:1-12), through "
                "preprocess -> distill -> forward (4 LBL releases + fast "
                "operator) -> analysis -> full evaluation matrix.\n\n"
                f"```json\n{json.dumps(summary, indent=1)}\n```\n\n"
                "Stage notes: `preprocess` includes per-sonde MWR scan "
                "matching, thinning, climatology extension and Nandan "
                "cloud-water derivation on the host; `forward` is one "
                "device program per crop (all chunks x all models) plus "
                "the NetCDF write; `full_report` renders every "
                "campaign x location x window x sky cell with figures + "
                "per-elevation stats CSVs.\n")
        print(f"wrote {args.summary}")
    if not args.keep_raws:
        shutil.rmtree(raws, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
