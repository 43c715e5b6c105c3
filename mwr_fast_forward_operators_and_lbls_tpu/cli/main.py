"""Command-line interface: preprocess | forward | distill | evaluate.

Replaces the reference's bash-driven process chain (run_all_procs.sh ->
per-stage argparse scripts with hard-coded home-directory defaults,
/root/reference/run_all_procs.sh:1-12) with one typed entry point.  The
author's own TODO asked for exactly this ("hard-coded params should be
argparse", /root/reference/Issues_2025_Dec.txt:3-8): channels, angles, grid
size, and model selection all live in `PipelineConfig`.
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import sys
from dataclasses import asdict, dataclass, field


@dataclass
class PipelineConfig:
    """The single typed configuration for every stage."""

    models: tuple = ("R98", "R17", "R20", "R24")
    elevations_deg: tuple = (90.0, 30.0, 19.2, 14.4, 11.4, 8.4, 6.6, 5.4,
                             4.8, 4.2)
    n_levels: int = 180
    batch_size: int = 256
    with_jacobians: bool = False
    compat_aliases: bool = False
    distill_steps: int = 0
    teacher_model: str = "R24"

    @classmethod
    def from_args(cls, args) -> "PipelineConfig":
        kw = {}
        for f in ("models", "batch_size", "with_jacobians", "compat_aliases",
                  "distill_steps", "teacher_model"):
            if getattr(args, f, None) is not None:
                kw[f] = getattr(args, f)
        if isinstance(kw.get("models"), str):
            kw["models"] = tuple(kw["models"].split(","))
        return cls(**kw)


def _parse_mwr_specs(specs: list) -> dict:
    """["joyhat=/path/glob", ...] -> {instrument: [files]}"""
    out = {}
    for spec in specs or []:
        inst, pattern = spec.split("=", 1)
        out.setdefault(inst, []).extend(sorted(globmod.glob(pattern)))
    return out


def _nc_fmt(args) -> str:
    """Output dialect: --nc4 selects NetCDF-4/HDF5, the reference's own
    default output format (preprocessing4all.py:1397-1401)."""
    return "netcdf4" if getattr(args, "nc4", False) else "classic"


def cmd_preprocess(args) -> int:
    from ..data import netcdf, preprocess

    files = sorted(globmod.glob(args.sondes))
    if not files:
        print(f"no sonde files match {args.sondes!r}", file=sys.stderr)
        return 1
    ds = preprocess.preprocess_files(
        files, args.campaign, args.location,
        mwr_files=_parse_mwr_specs(args.mwr) or None)
    netcdf.write(args.output, ds, fmt=_nc_fmt(args))
    print(f"wrote {args.output}: {ds.dims}")
    return 0


def cmd_forward(args) -> int:
    from ..data import netcdf
    from ..models import fast
    from ..pipeline import forward_stage

    cfg = PipelineConfig.from_args(args)
    ds = netcdf.read(args.input)
    params = None
    if args.fast_params:
        params = fast.load_params(args.fast_params)
    elif args.distill:
        params = fast.distill_on_dataset(
            ds, fast.FastConfig(teacher_model=cfg.teacher_model),
            steps=cfg.distill_steps)
    ds = forward_stage(ds, models=cfg.models, fast_params=params,
                       with_jacobians=cfg.with_jacobians,
                       batch_size=cfg.batch_size)
    if cfg.compat_aliases:
        from ..eval import deviations
        ds = deviations.compat_aliases(ds)
    netcdf.write(args.output, ds, fmt=_nc_fmt(args))
    print(f"wrote {args.output} with models {cfg.models}"
          + (" + fast operator" if params is not None else ""))
    return 0


def cmd_distill(args) -> int:
    from ..data import netcdf
    from ..models import fast

    cfg = PipelineConfig.from_args(args)
    ds = netcdf.read(args.input)
    params = fast.distill_on_dataset(
        ds, fast.FastConfig(teacher_model=cfg.teacher_model),
        steps=cfg.distill_steps)
    fast.save_params(params, args.output)
    print(f"wrote fast-operator coefficients to {args.output}")
    return 0


def cmd_evaluate(args) -> int:
    from ..data import netcdf
    from ..eval import plots, report, sky
    from ..pipeline import merge

    ds = netcdf.read(args.input)
    external = None
    if getattr(args, "mlnn", None):
        # External MLNN retrieval cloud-flag product as the primary flag
        # source (x_analysis_script_MARCH26.py:82-97).
        external = sky.read_external_cloud_flags(args.mlnn, ds["time"].data)
        n_cov = 0 if external is None else int(
            (~__import__("numpy").isnan(external[:, 0])).sum())
        print(f"MLNN cloud flags: {n_cov}/{ds.dims['time']} timesteps "
              f"covered from {args.mlnn!r}")
    ds = merge.analysis_dataset(ds, external_cloud_flag=external,
                                compat=args.compat_aliases or False)
    if args.output:
        netcdf.write(args.output, ds, fmt=_nc_fmt(args))
        print(f"wrote analysis dataset {args.output}")
    if args.start or args.end:
        # Seasonal re-analysis windows (May-dry / June-July-humid loops,
        # multi_campaign_plots_and_ana.py:1212-1348).
        import numpy as np
        t = np.asarray(ds["time"].data, np.float64)
        lo = args.start or "1970-01-01"
        hi = args.end or "2200-01-01"
        ds = report.select_time_window(ds, np.datetime64(lo),
                                       np.datetime64(hi))
        print(f"time window {lo}..{hi}: {ds.dims['time']} launches")
    if getattr(args, "full", False):
        # The complete reference analysis matrix: campaign x location x
        # seasonal window x sky, figures + per-elevation stats CSV per cell
        # (multi_campaign_plots_and_ana.py:1047-1348).
        manifest = report.full_report(ds, args.outdir)
        print(f"full matrix: {len(manifest['cells'])} cells, "
              f"{manifest['n_figures_total']} figures, "
              f"{len(manifest['skipped'])} empty cells skipped; "
              f"manifest at {args.outdir}/manifest.json")
        return 0
    if args.sky != "all":
        # Clear/cloudy stratification (clear_sky_dataset,
        # multi_campaign_plots_and_ana.py:103-151).
        clear, cloudy = sky.split_clear_cloudy(ds)
        ds = clear if args.sky == "clear" else cloudy
        print(f"{args.sky}-sky subset: {ds.dims['time']} launches")
    paths = plots.standard_report(ds, args.outdir)
    if args.per_sonde:
        ref = "TBs_LBL_R24" if "TBs_LBL_R24" in ds else None
        # model-output layout only (time, N_Channels, ...) — MWR observation
        # TBs are (time, elevation, azimuth, N_Channels) and don't belong in
        # the per-channel bias panel.
        model_tbs = [n for n in ds
                     if n.startswith("TBs_") and n != ref
                     and ds[n].dims[:2] == ("time", "N_Channels")][:4]
        if ref and model_tbs:
            paths += report.per_sonde_report(
                ds, model_tbs, ref, f"{args.outdir}/per_sonde",
                max_sondes=args.per_sonde)
    if args.stats_csv:
        rows = report.stats_table(ds)
        report.write_stats_csv(rows, args.stats_csv)
        print(f"wrote stats CSV {args.stats_csv}")
    print(f"wrote {len(paths)} figures to {args.outdir}")
    return 0


def cmd_retrieve(args) -> int:
    """OEM retrieval of (T, rho) profiles from a dataset's observed TBs."""
    import numpy as np

    from ..data import netcdf, preprocess
    from ..data.dataset import Variable
    from ..models import fast, retrieval

    ds = netcdf.read(args.input)
    params = fast.load_params(args.fast_params)
    raw = preprocess.profiles_for_forward(ds, crop=0)
    tb_name = args.tb_var
    if tb_name not in ds:
        print(f"variable {tb_name!r} not in dataset", file=sys.stderr)
        return 1
    import jax.numpy as jnp

    tb = np.asarray(ds[tb_name].data, np.float64)  # (time, chan, elev[, crop])
    if tb.ndim == 4:
        tb = tb[..., 0]
    ocfg = retrieval.OEMConfig()
    n = tb.shape[0]
    t_out = np.full((n, raw["z"].shape[1]), np.nan, "f4")
    rho_out = np.full_like(t_out, np.nan)
    # One vmapped device program over all valid launches instead of one
    # dispatch per profile.
    obs = np.transpose(tb, (0, 2, 1))      # (time, elev, chan)
    valid = np.isfinite(obs).all(axis=(1, 2))
    for k in ("z", "p", "t", "rho"):
        valid &= np.isfinite(np.asarray(raw[k], np.float64)).all(axis=1)
    idx = np.where(valid)[0]
    if idx.size:
        lwc = raw.get("lwc")
        out = retrieval.retrieve_batch(
            params, jnp.asarray(obs[idx], jnp.float32),
            jnp.asarray(np.asarray(raw["z"])[idx]),
            jnp.asarray(np.asarray(raw["p"])[idx]),
            jnp.asarray(np.asarray(raw["t"])[idx]),
            jnp.asarray(np.asarray(raw["rho"])[idx]), ocfg,
            None if lwc is None else jnp.asarray(np.asarray(lwc)[idx]))
        t_out[idx] = np.asarray(out["t"])
        rho_out[idx] = np.asarray(out["rho"])
    ds["Retrieved_T"] = Variable(("time", "N_Levels"), t_out,
                                 {"units": "K", "long_name":
                                  "1D-Var retrieved temperature"})
    ds["Retrieved_rho"] = Variable(("time", "N_Levels"), rho_out,
                                   {"units": "g m-3", "long_name":
                                    "1D-Var retrieved vapor density"})
    netcdf.write(args.output, ds)
    print(f"wrote {args.output} with Retrieved_T/Retrieved_rho")
    return 0


def cmd_spectral(args) -> int:
    """High-res monochromatic spectra for every profile in a dataset."""
    import numpy as np

    from ..data import netcdf, preprocess
    from ..data.dataset import Dataset, Variable
    from ..models import spectral as spec_mod

    import jax.numpy as jnp

    ds = netcdf.read(args.input)
    raw = preprocess.profiles_for_forward(ds, crop=0)
    mask = np.ones(raw["z"].shape[0], bool)
    for v in raw.values():
        mask &= np.isfinite(np.asarray(v)).all(axis=1)
    profiles = {k: jnp.asarray(np.asarray(v)[mask]) for k, v in raw.items()}
    f = jnp.linspace(args.f_min, args.f_max, args.n_freqs)
    out = spec_mod.forward_spectral(profiles, f, (args.elevation,),
                                    args.model, freq_chunk=args.chunk)
    res = Dataset()
    res["frequency"] = (("frequency",), np.asarray(f, "f8"),
                        {"units": "GHz"})
    res["TB_spectrum"] = Variable(
        ("time", "frequency"), np.asarray(out["tb"][:, 0, :], "f4"),
        {"units": "K", "long_name":
         f"monochromatic downwelling TB, {args.model}, "
         f"{args.elevation} deg elevation"})
    res["tau_spectrum"] = Variable(
        ("time", "frequency"), np.asarray(out["tau_total"][:, 0, :], "f4"),
        {"long_name": "total slant opacity"})
    netcdf.write(args.output, res)
    print(f"wrote {args.output}: {int(mask.sum())} profiles x "
          f"{args.n_freqs} frequencies")
    return 0


def cmd_bench(args) -> int:
    """One-chip throughput + scaling sweep (JSON lines)."""
    from ..parallel import scaling

    for row in scaling.measure(per_device_batch=args.batch):
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in row.items()}))
    return 0


def cmd_simulate_rttov(args) -> int:
    """Drop-in for the RTTOV-gb executable: prof_plev.dat -> output report
    (text protocol of RTTOV_gb_processing.py:80-305)."""
    from ..interop import rttov_gb

    results = rttov_gb.simulate_profiles_dat(
        args.input, args.output, n_levels=args.n_levels, model=args.model,
        want_jacobians=not args.no_jacobians)
    print(f"wrote {args.output}: {len(results)} profiles (TBs, "
          f"transmittances{', K-matrix' if not args.no_jacobians else ''})")
    return 0


def cmd_simulate_arms(args) -> int:
    """Drop-in for ARMS-gb FWD_Test: input NetCDF -> Sim_BT filled
    (NetCDF protocol of ARMS_gb_processing.py:103-297)."""
    from ..interop import arms_gb

    sim = arms_gb.simulate_input_nc(args.input, args.output,
                                    model=args.model,
                                    include_o3=args.with_o3)
    print(f"wrote {args.output}: Sim_BT {sim.shape}")
    return 0


def cmd_run_all(args) -> int:
    """End-to-end pipeline in one process: preprocess -> forward (all
    models [+ fast distillation] [+ Jacobians]) -> analysis dataset ->
    figure report + stats CSV.

    The in-process, typed replacement of the reference's bash chain
    (run_all_procs.sh:3-10: preproc -> ARMS -> RTTOV -> PyRTlib ->
    summarize -> plots, each a separate Python process communicating
    through NetCDF files).  Stage outputs are still written to the work
    directory so any stage can be re-run or inspected independently
    (the reference's stage-level checkpoint model, SURVEY.md section 5)."""
    import os
    import time as _time

    from ..data import netcdf, preprocess
    from ..eval import plots, report
    from ..models import fast
    from ..pipeline import forward_stage, merge

    cfg = PipelineConfig.from_args(args)
    os.makedirs(args.workdir, exist_ok=True)
    log_path = os.path.join(args.workdir, "run_all.log")
    log_fh = open(log_path, "a")

    def log(msg):
        line = f"[{_time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line)
        log_fh.write(line + "\n")
        log_fh.flush()

    t0 = _time.time()
    harmonized = os.path.join(args.workdir, "harmonized.nc")
    if args.resume and os.path.exists(harmonized):
        log(f"resume: reading existing {harmonized}")
        ds = netcdf.read(harmonized)
    else:
        files = sorted(globmod.glob(args.sondes))
        if not files:
            print(f"no sonde files match {args.sondes!r}", file=sys.stderr)
            return 1
        log(f"preprocess: {len(files)} sonde files")
        ds = preprocess.preprocess_files(
            files, args.campaign, args.location,
            mwr_files=_parse_mwr_specs(args.mwr) or None)
        netcdf.write(harmonized, ds)
        log(f"preprocess done: {ds.dims} -> {harmonized}")

    params = None
    if args.distill:
        log(f"distill: teacher {cfg.teacher_model}")
        params = fast.distill_on_dataset(
            ds, fast.FastConfig(teacher_model=cfg.teacher_model),
            steps=cfg.distill_steps)
        fast.save_params(params, os.path.join(args.workdir, "fast_params.npz"))
    log(f"forward: models {cfg.models}"
        + (" + fast operator" if params is not None else ""))
    ds = forward_stage(ds, models=cfg.models, fast_params=params,
                       with_jacobians=cfg.with_jacobians,
                       batch_size=cfg.batch_size)
    if cfg.compat_aliases:
        from ..eval import deviations
        ds = deviations.compat_aliases(ds)
    results = os.path.join(args.workdir, "results.nc")
    netcdf.write(results, ds)
    log(f"forward done -> {results}")

    ds = merge.analysis_dataset(ds, compat=cfg.compat_aliases)
    analysis = os.path.join(args.workdir, "analysis.nc")
    netcdf.write(analysis, ds)
    log(f"analysis dataset -> {analysis}")

    outdir = os.path.join(args.workdir, "plots")
    if getattr(args, "full", False):
        manifest = report.full_report(ds, outdir)
        log(f"report: full matrix, {len(manifest['cells'])} cells / "
            f"{manifest['n_figures_total']} figures -> {outdir}")
        paths = []
    else:
        paths = plots.standard_report(ds, outdir)
    rows = report.stats_table(ds)
    csv_path = report.write_stats_csv(
        rows, os.path.join(args.workdir, "stats.csv"))
    log(f"report: {len(paths)} figures -> {outdir}; stats -> {csv_path}")
    log(f"run-all complete in {_time.time() - t0:.1f} s")
    log_fh.close()
    return 0


def cmd_config(args) -> int:
    print(json.dumps(asdict(PipelineConfig()), indent=2, default=list))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mwr",
        description="ground-based MWR radiative-transfer pipeline (JAX)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("preprocess", help="raw files -> harmonized dataset")
    sp.add_argument("--sondes", required=True, help="radiosonde glob")
    sp.add_argument("--campaign", default="campaign")
    sp.add_argument("--location", default="site")
    sp.add_argument("--mwr", action="append",
                    help="instrument=glob (repeatable)")
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--nc4", action="store_true",
                    help="write NetCDF-4/HDF5 instead of classic")
    sp.set_defaults(fn=cmd_preprocess)

    sf = sub.add_parser("forward", help="harmonized dataset -> model TBs")
    sf.add_argument("-i", "--input", required=True)
    sf.add_argument("-o", "--output", required=True)
    sf.add_argument("--models", default=None,
                    help="comma list, e.g. R98,R17,R20,R24")
    sf.add_argument("--fast-params", default=None,
                    help="npz with fast-operator coefficients")
    sf.add_argument("--distill", action="store_true",
                    help="fit the fast operator on this dataset first")
    sf.add_argument("--with-jacobians", dest="with_jacobians",
                    action="store_true", default=None)
    sf.add_argument("--compat", dest="compat_aliases", action="store_true",
                    default=None, help="add reference-schema variable names")
    sf.add_argument("--batch-size", type=int, default=None)
    sf.add_argument("--nc4", action="store_true",
                    help="write NetCDF-4/HDF5 instead of classic")
    sf.set_defaults(fn=cmd_forward)

    sd = sub.add_parser("distill", help="train fast-operator coefficients")
    sd.add_argument("-i", "--input", required=True)
    sd.add_argument("-o", "--output", required=True)
    sd.add_argument("--steps", dest="distill_steps", type=int, default=None)
    sd.add_argument("--teacher", dest="teacher_model", default=None)
    sd.set_defaults(fn=cmd_distill)

    se = sub.add_parser("evaluate", help="analysis dataset + figure report")
    se.add_argument("-i", "--input", required=True)
    se.add_argument("-o", "--output", default=None,
                    help="optionally write the analysis NetCDF")
    se.add_argument("--outdir", default="plots")
    se.add_argument("--compat", dest="compat_aliases", action="store_true",
                    default=None)
    se.add_argument("--full", action="store_true",
                    help="emit the complete reference analysis matrix: "
                         "campaign x location x seasonal window x sky, "
                         "figures + per-elevation stats CSV per cell "
                         "(multi_campaign_plots_and_ana.py:1047-1348)")
    se.add_argument("--sky", choices=("all", "clear", "cloudy"),
                    default="all", help="clear/cloudy stratification")
    se.add_argument("--start", default=None,
                    help="analysis window start (YYYY-MM-DD)")
    se.add_argument("--end", default=None,
                    help="analysis window end (YYYY-MM-DD)")
    se.add_argument("--per-sonde", dest="per_sonde", type=int, default=0,
                    help="also write per-sonde bias figures for N launches")
    se.add_argument("--stats-csv", dest="stats_csv", default=None,
                    help="write the per-channel stats table as CSV")
    se.add_argument("--mlnn", default=None,
                    help="glob of external MLNN cloud-flag NetCDFs "
                         "(primary source for cloud_flag)")
    se.add_argument("--nc4", action="store_true",
                    help="write NetCDF-4/HDF5 instead of classic")
    se.set_defaults(fn=cmd_evaluate)

    sr = sub.add_parser("retrieve",
                        help="1D-Var (T, rho) retrieval from observed TBs")
    sr.add_argument("-i", "--input", required=True)
    sr.add_argument("-o", "--output", required=True)
    sr.add_argument("--fast-params", required=True,
                    help="npz with fast-operator coefficients")
    sr.add_argument("--tb-var", default="TBs_Fast",
                    help="TB variable to invert (time, chan, elev[, crop])")
    sr.set_defaults(fn=cmd_retrieve)

    ss = sub.add_parser("spectral", help="high-res monochromatic spectra")
    ss.add_argument("-i", "--input", required=True)
    ss.add_argument("-o", "--output", required=True)
    ss.add_argument("--f-min", type=float, default=20.0)
    ss.add_argument("--f-max", type=float, default=64.0)
    ss.add_argument("--n-freqs", type=int, default=50000)
    ss.add_argument("--elevation", type=float, default=90.0)
    ss.add_argument("--model", default="R24")
    ss.add_argument("--chunk", type=int, default=4096)
    ss.set_defaults(fn=cmd_spectral)

    sb = sub.add_parser("bench", help="throughput + scaling sweep")
    sb.add_argument("--batch", type=int, default=256,
                    help="per-device profile batch")
    sb.set_defaults(fn=cmd_bench)

    srt = sub.add_parser("simulate-rttov",
                         help="act as RTTOV-gb: prof_plev.dat -> report")
    srt.add_argument("-i", "--input", required=True)
    srt.add_argument("-o", "--output", required=True)
    srt.add_argument("--n-levels", type=int, default=180)
    srt.add_argument("--model", default="R24")
    srt.add_argument("--no-jacobians", action="store_true")
    srt.set_defaults(fn=cmd_simulate_rttov)

    sa = sub.add_parser("simulate-arms",
                        help="act as ARMS-gb FWD_Test: fill Sim_BT")
    sa.add_argument("-i", "--input", required=True)
    sa.add_argument("-o", "--output", required=True)
    sa.add_argument("--model", default="R24")
    sa.add_argument("--with-o3", action="store_true")
    sa.set_defaults(fn=cmd_simulate_arms)

    sra = sub.add_parser(
        "run-all", help="full pipeline: preprocess -> forward -> evaluate")
    sra.add_argument("--sondes", required=True, help="radiosonde glob")
    sra.add_argument("--campaign", default="campaign")
    sra.add_argument("--location", default="site")
    sra.add_argument("--mwr", action="append",
                     help="instrument=glob (repeatable)")
    sra.add_argument("--workdir", default="run_all_out",
                     help="stage outputs + figures + log directory")
    sra.add_argument("--models", default=None,
                     help="comma list, e.g. R98,R17,R20,R24")
    sra.add_argument("--distill", action="store_true",
                     help="also fit + run the fast operator")
    sra.add_argument("--with-jacobians", dest="with_jacobians",
                     action="store_true", default=None)
    sra.add_argument("--compat", dest="compat_aliases", action="store_true",
                     default=None, help="add reference-schema variable names")
    sra.add_argument("--batch-size", type=int, default=None)
    sra.add_argument("--steps", dest="distill_steps", type=int, default=None)
    sra.add_argument("--teacher", dest="teacher_model", default=None)
    sra.add_argument("--resume", action="store_true",
                     help="reuse an existing harmonized.nc in workdir")
    sra.add_argument("--full", action="store_true",
                     help="emit the complete campaign x location x window x "
                          "sky analysis matrix instead of the standard set")
    sra.set_defaults(fn=cmd_run_all)

    sc = sub.add_parser("config", help="print the default typed config")
    sc.set_defaults(fn=cmd_config)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Persistent compile cache (parallel/compile_cache.py): stage re-runs,
    # the reference's own workflow (run_all_procs.sh:1-12), then skip every
    # first-compile.
    from ..parallel import compile_cache
    compile_cache.enable()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
