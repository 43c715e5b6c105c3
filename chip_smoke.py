"""Prove that the forward operator runs compiled on one GPU, end to end.

    python chip_smoke.py            # one GPU: phases 1-8
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases, in one process (a second JAX process could not open the card):

  1. device check: the default backend must be a GPU — there is no CPU
     fallback; prints the card, the JAX version, the compile-cache
     directory, whether native/ncio was built, and the route of every
     kernel of the main path (all XLA);
  2. LBL at headline width (B=1024, L=180, E=10, F=14, R24) against the
     same forward at matmul precision "highest", the frozen float64 anchor
     (tests/golden/tb_standard.json), and a steady-state time per call;
  3. the CLI chain preprocess | distill | forward --with-jacobians on a
     synthetic campaign of 64 sondes, in-process through `cli.main.main`,
     with the physical anchors of the verify skill on its clear-sky
     forward and the cloud-liquid increment checked against the LWP;
  4. `pipeline.forward_stage` on the 1000-launch x 2-crop dataset with the
     four releases and the fast operator;
  5. the K-matrix at B=256 against `jax.jacrev` of the forward;
  6. the 50k-point spectral grid with SRF convolution against the channel
     forward at the channel centres;
  7. the `gpu`-marked tests, run by pytest inside this process;
  8. one JSON line: {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero and prints no last line.
`--multi` runs `parallel.forward_sharded` on a data=4 mesh at B=4096 and
`forward_spectral_sharded` on a (data=2, spectral=2) mesh, each against its
single-device result, and nothing else.
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from mwr_fast_forward_operators_and_lbls_tpu.constants import hatpro  # noqa: E402
from mwr_fast_forward_operators_and_lbls_tpu.models import (  # noqa: E402
    fast, jacobians, lbl, spectral)
from mwr_fast_forward_operators_and_lbls_tpu.parallel import (  # noqa: E402
    compile_cache, profiling)

TB_BUDGET_K = 0.05        # frozen float64 anchor (BASELINE.md)
HIGHEST_VS_DEFAULT_K = 0.005   # default matmul precision vs "highest"

# Sizes (module constants so a CPU rehearsal can shrink them).
HEADLINE_B = 1024         # phase 2, L=180 E=10 F=14
CLI_SONDES = 64           # phase 3
STAGE_LAUNCHES = 1000     # phase 4, x 2 crops
KMATRIX_B = 256           # phase 5
SPECTRAL_B, SPECTRAL_NF = 8, 50_000   # phase 6
MULTI_B = 4096            # --multi


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def seconds_per_call(fn, *args, reps=10, trials=5):
    """Median over trials of the mean of `reps` back-to-back calls, each
    window closed by block_until_ready, after one warm call."""
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        walls.append((time.perf_counter() - t0) / reps)
    return float(np.median(walls))


def phase_device(n_devices):
    cache = compile_cache.enable()      # XLA flags: before the backend starts
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's default device is {devs[0].platform!r}")
    check(len(devs) >= n_devices, f"{len(devs)} GPU(s), need {n_devices}")
    from mwr_fast_forward_operators_and_lbls_tpu.utils import native

    log(f"[1] device_kind={devs[0].device_kind} count={len(devs)}")
    log(f"[1] nvidia-smi: {profiling.card_description()}")
    log(f"[1] jax={jax.__version__} compile_cache={cache} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[1] native/ncio built: {native.available()}")
    log("[1] routes: rte=xla absorption=xla geometry=xla kmatrix=xla "
        "spectral=xla fast-regression=xla; no Pallas kernel, no "
        "interpreter")


def phase_lbl():
    b = HEADLINE_B
    profs = jax.device_put(lbl.demo_batch(b, n_levels=180))
    cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    tb = lbl.forward_batch(profs, cfg)["tb"]
    with jax.default_matmul_precision("highest"):
        ref = lbl.forward_batch(profs, cfg)["tb"]
    check(tb.shape == (b, 10, 14), f"tb shape {tb.shape}")
    check(bool(jnp.isfinite(tb).all()), "non-finite TB")
    err = float(jnp.abs(tb - ref).max())
    log(f"[2] B={b} L=180 E=10 F=14 R24: max |TB - XLA(highest)| = "
        f"{err:.6f} K (limit {HIGHEST_VS_DEFAULT_K})")
    check(err < HIGHEST_VS_DEFAULT_K,
          "LBL forward depends on the matmul precision")

    from mwr_fast_forward_operators_and_lbls_tpu.anchors import (
        standard_profiles)
    g = json.loads(pathlib.Path(REPO, "tests", "golden",
                                "tb_standard.json").read_text())
    std = {k: jnp.asarray(v, jnp.float32)
           for k, v in standard_profiles().items()}
    for model, want in g["tb"].items():
        tb_std = lbl.forward_batch(std, lbl.LBLConfig(
            model=model, outputs=("tb",),
            elevations_deg=tuple(g["elevations_deg"])))["tb"]
        d = float(np.abs(np.asarray(tb_std) - np.asarray(want)).max())
        log(f"[2] tb_standard {model}: max |fp32 - fp64 anchor| = {d:.5f} K")
        check(d < TB_BUDGET_K, f"{model} outside the {TB_BUDGET_K} K budget")

    s = seconds_per_call(lambda p: lbl.forward_batch(p, cfg), profs)
    log(f"[2] steady state: {s * 1e3:.4f} ms per call, "
        f"{b * 10 / s:.1f} spectra/s")


def phase_cli(workdir):
    from mwr_fast_forward_operators_and_lbls_tpu.cli.main import main
    from mwr_fast_forward_operators_and_lbls_tpu.data import (
        netcdf, preprocess, synthetic)

    n = CLI_SONDES
    raw = os.path.join(workdir, "raw")
    os.makedirs(raw)
    for i in range(n):
        launch = np.datetime64("2024-06-01T10:29:36") + np.timedelta64(i, "D")
        stamp = str(launch).replace("-", "").replace(":", "").replace("T", "_")
        synthetic.write_sonde_nc_arms(os.path.join(raw, f"{stamp}.nc"),
                                      seed=i, cloudy=False)
        # the harmonized dataset keeps launches with radiometer TBs only
        synthetic.write_mwr_l1(os.path.join(raw, f"l1_{i:03d}.nc"), launch,
                               seed=i)
    harm = os.path.join(workdir, "harmonized.nc")
    params = os.path.join(workdir, "fast_params.npz")
    results = os.path.join(workdir, "results.nc")
    t0 = time.perf_counter()
    check(main(["preprocess", "--sondes", os.path.join(raw, "2024*_*.nc"),
                "--mwr", "joyhat=" + os.path.join(raw, "l1_*.nc"),
                "-o", harm]) == 0, "preprocess failed")
    check(main(["distill", "-i", harm, "-o", params]) == 0, "distill failed")
    check(main(["forward", "-i", harm, "-o", results, "--models", "R24",
                "--fast-params", params, "--with-jacobians"]) == 0,
          "forward failed")
    log(f"[3] CLI chain on {n} sondes: {time.perf_counter() - t0:.2f} s")
    ds = netcdf.read(results)
    tb = np.asarray(ds["TBs_LBL_R24"].data)      # (time, chan, elev, crop)
    check(tb.shape[0] == n, f"{tb.shape[0]} launches, want {n}")
    for name in ("TBs_LBL_R24", "TBs_Fast", "Jacobian_T_LBL"):
        check(np.isfinite(np.asarray(ds[name].data)).all(),
              f"{name} not finite")

    harmonized = netcdf.read(harm)
    prof = preprocess.profiles_for_forward(harmonized, crop=0)
    ref = lbl.forward_batch({k: jnp.asarray(v) for k, v in prof.items()},
                            lbl.LBLConfig(model="R24", outputs=("tb",)))["tb"]
    d = float(np.abs(np.transpose(tb[..., 0], (0, 2, 1))
                     - np.asarray(ref)).max())
    log(f"[3] crop 0 TBs_LBL_R24 vs lbl.forward_batch: {d:.2e} K")
    check(d < 1e-3, "CLI forward disagrees with lbl.forward_batch")
    kband = tb[:, :7, :, 0]
    check((np.diff(kband, axis=-1) > 0).all(),
          "K-band TB does not rise as the elevation drops")
    check_anchors(prof, tb[:, :, 0, 0],
                  np.asarray(harmonized["LWP_radiosonde"].data)[:, 0])


def check_anchors(prof, zen_cloudy, lwp_ingest_kg_m2):
    """Physical anchors of .claude/skills/verify/SKILL.md on the campaign.

    The clear-sky anchors hold at their stated bounds on a forward of the
    same profiles with the liquid zeroed, for the sondes as moist as the
    anchor's profile (IWV 20-30 kg/m^2; the drier ones sit lower at 22.24
    and 31.4 GHz, as they should).  The ingest derives cloud liquid from
    the sondes' humidity; the column it reports must be what the profiles
    hold, and the CLI's cloudy 31.4 GHz TB must exceed the clear-sky one by
    the optically thin emission of that liquid, T_cloud * tau_liquid, less
    the attenuation of the sky behind it (a factor between 0.7 and 1).
    """
    from mwr_fast_forward_operators_and_lbls_tpu.ops.absorption import (
        liquid_absorption)

    chan = list(np.round(hatpro.HATPRO_FREQS_GHZ, 2))
    c22, c31, c58 = (chan.index(f) for f in (22.24, 31.4, 58.0))
    dz_km = np.diff(prof["z"], axis=1) / 1000.0
    layer = lambda a: 0.5 * (a[:, 1:] + a[:, :-1])  # noqa: E731
    iwv = (layer(prof["rho"]) * dz_km).sum(1)                 # kg/m^2
    lwp = (layer(prof["lwc"]) * dz_km).sum(1) * 1000.0        # g/m^2
    log(f"[3] IWV {iwv.min():.2f}-{iwv.max():.2f} kg/m^2, derived LWP "
        f"{lwp.min():.1f}-{lwp.max():.1f} g/m^2 (ingest reports "
        f"{1000 * lwp_ingest_kg_m2.min():.1f}-"
        f"{1000 * lwp_ingest_kg_m2.max():.1f})")
    check(np.allclose(lwp, 1000.0 * lwp_ingest_kg_m2, rtol=0.02),
          "profile liquid disagrees with the ingest's LWP")

    clear = np.asarray(lbl.forward_batch(
        {k: jnp.asarray(v) for k, v in prof.items()},
        lbl.LBLConfig(model="R24", outputs=("tb",), elevations_deg=(90.0,),
                      include_liquid=False))["tb"])[:, 0]
    moist = (iwv >= 20.0) & (iwv <= 30.0)
    k22, k31 = clear[moist, c22], clear[moist, c31]
    v58 = clear[:, c58] - prof["t"][:, 0]
    log(f"[3] clear sky, {int(moist.sum())} sondes of IWV 20-30: 22.24 GHz "
        f"{k22.min():.2f}-{k22.max():.2f} K, 31.4 GHz {k31.min():.2f}-"
        f"{k31.max():.2f} K; all: 58.0 GHz - T_sfc {v58.min():.2f} to "
        f"{v58.max():.2f} K")
    check(moist.sum() >= 8, "too few moist sondes for the anchors")
    check(((k22 > 30) & (k22 < 60)).all(), "22.24 GHz zenith TB off")
    check(((k31 > 20) & (k31 < 30)).all(), "31.4 GHz zenith TB off")
    check((np.abs(v58) < 5.0).all(), "58 GHz not near T_sfc")

    kappa = np.asarray(liquid_absorption(
        jnp.float32(31.4), jnp.asarray(prof["t"]), jnp.asarray(prof["lwc"])))
    thin = (layer(kappa * prof["t"]) * dz_km).sum(1)          # K
    ratio = (zen_cloudy[:, c31] - clear[:, c31]) / thin
    log(f"[3] 31.4 GHz cloud increment / thin-cloud emission: "
        f"{ratio.min():.3f}-{ratio.max():.3f}")
    check(((ratio > 0.7) & (ratio < 1.0)).all(),
          "31.4 GHz cloud increment does not follow the LWP")


def phase_stage():
    from mwr_fast_forward_operators_and_lbls_tpu.data import synthetic
    from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
        forward_stage)

    ds = synthetic.forward_stage_dataset(STAGE_LAUNCHES)
    params = fast.fit_closed_form(lbl.demo_batch(64, n_levels=180))
    models = ("R98", "R17", "R20", "R24")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = forward_stage(ds, models=models, fast_params=params)
        walls.append(time.perf_counter() - t0)
    for name in [f"TBs_LBL_{m}" for m in models] + ["TBs_Fast"]:
        check(np.isfinite(np.asarray(out[name].data)).all(),
              f"{name} not finite")
    log(f"[4] forward_stage {STAGE_LAUNCHES} launches x 2 crops x 4 "
        "releases + fast: "
        f"wall {walls[0]:.3f} s cold (compile included), {walls[1]:.3f} s "
        "warm")


def phase_kmatrix():
    b = KMATRIX_B
    profs = jax.device_put(lbl.demo_batch(b, n_levels=180))
    cfg = lbl.LBLConfig(model="R24")
    k = jacobians.kmatrix_batch_fast(profs, cfg)
    for name, v in k.items():
        check(v.shape == (b, 10, 14, 180), f"K {name} shape {v.shape}")
        check(bool(jnp.isfinite(v).all()), f"K {name} not finite")
    two = {n: v[:2] for n, v in profs.items()}
    ref = jacobians.kmatrix_batch(two, cfg, wrt=("t", "rho", "lwc"))
    for name in ("t", "rho", "lwc"):
        want, got = np.asarray(ref[name]), np.asarray(k[name][:2])
        tol = 2e-4 * max(float(np.abs(want).max()), 1.0)
        d = float(np.abs(want - got).max())
        log(f"[5] K_{name}: max |fast - jacrev| = {d:.3e} (limit {tol:.3e})")
        check(d < tol, f"K_{name} disagrees with jacrev")
    s = seconds_per_call(lambda p: jacobians.kmatrix_batch_fast(p, cfg),
                         profs, reps=3, trials=3)
    log(f"[5] K-matrix B={b} (t, rho, lwc): {s * 1e3:.3f} ms per call")


def phase_spectral():
    b, nf = SPECTRAL_B, SPECTRAL_NF
    profs = jax.device_put(lbl.demo_batch(b, n_levels=180))
    f = np.linspace(20.0, 64.0, nf).astype(np.float32)
    w = np.zeros((14, nf), np.float32)
    for c, (fc, bw) in enumerate(zip(hatpro.HATPRO_FREQS_GHZ,
                                     hatpro.nominal_bandwidth_ghz())):
        w[c] = np.exp(-0.5 * ((f - fc) / max(bw, 1e-3)) ** 2)
    t0 = time.perf_counter()
    out = spectral.forward_spectral(profs, f, (90.0,), "R24")
    tb_c = jax.block_until_ready(spectral.srf_convolve(out["tb"],
                                                       jnp.asarray(w)))
    wall = time.perf_counter() - t0
    check(tb_c.shape == (b, 1, 14), f"SRF shape {tb_c.shape}")
    check(bool(jnp.isfinite(out["tb"]).all()) and
          bool(jnp.isfinite(tb_c).all()), "spectral TB not finite")

    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0,),
                        outputs=("tb", "tau_total"))
    ref = lbl.forward_batch(profs, cfg)
    got = spectral.forward_spectral(profs, jnp.asarray(cfg.freqs_ghz),
                                    (90.0,), "R24")
    d_tb = float(jnp.abs(got["tb"] - ref["tb"]).max())
    rel = float((jnp.abs(got["tau_total"] - ref["tau_total"])
                 / (5e-3 + 1e-3 * jnp.abs(ref["tau_total"]))).max())
    log(f"[6] 50k grid B={b}: {wall:.3f} s with compile; at the channel "
        f"centres max |dTB| = {d_tb:.2e} K, tau within {rel:.2f} of "
        "tolerance")
    check(d_tb < 2e-2 and rel <= 1.0, "spectral path disagrees with channels")


def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-p", "no:xdist", "-p", "no:cacheprovider",
                      "-m", "gpu", os.path.join(REPO, "tests")])
    log(f"[7] gpu-marked tests: pytest exit code {int(rc)}")
    check(int(rc) == 0, "gpu-marked tests failed")


def phase_multi():
    from mwr_fast_forward_operators_and_lbls_tpu.parallel import (
        make_mesh, sharding)

    devs = jax.devices()[:4]
    mesh = make_mesh(devs, data=4)
    profs = lbl.demo_batch(MULTI_B, n_levels=180)
    cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    got = sharding.forward_sharded(profs, mesh, cfg)["tb"]
    ref = lbl.forward_batch(jax.device_put(profs, devs[0]), cfg)["tb"]
    d = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    log(f"[multi] forward_sharded data=4 B={MULTI_B} vs one device: "
        f"{d:.2e} K")
    check(d < 1e-3, "sharded forward disagrees with one device")
    placed = sharding.shard_profiles(profs, mesh)
    s = seconds_per_call(
        lambda p: sharding.forward_sharded_placed(p, mesh, cfg), placed)
    log(f"[multi] sharded steady state: {s * 1e3:.4f} ms per call, "
        f"{MULTI_B * 10 / s:.1f} spectra/s on 4 devices")

    mesh2 = make_mesh(devs, data=2, spectral=2)
    small = lbl.demo_batch(8, n_levels=180)
    f = np.linspace(20.0, 64.0, 4096).astype(np.float32)
    got = sharding.forward_spectral_sharded(small, f, mesh2)
    ref = spectral.forward_spectral(jax.device_put(small, devs[0]), f)["tb"]
    d = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    log(f"[multi] forward_spectral_sharded (data=2, spectral=2) vs dense: "
        f"{d:.2e} K")
    check(d < 1e-3, "sharded spectral disagrees with the dense path")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: the sharded paths only")
    args = ap.parse_args()
    phase_device(4 if args.multi else 1)
    if args.multi:
        phase_multi()
    else:
        phase_lbl()
        with tempfile.TemporaryDirectory() as workdir:
            phase_cli(workdir)
        phase_stage()
        phase_kmatrix()
        phase_spectral()
        phase_tests()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
