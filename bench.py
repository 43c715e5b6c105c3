"""Headline benchmark suite: every BASELINE.json config on one chip.

Headline metric (BASELINE configs 2/3): TB spectra/s/chip on the 14-channel
HATPRO slant-path LBL.  One "spectrum" = one (profile, elevation) pair ->
14 channel TBs with the R24 line-by-line model on 180 levels — exactly the
unit of work of the reference's hot loop (one `rte.execute()` call per
time x crop x elevation, /root/reference/python_src/proc/
PyRTlib_processing.py:99-151).

Baseline: the reference's LBL path is sequential CPU PyRTlib, measured by
its author as "very slow" with the sibling mwrpy_sim LBL at ~602 s/profile
(SURVEY.md section 6).  PyRTlib itself runs ~1 spectrum/s/core on a
workstation CPU for this 14-channel configuration; we use 1.0 spectra/s as
the (favourable-to-the-reference) baseline denominator.

The `extra` object carries the remaining BASELINE configs measured in the
same run:
  spectral_50k_Mfreqpoints_per_s   config 4: 50k-frequency monochromatic
                                   grid + SRF convolution (profile-freq
                                   points per second, millions)
  kmatrix_ms_per_batch             config 4: batched K-matrix (B=256, E=10,
                                   wrt t/rho/lwc) via the diagonal-adjoint
                                   path; also expressed as x-forward cost
  distill_step_ms                  config 5: one distillation train step
                                   (B=512 profiles, TB-space loss)
  fast_serving_ms_per_batch        fast operator, 1024 profiles x 10 elev
  forward_stage_frac               pipeline forward_stage throughput as a
                                   fraction of the raw forward headline
                                   (profiles are uploaded once per crop
                                   and sliced on device).

Every path runs as XLA.  Needs a GPU and fails without one.  Methodology:
`parallel/profiling.device_time` chains K data-dependent dispatches,
consumes every output element, and
subtracts a 1-dispatch run to cancel the fixed dispatch + read-back cost.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}, with the card's name and power limit under "device".  `--quick`
skips the extras.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from mwr_fast_forward_operators_and_lbls_tpu.models import fast, lbl
from mwr_fast_forward_operators_and_lbls_tpu.models import jacobians
from mwr_fast_forward_operators_and_lbls_tpu.parallel import (
    compile_cache, profiling)

BASELINE_SPECTRA_PER_S = 1.0  # reference PyRTlib, sequential CPU


def bench_headline():
    batch, n_elev = 1024, 10
    config = lbl.LBLConfig(model="R24", outputs=("tb",))
    profiles = lbl.demo_batch(batch, n_levels=180)
    profiles = jax.device_put(profiles, jax.devices()[0])
    tb = lbl.forward_batch(profiles, config)["tb"]
    assert np.isfinite(np.asarray(tb)).all()
    per_call = profiling.device_time(
        lambda pr: lbl.forward_batch(pr, config), (profiles,),
        iters=40, trials=4)
    return batch * n_elev / per_call, per_call


def bench_spectral():
    """Config 4: 50k monochromatic frequencies + SRF, 32 profiles."""
    from mwr_fast_forward_operators_and_lbls_tpu.constants import hatpro
    from mwr_fast_forward_operators_and_lbls_tpu.models import spectral

    batch, nf = 32, 50_000
    profiles = jax.device_put(lbl.demo_batch(batch, n_levels=180),
                              jax.devices()[0])
    f = np.linspace(20.0, 64.0, nf).astype(np.float32)
    w = np.zeros((14, nf), np.float32)
    for c, (fc, bw) in enumerate(zip(hatpro.HATPRO_FREQS_GHZ,
                                     hatpro.nominal_bandwidth_ghz())):
        w[c] = np.exp(-0.5 * ((f - fc) / max(bw, 1e-3)) ** 2)

    def run(pr):
        out = spectral.forward_spectral(pr, f, (90.0,), "R24",
                                        freq_chunk=8192)
        return spectral.srf_convolve(out["tb"], jnp.asarray(w))

    tb_c = np.asarray(run(profiles))
    assert np.isfinite(tb_c).all()
    # Device rate from one resident 8192-frequency chunk; the Python chunk
    # loop adds one dispatch per chunk on top.
    fc = jnp.asarray(f[:8192])
    per_chunk = profiling.device_time(
        lambda pr: spectral._forward_chunk(pr, fc, (90.0,), "R24")[0],
        (profiles,), iters=10, trials=3)
    per_call = per_chunk * (nf / 8192)
    return batch * nf / per_call, per_call, {
        "chunk_ms": round(per_chunk * 1e3, 3)}


def bench_kmatrix():
    """K-matrix at B=256 against a directly measured B=256 forward."""
    batch = 256
    cfg = lbl.LBLConfig(model="R24")
    profiles = jax.device_put(lbl.demo_batch(batch, n_levels=180),
                              jax.devices()[0])
    per_call = profiling.device_time(
        lambda pr: jacobians.kmatrix_batch_fast(pr, cfg), (profiles,),
        iters=10, trials=4)
    fwd_cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    fwd_256 = profiling.device_time(
        lambda pr: lbl.forward_batch(pr, fwd_cfg), (profiles,),
        iters=40, trials=4)
    return per_call, per_call / fwd_256


def bench_distill_step():
    batch = 512
    cfg = fast.FastConfig()
    profiles = jax.device_put(lbl.demo_batch(batch, n_levels=180),
                              jax.devices()[0])
    targets = lbl.forward_batch(
        profiles, lbl.LBLConfig(model=cfg.teacher_model,
                                outputs=("tb",)))["tb"]
    params = fast.fit_closed_form(profiles, cfg)
    opt = fast._default_optimizer()
    opt_state = opt.init(params)

    def step(pr, tg):
        p2, _, loss = fast.train_step(params, opt_state, pr, tg, cfg, opt)
        return {"w": p2["w"], "loss": loss}

    per_call = profiling.device_time(step, (profiles, targets),
                                     iters=20, trials=3)
    return per_call


def bench_fast_serving():
    batch = 1024
    cfg = fast.FastConfig(outputs=("tb", "tau_total"))
    profiles = lbl.demo_batch(batch, n_levels=180)
    params = fast.fit_closed_form(
        {k: v[:64] for k, v in profiles.items()}, cfg)
    profiles = jax.device_put(profiles, jax.devices()[0])
    per_call = profiling.device_time(
        lambda pr: fast.fast_forward_batch(params, pr, cfg), (profiles,),
        iters=40, trials=4)
    return per_call


def bench_retrieval():
    """Config 5 second half: Gauss-Newton OEM retrieval on the fast
    operator's K-matrix (models/retrieval.py), batched."""
    from mwr_fast_forward_operators_and_lbls_tpu.models import retrieval

    batch, n_lev = 64, 180
    profiles = lbl.demo_batch(batch, n_levels=n_lev)
    cfg = fast.FastConfig()
    params = fast.fit_closed_form(
        {k: v[:32] for k, v in profiles.items()}, cfg)
    tb_obs = fast.fast_forward_batch(params, profiles, fast.FastConfig(
        outputs=("tb",)))["tb"]
    ocfg = retrieval.OEMConfig(n_iter=3)
    z, p = profiles["z"], profiles["p"]
    t_prior = profiles["t"] + 1.5
    rho_prior = profiles["rho"] * 0.8

    def run(tb):
        out = retrieval.retrieve_batch(params, tb, z, p, t_prior,
                                       rho_prior, ocfg)
        return {"t": out["t"], "rho": out["rho"]}

    per_call = profiling.device_time(run, (tb_obs,), iters=4, trials=3)
    return per_call / batch


def bench_forward_stage(headline_rate):
    """Pipeline throughput (host loop + NaN screening + layout restores)
    as a fraction of the raw kernel headline — VERDICT r1 item 5."""
    from mwr_fast_forward_operators_and_lbls_tpu.data import synthetic
    from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
        forward_stage)

    n_time = N_STAGE_TIME
    ds = synthetic.forward_stage_dataset(n_time)

    # warm the executables at the MEASURED shape so the measurement below is
    # steady-state pipeline throughput, not compile time (a smaller warm-up
    # slice compiles a different stage program and the measured wall becomes
    # one giant recompile — the r3/r4 "stage frac" collapse)
    forward_stage(ds, models=("R24",), batch_size=256)

    t0 = time.perf_counter()
    forward_stage(ds, models=("R24",), batch_size=256)
    wall = time.perf_counter() - t0

    # opt-in fp16-anomaly payload (halves upload bytes; < 0.02 K measured,
    # tests/test_pipeline.py::test_compressed_upload_tb_budget)
    forward_stage(ds, models=("R24",), batch_size=256,
                  compress_upload=True)            # warm the f16 program
    t0 = time.perf_counter()
    forward_stage(ds, models=("R24",), batch_size=256,
                  compress_upload=True)
    wall_c = time.perf_counter() - t0

    # On-device time of the whole stage program (all chunks x model via
    # lax.map, one dispatch) — instrumented with the same chained
    # device_time methodology as the headline (VERDICT r2 Next #3), so it
    # is comparable to the summed kernel time for the same work.
    from mwr_fast_forward_operators_and_lbls_tpu.data import (
        preprocess as _pp)
    from mwr_fast_forward_operators_and_lbls_tpu.pipeline.forward import (
        _screen, _stage_device)
    raw0, _ = _screen(_pp.profiles_for_forward(ds, crop=0))
    dev = {k: jax.device_put(jnp.asarray(v)) for k, v in raw0.items()}
    stage_dev_s = profiling.device_time(
        lambda d: _stage_device(d, None, ("R24",), False, 256),
        (dev,), iters=12, trials=4)

    # Host->device upload cost of the same profile payload, measured
    # separately (a property of the host link, not of the pipeline).
    raw = {k: np.ascontiguousarray(v)
           for k, v in _pp.profiles_for_forward(ds, crop=0).items()}
    t0 = time.perf_counter()
    for _ in range(2):                  # one upload per crop
        jax.block_until_ready(jax.device_put(
            {k: jnp.asarray(v + 0.0) for k, v in raw.items()}))
    upload = time.perf_counter() - t0

    spectra = n_time * 2 * 10           # time x crop x elevation
    rate = spectra / wall
    return (rate / headline_rate, rate, upload / wall, stage_dev_s,
            wall, wall_c, upload)


N_STAGE_TIME = 1000


def main():
    quick = "--quick" in sys.argv
    compile_cache.enable()              # before the backend starts
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default device is "
                 f"{dev.platform!r}")
    card = profiling.card_description()
    print(f"card: {card}", file=sys.stderr)
    rate, fwd_per_call = bench_headline()
    result = {
        "metric": "tb_spectra_per_s_per_chip",
        "value": round(rate, 2),
        "unit": "spectra/s (profile x elevation -> 14ch TB, R24 LBL, "
                "180 levels)",
        "vs_baseline": round(rate / BASELINE_SPECTRA_PER_S, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card,
                   "xla_flags": os.environ.get("XLA_FLAGS", "")},
    }
    if not quick:
        extra = {}
        sp_rate, _, sp_decomp = bench_spectral()
        extra["spectral_50k_Mfreqpoints_per_s"] = round(sp_rate / 1e6, 2)
        extra["spectral_decomp_ms"] = sp_decomp
        k_ms, k_x = bench_kmatrix()
        extra["kmatrix_ms_per_batch256"] = round(k_ms * 1e3, 2)
        extra["kmatrix_x_forward"] = round(k_x, 2)
        extra["distill_step_ms"] = round(bench_distill_step() * 1e3, 3)
        extra["fast_serving_ms_per_batch1024"] = round(
            bench_fast_serving() * 1e3, 3)
        extra["oem_retrieval_ms_per_profile"] = round(
            bench_retrieval() * 1e3, 3)
        (frac, stage_rate, upload_frac, stage_dev_s, wall, wall_c,
         upload) = bench_forward_stage(rate)
        extra["forward_stage_spectra_per_s"] = round(stage_rate, 1)
        extra["forward_stage_frac_of_kernel"] = round(frac, 4)
        # fraction of the stage wall the host->device upload WOULD cost
        # serialized, measured separately; the uploads are dispatched async
        # for both crops before either pull, so the wall approaches
        # max(upload, compute) instead of their sum
        extra["forward_stage_upload_frac_of_wall"] = round(upload_frac, 3)
        extra["forward_stage_wall_s"] = round(wall, 3)
        # opt-in fp16-anomaly payload: halves upload bytes (< 0.02 K TB
        # cost, gated in tests/test_pipeline.py)
        extra["forward_stage_wall_s_f16payload"] = round(wall_c, 3)
        # on-device time of the single-dispatch stage program (crop 0,
        # 1000 launches x 10 elevations, R24) vs the summed forward time
        # for the same 10k spectra
        extra["forward_stage_device_ms"] = round(stage_dev_s * 1e3, 2)
        extra["forward_stage_device_x_kernel"] = round(
            stage_dev_s / (N_STAGE_TIME * 10 / rate), 2)
        result["extra"] = extra
    print(json.dumps(result))


if __name__ == "__main__":
    main()
