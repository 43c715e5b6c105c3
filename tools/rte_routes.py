"""Time the routes of the channel forward on the GPU: the evidence for the
route the library runs.

    python tools/rte_routes.py [--batch 1024] [--out chiprun_out/routes]

Each part runs in a child process of its own (the parent never touches
JAX, so one process at a time holds the card), with the persistent compile
cache off so that the compile times printed are real, and with the process
set-up of `compile_cache.disable_fusion_autotuner`:

  fence   the absorption with and without optimization barriers around its
          inputs and its output (`--fence` wraps `total_absorption` in them),
          for route (a) at B, the K-matrix at B=256 and the 50k-point
          spectral grid at B=8; compile seconds and ms per call, in turns
          (plain, fenced, fenced, plain);
  routes  the LBL and the fast operator at B, outputs tb alone and all
          four, by (a) the batch-major XLA forward the library runs,
          (b) the (levels, batch) layout in XLA with a `jnp.cumsum` scan,
          (c) that layout with `rte_triton` below, a Pallas kernel compiled
          through Triton; plus the RTE alone on precomputed inputs;
  trace   a profiler trace of route (a), outputs tb, reduced to device ms
          per call for each fusion and each layer, and the idle share.

The last line of each part is one JSON object; `--out` keeps the trace.
`rte_triton` runs on the CPU with `interpret=True` (tests/test_rte_routes.py).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mwr_fast_forward_operators_and_lbls_tpu.constants import physics as phys  # noqa: E402,E501
from mwr_fast_forward_operators_and_lbls_tpu.ops import (  # noqa: E402
    absorption, geometry, rte, thermo)

OUTPUTS = ("tb", "tau_total", "t_mr", "trans_level")


# ---------------------------------------------------------------------------
# The Pallas RTE kernel (Triton route)
# ---------------------------------------------------------------------------

def _rte_kernel(x_ref, a_ref, ds_ref, t_ref, tb_ref, tau_ref, tmr_ref,
                *tl_ref, n_tiles, block_b, block_l, alpha_is_mid, t_cosmic):
    """One program: one block of profiles, one elevation, one frequency.

    Loops over the layers in tiles of `block_l`; the cumulative opacity and
    the emission sum are carried in registers, so the scan is exact fp32
    and O(L), and nothing of size (layers, batch) is written unless the
    transmittance profile is asked for.
    """
    b_blk, e, fi = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    bb = block_b
    cols = pl.ds(b_blk * bb, bb)
    x = x_ref[fi]

    def planck(t):
        return x / jnp.expm1(x / t)

    def tile(i, carry):
        tau, atm = carry
        lo, hi = pl.ds(i * block_l, block_l), pl.ds(i * block_l + 1, block_l)
        ds = ds_ref[e, lo, cols]
        if alpha_is_mid:
            dtau = a_ref[fi, lo, cols] * ds
        else:
            dtau = 0.5 * (a_ref[fi, lo, cols] + a_ref[fi, hi, cols]) * ds
        cum = tau[None, :] + jnp.cumsum(dtau, axis=0)
        g_bot, g_top = rte._emission_factors(dtau)
        emission = (g_bot * planck(t_ref[lo, cols])
                    + g_top * planck(t_ref[hi, cols]))
        atm = atm + jnp.sum(emission * jnp.exp(dtau - cum), axis=0)
        if tl_ref:
            tl_ref[0][e, fi, hi, cols] = jnp.exp(-cum)
        return tau + jnp.sum(dtau, axis=0), atm

    zero = jnp.zeros((bb,), jnp.float32)
    if tl_ref:
        tl_ref[0][e, fi, 0, cols] = zero + 1.0
    tau, atm = lax.fori_loop(0, n_tiles, tile, (zero, zero))
    radiance = atm + x / jnp.expm1(x / t_cosmic) * jnp.exp(-tau)
    tb_ref[e, fi, cols] = x / jnp.log1p(x / radiance)
    tau_ref[e, fi, cols] = tau
    tmr_ref[e, fi, cols] = x / jnp.log1p(
        x / (atm / jnp.maximum(-jnp.expm1(-tau), 1e-10)))


def rte_triton(alpha, ds_km, t_k, f_ghz, *, alpha_is_mid=False,
               trans_level=False, block_b=64, block_l=32, interpret=False):
    """Downwelling RTE of `rte.downwelling_tb` in the (levels, batch) layout.

    Args:
      alpha: (F, L, B) level absorption [Np/km], or (F, L-1, B) layer
        extinction with `alpha_is_mid` (the fast operator's).
      ds_km: (E, L-1, B) slant path per layer.
      t_k: (L, B) level temperatures.
      f_ghz: (F,) frequencies.
    Returns dict of tb, tau_total, t_mr (E, F, B) and, with `trans_level`,
    trans_level (E, F, L, B).  Layers are padded to whole tiles with zero
    path length (zero opacity: no emission, no attenuation) and the batch
    to whole blocks.
    """
    n_e, n_lay, b = ds_km.shape
    n_f = f_ghz.shape[0]
    n_tiles = -(-n_lay // block_l)
    lay_p, b_p = n_tiles * block_l, -(-b // block_b) * block_b
    ds_km = jnp.pad(ds_km, ((0, 0), (0, lay_p - n_lay), (0, b_p - b)))
    t_k = jnp.pad(t_k, ((0, lay_p + 1 - t_k.shape[0]), (0, b_p - b)),
                  mode="edge")
    rows = lay_p if alpha_is_mid else lay_p + 1
    alpha = jnp.pad(alpha, ((0, 0), (0, rows - alpha.shape[1]),
                            (0, b_p - b)))
    x = phys.HK_GHZ * f_ghz.astype(jnp.float32)
    shapes = [jax.ShapeDtypeStruct((n_e, n_f, b_p), jnp.float32)] * 3
    if trans_level:
        shapes.append(jax.ShapeDtypeStruct((n_e, n_f, lay_p + 1, b_p),
                                           jnp.float32))
    kernel = functools.partial(
        _rte_kernel, n_tiles=n_tiles, block_b=block_b, block_l=block_l,
        alpha_is_mid=alpha_is_mid, t_cosmic=float(phys.T_COSMIC))
    outs = pl.pallas_call(
        kernel, out_shape=shapes, grid=(b_p // block_b, n_e, n_f),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton", interpret=interpret, name="rte_levels",
    )(x, alpha, ds_km, t_k)
    res = {"tb": outs[0][..., :b], "tau_total": outs[1][..., :b],
           "t_mr": outs[2][..., :b]}
    if trans_level:
        res["trans_level"] = outs[3][:, :, :n_lay + 1, :b]
    return res


# ---------------------------------------------------------------------------
# Routes (b) and (c): the (levels, batch) layout
# ---------------------------------------------------------------------------

def lanes_inputs(profs, freqs, elevs, model="R24", fast_params=None):
    """(alpha, ds, t) in the (levels, batch) layout: alpha (F, L, B) from
    the LBL absorption, or (F, L-1, B) from the fast regression."""
    f = jnp.asarray(freqs, jnp.float32)
    z, p, t, rho, lwc = (profs[k] for k in ("z", "p", "t", "rho", "lwc"))
    if fast_params is None:
        alpha = absorption.total_absorption(
            f[:, None, None], p.T[None], t.T[None], rho.T[None],
            lwc.T[None], model=model)
    else:
        from mwr_fast_forward_operators_and_lbls_tpu.models import fast
        alpha = fast.predict_extinction(fast_params, p, t, rho,
                                        lwc).transpose(2, 1, 0)
    e_hpa = thermo.rho_to_e(rho, t)
    per_profile = jax.vmap(geometry.slant_path_lengths,
                           in_axes=(0, 0, 0, 0, None), out_axes=-1)
    ds = jax.vmap(per_profile, in_axes=(None, None, None, None, 0))(
        z, p, t, e_hpa, jnp.asarray(elevs, jnp.float32))      # (E, L-1, B)
    return alpha, ds, t.T


def rte_xla_lanes(alpha, ds, t, f_ghz, alpha_is_mid=False):
    """Route (b)'s RTE: `rte.downwelling_tb_from_dtau` over (E, F, L-1, B)."""
    layer = alpha if alpha_is_mid else 0.5 * (alpha[:, :-1] + alpha[:, 1:])
    dtau = layer[None] * ds[:, None]
    per_b = jax.vmap(rte.downwelling_tb_from_dtau, in_axes=(-1, -1, None),
                     out_axes=-1)
    return jax.vmap(per_b, in_axes=(0, None, None))(
        dtau, t, jnp.asarray(f_ghz, jnp.float32))


def to_public(out, outputs):
    """(E, F[, L], B) -> the public (B, E, F[, L]) layout."""
    return {k: (v.transpose(3, 0, 1, 2) if k == "trans_level"
                else v.transpose(2, 0, 1))
            for k, v in out.items() if k in outputs}


def lanes_forward(profs, freqs, elevs, outputs, kernel, fast_params=None):
    alpha, ds, t = lanes_inputs(profs, freqs, elevs, fast_params=fast_params)
    mid = fast_params is not None
    f = jnp.asarray(freqs, jnp.float32)
    if kernel:
        out = rte_triton(alpha, ds, t, f, alpha_is_mid=mid,
                         trans_level="trans_level" in outputs)
    else:
        out = rte_xla_lanes(alpha, ds, t, f, alpha_is_mid=mid)
    return to_public(out, outputs)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _timed(fn, *args, reps=10, trials=5):
    """(seconds of the first call, compile included; median seconds per
    call over `trials` windows of `reps` calls closed by
    block_until_ready)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        walls.append((time.perf_counter() - t0) / reps)
    return first, float(np.median(walls))


def fence_absorption():
    """Wrap `total_absorption`, wherever the models call it, in
    optimization barriers on its array inputs and its output."""
    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl, spectral

    plain = absorption.total_absorption

    def bar(x):
        return x if x is None else lax.optimization_barrier(jnp.asarray(x))

    @functools.wraps(plain)
    def fenced(f_ghz, p_hpa, t_k, rho_gm3, lwc_gm3=None, model="R24",
               o3_ppmv=None):
        return bar(plain(*map(bar, (f_ghz, p_hpa, t_k, rho_gm3, lwc_gm3)),
                         model=model, o3_ppmv=bar(o3_ppmv)))

    absorption.total_absorption = lbl.total_absorption = fenced
    spectral.total_absorption = fenced


def part_fence(args):
    from mwr_fast_forward_operators_and_lbls_tpu.models import (
        jacobians, lbl, spectral)

    if args.fence:
        fence_absorption()
    res = {"part": "fence", "fenced": bool(args.fence)}
    profs = jax.device_put(lbl.demo_batch(args.batch, n_levels=180))
    cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    first, s = _timed(lambda p: lbl.forward_batch(p, cfg)["tb"], profs)
    res["lbl_a_tb"] = {"first_s": first, "ms": s * 1e3}
    kp = {k: v[:256] for k, v in profs.items()}
    kcfg = lbl.LBLConfig(model="R24")
    first, s = _timed(lambda p: jacobians.kmatrix_batch_fast(p, kcfg), kp,
                      reps=3, trials=3)
    res["kmatrix_256"] = {"first_s": first, "ms": s * 1e3}
    sp = {k: v[:8] for k, v in profs.items()}
    f = np.linspace(20.0, 64.0, 50_000).astype(np.float32)
    first, s = _timed(lambda p: spectral.forward_spectral(p, f, (90.0,))["tb"],
                      sp, reps=2, trials=3)
    res["spectral_50k_b8"] = {"first_s": first, "ms": s * 1e3}
    return res


def part_routes(args):
    from mwr_fast_forward_operators_and_lbls_tpu.models import fast, lbl

    b = args.batch
    profs = jax.device_put(lbl.demo_batch(b, n_levels=180))
    cfg = lbl.LBLConfig(model="R24")
    params = fast.fit_closed_form(lbl.demo_batch(64, n_levels=180, seed=7))
    fcfg = fast.FastConfig()
    res = {"part": "routes", "batch": b}
    ref = {}
    for op in ("lbl", "fast"):
        fp = params if op == "fast" else None
        for outs_name, outs in (("tb", ("tb",)), ("all", OUTPUTS)):
            if op == "lbl":
                a = jax.jit(lambda p, o=outs: lbl.forward_batch(
                    p, lbl.LBLConfig(model="R24", outputs=o)))
            else:
                a = jax.jit(lambda p, o=outs: fast.fast_forward_batch(
                    params, p, fast.FastConfig(outputs=o)))
            routes = {"a": a}
            for name, kern in (("b", False), ("c", True)):
                routes[name] = jax.jit(functools.partial(
                    lanes_forward, freqs=cfg.freqs_ghz,
                    elevs=cfg.elevations_deg, outputs=outs, kernel=kern,
                    fast_params=fp))
            for name, fn in routes.items():
                key = f"{op}_{name}_{outs_name}"
                first, s = _timed(fn, profs)
                tb = np.asarray(fn(profs)["tb"])
                ref.setdefault((op, outs_name), tb)
                err = float(np.abs(tb - ref[(op, outs_name)]).max())
                res[key] = {"first_s": first, "ms": s * 1e3,
                            "max_dtb_vs_a_K": err}
                print(key, res[key], flush=True)
    alpha, ds, t = jax.jit(functools.partial(
        lanes_inputs, freqs=cfg.freqs_ghz, elevs=cfg.elevations_deg))(profs)
    f = jnp.asarray(cfg.freqs_ghz, jnp.float32)
    xla = jax.jit(lambda a, d, tt: rte_xla_lanes(a, d, tt, f)["tb"])
    _, s_x = _timed(xla, alpha, ds, t)
    res["rte_alone_xla_ms"] = s_x * 1e3
    for bb, bl in ((64, 32), (32, 32), (64, 16), (128, 32)):
        kern = jax.jit(lambda a, d, tt, bb=bb, bl=bl: rte_triton(
            a, d, tt, f, block_b=bb, block_l=bl)["tb"])
        _, s_k = _timed(kern, alpha, ds, t)
        res[f"rte_alone_triton_{bb}x{bl}_ms"] = s_k * 1e3
    return res


def part_trace(args):
    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl
    from mwr_fast_forward_operators_and_lbls_tpu.parallel import profiling

    profs = jax.device_put(lbl.demo_batch(args.batch, n_levels=180))
    cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    fwd = jax.jit(lambda p: lbl.forward_batch(p, cfg)["tb"])
    layers = profiling.fusion_layers(fwd.lower(profs).compile().as_text())
    jax.block_until_ready(fwd(profs))
    calls = 20
    log_dir = os.path.join(args.out, "trace_lbl_a")
    with profiling.trace(log_dir):
        for _ in range(calls):
            out = fwd(profs)
        jax.block_until_ready(out)
    ops, busy, window = profiling.device_op_times(log_dir)
    per_layer = {}
    for name, (ns, _) in ops.items():
        lay = layers.get(name, "other")
        per_layer[lay] = per_layer.get(lay, 0.0) + ns / calls / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    return {"part": "trace", "batch": args.batch, "calls": calls,
            "device_ms_per_call": busy / calls / 1e6,
            "idle_share": 1.0 - busy / window,
            "layer_ms_per_call": per_layer,
            "fusions": [{"name": n, "layer": layers.get(n, "other"),
                         "ms_per_call": ns / calls / 1e6, "launches": k}
                        for n, (ns, k) in top]}


PARTS = {"fence": part_fence, "routes": part_routes, "trace": part_trace}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "routes"))
    ap.add_argument("--part", choices=sorted(PARTS))
    ap.add_argument("--fence", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.part:                      # a child: this process uses the card
        from mwr_fast_forward_operators_and_lbls_tpu.parallel import (
            compile_cache)
        compile_cache.disable_fusion_autotuner()
        jax.config.update("jax_enable_compilation_cache", False)
        print(json.dumps(PARTS[args.part](args)), flush=True)
        return
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = [("fence", False), ("fence", True), ("fence", True),
            ("fence", False), ("routes", False), ("trace", False)]
    failed = 0
    for part, fence in runs:
        cmd = [sys.executable, os.path.abspath(__file__), "--part", part,
               "--batch", str(args.batch), "--out", args.out]
        if fence:
            cmd.append("--fence")
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            out, rc = r.stdout, r.returncode
            if rc:
                out += r.stderr[-3000:]
        except subprocess.TimeoutExpired:
            out, rc = f"{part}: no result within {args.timeout} s", 124
        print(out.strip(), flush=True)
        failed += rc != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
