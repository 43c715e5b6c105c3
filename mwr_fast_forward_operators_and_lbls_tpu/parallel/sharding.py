"""Sharding rules + sharded forward entry points (pjit over the mesh).

Replaces nothing in the reference — it had no parallel execution (SURVEY.md
section 2.3) — but implements the scale axis the BASELINE targets require:
>=90 % grid-points/s scaling efficiency from 1 chip to multiple hosts on the
profiles x angles batch, and a `spectral` axis for the 50k-frequency
monochromatic grid.

Design: annotate inputs with NamedSharding and let XLA insert collectives
(GSPMD).  There is no hand-written communication anywhere in the forward
path; the workload's only cross-device traffic is the implicit all-gather on
unsharded outputs, psum of eval-statistics accumulators, and gradient
reductions in distillation — exactly what `jax.jit` + shardings generate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import lbl
from .mesh import DATA_AXIS, SPECTRAL_AXIS, pad_to_multiple


def shard_profiles(profiles: dict, mesh: Mesh) -> dict:
    """Place a dict of (B, L) profile arrays batch-sharded over `data`.

    Pads B up to a multiple of the data-axis size (padded rows are copies of
    row 0 so they stay numerically benign); callers slice outputs back with
    the returned original batch size.
    """
    n_data = mesh.shape[DATA_AXIS]
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    out = {}
    for k, v in profiles.items():
        b = v.shape[0]
        bp = pad_to_multiple(b, n_data)
        if bp != b:
            v = jnp.concatenate([v, jnp.broadcast_to(v[:1], (bp - b,) + v.shape[1:])])
        out[k] = jax.device_put(v, sharding)
    return out


def forward_sharded(profiles: dict, mesh: Mesh,
                    config: lbl.LBLConfig = lbl.LBLConfig()) -> dict:
    """Batch-data-parallel LBL forward over the mesh.

    profiles: dict of (B, L) arrays (B divisible by the data-axis size or it
    will be padded).  Returns the same dict as `lbl.forward_batch`, with the
    batch axis sharded over `data`.
    """
    b = profiles["z"].shape[0]
    placed = shard_profiles(profiles, mesh)
    out = forward_sharded_placed(placed, mesh, config)
    return {k: v[:b] for k, v in out.items()}


def forward_sharded_placed(placed: dict, mesh: Mesh,
                           config: lbl.LBLConfig = lbl.LBLConfig()) -> dict:
    """`forward_sharded` for inputs already padded + placed on the mesh
    (hot-loop form: no host-side padding or device_put per call)."""
    return _sharded_forward(mesh, config)(placed)


@functools.lru_cache(maxsize=None)
def _sharded_forward(mesh: Mesh, config: lbl.LBLConfig):
    """One jitted program per (mesh, config): a fresh `jax.jit` per call
    would trace and lower the forward again every time (180 ms per call at
    B=4096 on four H100s, PERF.md)."""
    out_sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.jit(
        functools.partial(lbl.forward_batch, config=config),
        out_shardings={k: out_sharding for k in config.outputs},
    )


def forward_spectral_sharded(profiles: dict, f_ghz, mesh: Mesh,
                             model: str = "R24",
                             elevations_deg=(90.0,),
                             freq_chunk: int = 4096) -> jax.Array:
    """High-res monochromatic LBL with the frequency grid sharded over
    `spectral` and profiles over `data` (BASELINE config 4, the 50k-point
    grid — this domain's long-context axis, SURVEY.md section 5).

    Each device runs the chunked spectral path (models/spectral.py) on its
    frequency slice; the sweep is embarrassingly parallel and the only
    cross-device traffic is the SRF-convolution reduction downstream.
    Returns tb of shape (B, E, F).
    """
    from ..models import spectral as spec_mod

    n_s = mesh.shape[SPECTRAL_AXIS]
    f = jnp.asarray(f_ghz, jnp.float32)
    nf = f.shape[0]
    nfp = pad_to_multiple(nf, n_s)
    if nfp != nf:
        f = jnp.concatenate([f, jnp.broadcast_to(f[-1:], (nfp - nf,))])
    f = jax.device_put(f, NamedSharding(mesh, P(SPECTRAL_AXIS)))
    placed = shard_profiles(profiles, mesh)
    elevs = tuple(float(e) for e in elevations_deg)

    def local(pr, fl):
        return spec_mod.forward_spectral(pr, fl, elevs, model,
                                         freq_chunk=freq_chunk)["tb"]

    fwd = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=({k: P(DATA_AXIS, None) for k in placed}, P(SPECTRAL_AXIS)),
        out_specs=P(DATA_AXIS, None, SPECTRAL_AXIS),
        check_vma=False,
    ))
    b = profiles["z"].shape[0]
    return fwd(placed, f)[:b, :, :nf]


def srf_convolve(tb_mono: jax.Array, weights: jax.Array) -> jax.Array:
    """Channel-SRF convolution: (..., F) x (C, F) -> (..., C).

    A single matmul; when tb_mono's F axis is sharded over `spectral`, XLA
    lowers the contraction to a reduce-scatter/all-reduce across devices.
    """
    wsum = jnp.sum(weights, axis=-1, keepdims=True)
    return jnp.einsum("...f,cf->...c", tb_mono,
                      weights / jnp.maximum(wsum, 1e-30),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
