"""Evaluation statistics: bias / std / rmse / Pearson-r per channel x
elevation x sky condition.

Mirrors the definitions of the reference's analysis layer so outputs are
directly comparable (Shi et al. 2024/25 convention,
/root/reference/python_src/plot_scripts/multi_campaign_plots_and_ana.py:155-178):

    bias = sum(dev) / n
    std  = sqrt( sum((dev - bias)^2) / n )
    rmse = sqrt( sum(dev^2) / n )

with `dev = value - reference` and NaNs excluded pairwise — plus Pearson
correlation as in x_colorplot_by_elevs_and_chans_MARCH26.py:404-418.

All functions are jittable jnp reductions: when inputs are batch-sharded
over the mesh's data axis the sums become psums across devices, the whole
cross-device traffic of the evaluation stage (SURVEY.md section 2.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _cpu_device():
    """First CPU device, or None when the CPU backend is unavailable
    (e.g. JAX_PLATFORMS names only an accelerator)."""
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def _as_local(*xs):
    """Co-locate the reduction operands.

    HOST data stays on the host CPU backend: `jnp.asarray` would ship numpy
    inputs to the *default* device and pull each tiny reduction back, one
    transfer per statistic of the figure matrix.  Device-resident jax.Arrays keep
    their placement — UNLESS the operands mix host and device inputs, in
    which case everything moves to the CPU device (mixed-placement
    operands would otherwise raise in the jnp ops below).  Falls back to
    plain asarray when no CPU backend exists.  Returns a list matching xs.
    """
    cpu = _cpu_device()
    if cpu is None:
        return [jnp.asarray(np.asarray(x) if not isinstance(x, jax.Array)
                            else x) for x in xs]
    any_host = any(not isinstance(x, jax.Array) for x in xs)
    any_device = any(isinstance(x, jax.Array) for x in xs)
    out = []
    for x in xs:
        if isinstance(x, jax.Array):
            out.append(jax.device_put(x, cpu) if any_host and any_device
                       else x)
        else:
            out.append(jax.device_put(np.asarray(x), cpu))
    return out


def deviation_stats(dev, axis=0):
    """bias/std/rmse/n over `axis`, NaN-aware (population std, ddof=0 — the
    reference's 1/n convention)."""
    dev, = _as_local(dev)
    valid = jnp.isfinite(dev)
    n = jnp.sum(valid, axis=axis)
    nf = jnp.maximum(n, 1)
    dev0 = jnp.where(valid, dev, 0.0)
    bias = jnp.sum(dev0, axis=axis) / nf
    centered = jnp.where(valid, dev - jnp.expand_dims(bias, axis), 0.0)
    std = jnp.sqrt(jnp.sum(centered**2, axis=axis) / nf)
    rmse = jnp.sqrt(jnp.sum(dev0**2, axis=axis) / nf)
    empty = n == 0
    nan = jnp.float32(jnp.nan)
    return {
        "bias": jnp.where(empty, nan, bias),
        "std": jnp.where(empty, nan, std),
        "rmse": jnp.where(empty, nan, rmse),
        "n": n,
    }


def pearson_r(a, b, axis=0):
    """NaN-aware Pearson correlation along `axis` (xr.corr analogue)."""
    a, b = _as_local(a, b)
    valid = jnp.isfinite(a) & jnp.isfinite(b)
    n = jnp.maximum(jnp.sum(valid, axis=axis), 1)
    a0 = jnp.where(valid, a, 0.0)
    b0 = jnp.where(valid, b, 0.0)
    ma = jnp.sum(a0, axis=axis) / n
    mb = jnp.sum(b0, axis=axis) / n
    da = jnp.where(valid, a - jnp.expand_dims(ma, axis), 0.0)
    db = jnp.where(valid, b - jnp.expand_dims(mb, axis), 0.0)
    cov = jnp.sum(da * db, axis=axis)
    denom = jnp.sqrt(jnp.sum(da**2, axis=axis) * jnp.sum(db**2, axis=axis))
    return jnp.where(denom > 0, cov / jnp.maximum(denom, 1e-30), jnp.nan)


def stats_by_channel(values, reference, axis=0):
    """Per-channel statistics of `values - reference`
    (stats_by_channel, multi_campaign_plots_and_ana.py:155-178)."""
    values, reference = _as_local(values, reference)
    out = deviation_stats(values - reference, axis=axis)
    out["r"] = pearson_r(values, reference, axis=axis)
    return out


def common_valid_mask(*arrays, axis=None):
    """Mask of samples finite in every input — the reference's
    common-valid-timestep rule (valid_indices_and_count,
    multi_campaign_plots_and_ana.py:379-395).  Reduces each array over all
    axes except the first unless `axis` given."""
    mask = None
    for a in arrays:
        a, = _as_local(a)
        fin = jnp.isfinite(a)
        red = tuple(range(1, a.ndim))
        m = jnp.all(fin, axis=red) if a.ndim > 1 else fin
        mask = m if mask is None else (mask & m)
    return mask
