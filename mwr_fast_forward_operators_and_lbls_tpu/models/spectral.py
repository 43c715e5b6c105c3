"""High-resolution monochromatic forward: 50k-frequency spectra + SRF.

BASELINE config 4 — the spectral "long context" of this domain (SURVEY.md
section 5): brightness-temperature spectra on a dense monochromatic grid,
convolved with channel spectral response functions.  The reference's LBL
only ever evaluates the 14 channel centers (PyRTlib_processing.py:87-88);
this module is the native high-res capability.

Layout: frequency is the minor axis end to end.  Absorption is the same
XLA `total_absorption` the channel forward uses, broadcast over a chunk of
the grid as (B, L, Fc); the RTE runs in (B, L, Fc) with the level-axis
prefix sum as `jnp.cumsum`.  The grid is processed in frequency chunks to
bound device-memory residency, so a 50k-point spectrum streams through in
~25 chunks of 2048.

For K-matrices of channel TBs use models/jacobians.py; the spectral path is
differentiable too, but nothing here is tuned for reverse mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import physics as phys
from ..ops import geometry, rte, thermo
from ..ops.absorption import total_absorption


def _rte_freq_minor(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Downwelling TB with frequency on the minor axis.

    alpha: (B, L, F); ds_km: (B, L-1); t_k: (B, L); f_ghz: (F,).
    Returns tb (B, F), tau_total (B, F).
    """
    alpha_mid = 0.5 * (alpha[:, :-1] + alpha[:, 1:])
    dtau = alpha_mid * ds_km[:, :, None]                 # (B, L-1, F)
    ctau = jnp.cumsum(dtau, axis=1)
    e_ctau = jnp.exp(-ctau)
    trans_below = jnp.concatenate(
        [jnp.ones_like(e_ctau[:, :1]), e_ctau[:, :-1]], axis=1)
    tau_total = ctau[:, -1]
    trans_total = e_ctau[:, -1]

    b = rte.planck_tb(t_k[:, :, None], f_ghz[None, None, :])  # (B, L, F)
    g_bot, g_top = rte._emission_factors(dtau)
    atm = jnp.sum((g_bot * b[:, :-1] + g_top * b[:, 1:]) * trans_below,
                  axis=1)                                 # (B, F)
    cosmic = rte.planck_tb(t_cosmic, f_ghz)[None] * trans_total
    tb = rte.inverse_planck_tb(atm + cosmic, f_ghz[None])
    return tb, tau_total


@functools.partial(jax.jit, static_argnames=("model", "elevations_deg"))
def _forward_chunk(profiles, f_chunk, elevations_deg, model):
    p, t, rho = profiles["p"], profiles["t"], profiles["rho"]
    z = profiles["z"]
    lwc = profiles.get("lwc")
    if lwc is None:
        lwc = jnp.zeros_like(rho)
    f = f_chunk.astype(jnp.float32)
    alpha = total_absorption(f, p[..., None], t[..., None], rho[..., None],
                             lwc[..., None], model=model)  # (B, L, Fc)

    e_hpa = thermo.rho_to_e(rho, t)
    tbs, taus = [], []
    for el in elevations_deg:
        ds = jax.vmap(lambda zi, pi, ti, ei: geometry.slant_path_lengths(
            zi, pi, ti, ei, el))(z, p, t, e_hpa)          # (B, L-1)
        tb, tau = _rte_freq_minor(alpha, ds, t, f)
        tbs.append(tb)
        taus.append(tau)
    return jnp.stack(tbs, axis=1), jnp.stack(taus, axis=1)  # (B, E, Fc)


def forward_spectral(profiles: dict, f_ghz, elevations_deg=(90.0,),
                     model: str = "R24", freq_chunk: int = 2048) -> dict:
    """Monochromatic TB spectra: (B, L) profiles x (F,) grid -> (B, E, F).

    Streams the frequency grid in chunks of `freq_chunk`; the last chunk is
    padded to the same width (one compiled program for every chunk), so
    peak device residency is one (B, L, chunk) absorption block whatever F.
    """
    f = jnp.asarray(f_ghz, jnp.float32)
    nf = f.shape[0]
    elevs = tuple(float(e) for e in elevations_deg)
    chunk = min(freq_chunk, nf)
    tbs, taus = [], []
    for start in range(0, nf, chunk):
        fc = f[start:start + chunk]
        npad = chunk - fc.shape[0]
        if npad:
            fc = jnp.concatenate([fc, jnp.broadcast_to(fc[-1:], (npad,))])
        tb, tau = _forward_chunk(profiles, fc, elevs, model)
        good = tb.shape[-1] - npad
        tbs.append(tb[..., :good])
        taus.append(tau[..., :good])
    return {"tb": jnp.concatenate(tbs, -1), "tau_total": jnp.concatenate(taus, -1)}


def srf_convolve(tb_mono, weights):
    """Channel-SRF convolution (one matmul): (..., F) x (C, F) -> (..., C)."""
    wsum = jnp.sum(weights, axis=-1, keepdims=True)
    return jnp.einsum("...f,cf->...c", tb_mono,
                      weights / jnp.maximum(wsum, 1e-30),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
