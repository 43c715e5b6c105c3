"""Optimal-estimation (1D-Var) retrieval loop on the fast operator K-matrix.

BASELINE config 5: "fast-operator distillation ... + K-matrix retrieval
loop".  The reference consumes retrieved temperature/humidity profiles from
the instruments' own neural-network software (MWR L2 files,
/root/reference/python_src/preproc/MWR_read_in_module.py:286-363); the
native framework closes that loop itself: Gauss-Newton optimal estimation
(Rodgers 2000) inverting observed multi-elevation TBs for (T, rho) profiles,
with the forward model and its exact autodiff K-matrix both running on the accelerator.

State vector: x = [T (L), ln rho (L)] on the fixed level grid — humidity in
log space, the standard 1D-Var choice: positivity is structural (no clamping
that would zero K-matrix columns) and the K/V-band response is closer to
linear in ln(rho) along optically thick slant paths.  Each iteration uses the
measurement-space ("m-form") Gauss-Newton update, which never inverts the
prior:
  x_{k+1} = xa + Sa K^T (K Sa K^T + Se)^-1 (y - F(x_k) + K (x_k - xa))
with K = dF/dx from the CLOSED-FORM fast-operator K-matrix
(`jacobians.kmatrix_fast_adjoint_single`: diagonal extinction partials via
layer locality + the hand-written RTE adjoint + tridiagonal geometry
sensitivities — ~3 forward-shaped passes instead of the E*C backward
passes `jax.jacrev` costs; BENCH r4 -> r5 took the retrieval from 3.8 ms
to well under 1 ms/profile).  The (m x m) system (K Sa K^T + Se) is
symmetric positive definite by construction, so it is solved by an
on-device fp32 Cholesky factorization
(`jax.scipy.linalg.cho_factor`/`cho_solve`); iterations are a `lax.scan`,
so the whole retrieval jits and vmaps over profile batches.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from . import fast as fast_mod

# fp32 products of the solve at full precision: a GPU may otherwise run
# them in TF32 (~3 decimal digits), which the Gauss-Newton update amplifies.
HIGHEST = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class OEMConfig:
    """Static retrieval configuration (hashable -> jit cache key)."""

    elevations_deg: tuple = (90.0, 30.0, 19.2, 14.4, 11.4, 8.4, 6.6, 5.4,
                             4.8, 4.2)
    freqs_ghz: tuple = fast_mod.FastConfig().freqs_ghz
    n_iter: int = 5
    obs_error_k: float = 0.5        # HATPRO radiometric noise [K]
    sigma_t_k: float = 3.0          # prior T std [K]
    sigma_lnrho: float = 0.4        # prior ln(vapor-density) std [~40 %]
    corr_length_levels: float = 8.0  # prior vertical correlation [levels]
    rho_floor: float = 1e-3         # [g/m^3] log-space lower anchor


def _prior_covariance(n_levels: int, sigma: float, corr_len: float):
    """Exponential-correlation prior block (L, L)."""
    i = jnp.arange(n_levels, dtype=jnp.float32)
    c = jnp.exp(-jnp.abs(i[:, None] - i[None, :]) / corr_len)
    return (sigma * sigma) * c


def _forward_tb(x, z, p, lwc, params, fcfg, rho_floor=1e-3):
    """State vector [T, ln rho] -> stacked TB (E*C,)."""
    l = z.shape[0]
    t = x[:l]
    rho = jnp.exp(x[l:]) - rho_floor
    out = fast_mod.fast_forward_batch(
        params, {"z": z[None], "p": p[None], "t": t[None], "rho": rho[None],
                 "lwc": lwc[None]}, fcfg)
    return out["tb"][0].reshape(-1)


@functools.partial(jax.jit, static_argnames=("config",))
def retrieve(params: dict, tb_obs, z_m, p_hpa, t_prior, rho_prior,
             config: OEMConfig = OEMConfig(), lwc_gm3=None):
    """Gauss-Newton OEM retrieval of (T, rho) from observed TBs.

    Args:
      params: fast-operator coefficients (trained by `fast.distill*`).
      tb_obs: (E, C) observed brightness temperatures [K].
      z_m, p_hpa: (L,) level grid (pressure treated as known).
      t_prior, rho_prior: (L,) prior/first-guess profiles.
      lwc_gm3: optional (L,) cloud liquid held fixed.

    Returns dict with t (L,), rho (L,), tb_fit (E, C), iterations' cost (K^2
    units) per step, and the final degrees of freedom for signal.
    """
    fcfg = fast_mod.FastConfig(freqs_ghz=config.freqs_ghz,
                               elevations_deg=config.elevations_deg,
                               outputs=("tb",))
    l = z_m.shape[0]
    lwc = jnp.zeros_like(z_m) if lwc_gm3 is None else lwc_gm3
    y = tb_obs.reshape(-1)
    m = y.shape[0]

    xa = jnp.concatenate([
        t_prior, jnp.log(jnp.maximum(rho_prior, 0.0) + config.rho_floor),
    ]).astype(jnp.float32)
    sa = jnp.zeros((2 * l, 2 * l), jnp.float32)
    sa = sa.at[:l, :l].set(_prior_covariance(
        l, config.sigma_t_k, config.corr_length_levels))
    sa = sa.at[l:, l:].set(_prior_covariance(
        l, config.sigma_lnrho, config.corr_length_levels))
    se_diag = jnp.full((m,), config.obs_error_k**2, jnp.float32)

    fwd = lambda x: _forward_tb(x, z_m, p_hpa, lwc, params, fcfg,
                                config.rho_floor)

    def jac(x):
        """Closed-form K (m, 2L) wrt [T, ln rho] at state x."""
        from . import jacobians

        t = x[:l]
        expx = jnp.exp(x[l:])                 # = rho + rho_floor
        rho = expx - config.rho_floor
        ks = jacobians.kmatrix_fast_adjoint_single(
            params, z_m, p_hpa, t, rho, lwc, fcfg, wrt=("t", "rho"))
        k_t = ks["t"].reshape(m, l)
        # chain rule into log space: d rho / d x_lnrho = exp(x) .
        k_lnrho = ks["rho"].reshape(m, l) * expx[None, :]
        return jnp.concatenate([k_t, k_lnrho], axis=1)

    def _m_form_solve(k, rhs):
        """Cholesky-solve (K Sa K^T + Se) u = rhs; return Sa K^T u."""
        sa_kt = jnp.matmul(sa, k.T, precision=HIGHEST)          # (2L, m)
        s = jnp.matmul(k, sa_kt, precision=HIGHEST) + jnp.diag(se_diag)
        c, low = jax.scipy.linalg.cho_factor(s, lower=True)
        return sa_kt, jax.scipy.linalg.cho_solve((c, low), rhs)

    def step(x, _):
        f = fwd(x)
        k = jac(x)                                   # (m, 2L)
        sa_kt, u = _m_form_solve(
            k, y - f + jnp.matmul(k, x - xa, precision=HIGHEST))
        x_new = xa + jnp.matmul(sa_kt, u, precision=HIGHEST)
        cost = jnp.mean((y - f) ** 2)
        return x_new, cost

    x, costs = jax.lax.scan(step, xa, None, length=config.n_iter)

    f = fwd(x)
    k = jac(x)
    # averaging kernel A = Sa K^T (K Sa K^T + Se)^-1 K; dofs = tr(A)
    sa_kt, u = _m_form_solve(k, k)                   # u: (m, 2L)
    dofs = jnp.trace(jnp.matmul(sa_kt, u, precision=HIGHEST))
    return {
        "t": x[:l],
        "rho": jnp.maximum(jnp.exp(x[l:]) - config.rho_floor, 0.0),
        "tb_fit": f.reshape(len(config.elevations_deg), -1),
        "cost": costs,
        "dofs": dofs,
    }


def retrieve_batch(params: dict, tb_obs, z_m, p_hpa, t_prior, rho_prior,
                   config: OEMConfig = OEMConfig(), lwc_gm3=None):
    """vmap of `retrieve` over a leading batch axis of every array input."""
    lwc = jnp.zeros_like(z_m) if lwc_gm3 is None else lwc_gm3
    return jax.vmap(
        lambda tb, z, p, t0, r0, w: retrieve(params, tb, z, p, t0, r0,
                                             config, w)
    )(tb_obs, z_m, p_hpa, t_prior, rho_prior, lwc)
