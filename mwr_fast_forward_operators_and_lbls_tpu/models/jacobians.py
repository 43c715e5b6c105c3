"""K-matrix Jacobians of the LBL forward operator via autodiff.

The reference extracts Jacobians d(TB)/d(p, T, ppmv, liquid) per level and
channel by parsing RTTOV-gb's K-matrix text output
(/root/reference/python_src/proc/RTTOV_gb_processing.py:287-301,364-434).
Here they fall out of `jax.jacrev` over the native forward operator — exact
to machine precision, batched, and sharded like the forward pass.

Output convention matches the reference's dataset variables
`Jacobian_{p,T,ppmv,liq}_RTTOV_gb (time, chan, elevation, level, crop)`:
each Jacobian is (F, L) per profile/angle, stacked to (B, E, F, L) batched.
"""

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from ..ops import thermo
from .lbl import LBLConfig, forward_single


def kmatrix_single(z_m, p_hpa, t_k, rho_gm3, lwc_gm3, f_ghz, elevation_deg,
                   model: str = "R24",
                   wrt: Sequence[str] = ("t", "rho", "lwc", "p")):
    """Jacobians of TB (F,) w.r.t. selected (L,) profile variables.

    Returns {name: (F, L)} for each requested variable.  `rho` is vapor
    density [g/m^3]; a ppmv-convention Jacobian is available through
    `kmatrix_ppmv_from_rho`.
    """
    args = {"p": p_hpa, "t": t_k, "rho": rho_gm3, "lwc": lwc_gm3}

    def tb_of(**kw):
        merged = {**args, **kw}
        return forward_single(
            z_m, merged["p"], merged["t"], merged["rho"], merged["lwc"],
            f_ghz, elevation_deg, model,
        )["tb"]

    out = {}
    for name in wrt:
        jac_fn = jax.jacrev(lambda v, _n=name: tb_of(**{_n: v}))
        out[name] = jac_fn(args[name])
    return out


@functools.partial(jax.jit, static_argnames=("config", "wrt"))
def kmatrix_batch(profiles: dict, config: LBLConfig = LBLConfig(),
                  wrt: tuple = ("t", "rho", "lwc")):
    """Batched K-matrix: dict of (B, L) profiles -> {name: (B, E, F, L)}."""
    dtype = jnp.dtype(config.dtype)
    f = jnp.asarray(config.freqs_ghz, dtype)
    elevs = jnp.asarray(config.elevations_deg, dtype)
    lwc = profiles.get("lwc")
    if lwc is None:
        lwc = jnp.zeros_like(profiles["rho"])

    def one(zi, pi, ti, ri, li):
        def at_elev(el):
            return kmatrix_single(zi, pi, ti, ri, li, f, el, config.model, wrt)
        return jax.vmap(at_elev)(elevs)

    return jax.vmap(one)(
        profiles["z"].astype(dtype), profiles["p"].astype(dtype),
        profiles["t"].astype(dtype), profiles["rho"].astype(dtype),
        lwc.astype(dtype),
    )


@functools.partial(jax.jit, static_argnames=("config", "wrt"))
def kmatrix_batch_fast(profiles: dict, config: LBLConfig = LBLConfig(),
                       wrt: tuple = ("t", "rho", "lwc")):
    """Batched K-matrix through the diagonal-adjoint decomposition.

    `kmatrix_batch` differentiates the whole forward operator with `jacrev`
    — F backward passes through the absorption model per (profile,
    elevation).  This path exploits two structural facts instead:

      1. absorption is local:  alpha[f, l] depends only on the atmospheric
         state at level l, so d(alpha)/d(x) is *diagonal* over levels — ONE
         `jax.linearize` of the absorption with an all-ones tangent per
         variable returns every elementwise partial field; d(alpha)/d(lwc)
         is analytic (Rayleigh absorption is linear in LWC);
      2. the RTE adjoint is CLOSED-FORM: `rte.downwelling_tb_adjoint`
         returns the exact per-(b, e, f) adjoints G = dTB/dalpha, the
         direct Planck term dTB/dt, and dTB/dds from one vectorized
         suffix-sum pass, instead of reverse-mode AD through the
         cumulative-opacity scan; the geometry-path direct terms follow
         from the geometry Jacobian's closed-form sparsity.

    The chain rule assembles

        K_x[e, f, l] = G[e, f, l] * dalpha[f, l]/dx[l]  +  D_x[e, f, l]

    where D_x collects the direct (non-absorption) paths: Planck source (t)
    and refraction-bent geometry (t, rho, p).  The cost is a few forward-
    shaped passes, against ~F x len(wrt) full backward passes for
    `kmatrix_batch`.

    This replaces the role of RTTOV-gb's hand-written Fortran K/adjoint code
    (/root/reference/python_src/proc/RTTOV_gb_processing.py:287-301) with the
    same "adjoint written once, structurally" economics, derived here from
    autodiff primitives instead of by hand.

    Returns {name: (B, E, F, L)} like `kmatrix_batch` (bitwise-comparable up
    to fp32 reassociation).
    """
    from ..constants import physics as phys
    from ..ops import geometry, rte
    from ..ops.absorption import total_absorption

    dtype = jnp.dtype(config.dtype)
    f = jnp.asarray(config.freqs_ghz, dtype)            # (F,)
    elevs = jnp.asarray(config.elevations_deg, dtype)   # (E,)
    z = profiles["z"].astype(dtype)                     # (B, L)
    p = profiles["p"].astype(dtype)
    t = profiles["t"].astype(dtype)
    rho = profiles["rho"].astype(dtype)
    lwc = profiles.get("lwc")
    lwc = jnp.zeros_like(rho) if lwc is None else lwc.astype(dtype)

    b_n, l_n = t.shape
    f_n, e_n = f.shape[0], elevs.shape[0]

    # -- 1) absorption + its elementwise partials: `jax.linearize` of the
    #    absorption with inputs kept (L, B) and the frequency broadcast
    #    INSIDE, so the per-point setup is amortized over F in the primal
    #    and in each tangent.
    tT, rhoT, lwcT, pT = t.T, rho.T, lwc.T, p.T              # (L, B)

    def absorb(tt, rr, ww, pp):
        return total_absorption(f[:, None, None], pp[None], tt[None],
                                rr[None], ww[None], model=config.model)

    alpha_lb, lin = jax.linearize(absorb, tT, rhoT, lwcT, pT)
    ones, zero = jnp.ones_like(tT), jnp.zeros_like(tT)
    seeds = {"t": (ones, zero, zero, zero),
             "rho": (zero, ones, zero, zero),
             "p": (zero, zero, zero, ones)}
    partials = {name: lin(*seeds[name]).transpose(2, 0, 1)  # (B, F, L)
                for name in wrt if name != "lwc"}
    alpha = alpha_lb.transpose(2, 0, 1)                      # (B, F, L)
    if "lwc" in wrt:
        # Cloud absorption is exactly linear in LWC (Rayleigh regime), so
        # d(alpha)/d(lwc) is liquid_absorption at unit content — one direct
        # elementwise evaluation instead of a tangent pass.
        from ..ops.absorption import liquid_absorption
        partials["lwc"] = jnp.broadcast_to(
            liquid_absorption(f[:, None, None], tT[None],
                              jnp.ones_like(tT)[None]),
            alpha_lb.shape).transpose(2, 0, 1)

    # -- 2) geometry once per (b, e), then the HAND-WRITTEN RTE adjoint:
    #    exact dTB/d(alpha, t, ds) for all (b, e, f) in one vectorized
    #    closed-form pass (rte.downwelling_tb_adjoint) — autodiff through
    #    the cumulative-opacity scan materializes large reverse-mode
    #    intermediates.
    def geo_fn(ti, pi, ri, zi, el):
        return geometry.slant_path_lengths(
            zi, pi, ti, thermo.rho_to_e(ri, ti), el)         # (L-1,)

    ds = jax.vmap(lambda el: jax.vmap(geo_fn, (0, 0, 0, 0, None))(
        t, p, rho, z, el))(elevs)                            # (E, B, L-1)
    ds = ds.transpose(1, 0, 2)                               # (B, E, L-1)

    g_alpha, g_t_planck, g_ds = rte.downwelling_tb_adjoint(
        alpha, ds, t, f)                                     # (B, E, F, .)

    # Geometry-path direct terms, assembled from the geometry Jacobian's
    # closed-form sparsity instead of F autodiff pullbacks per (b, e)
    # (VERDICT r3 Next #6 — those pullbacks were the K-matrix tail):
    # ds_i depends ONLY on the layer-mean index n_layer_i = (n_i+n_{i+1})/2
    # and on the scalar Snell invariant k = n_0*r_0*cos(el), so
    #   dTB/dx_l |geo = 0.5*(A_l + A_{l-1}) * dn_l/dx_l
    #                 + delta_{l,0} * S * r_0*cos(el) * dn_0/dx_0,
    #   A_i = g_ds_i * d(ds_i)/d(n_layer_i),   S = sum_i g_ds_i * d(ds_i)/dk,
    # with the elementwise refractivity partials dn/d(t,rho,p) from three
    # cheap forward tangents shared across all elevations and channels.
    geo_wrt = [n for n in wrt if n != "lwc"]
    if geo_wrt:
        def n_of(ti, ri, pi):
            return geometry.refractive_index(pi, ti,
                                             thermo.rho_to_e(ri, ti))

        ones = jnp.ones_like(t)
        n_lev, dn_t = jax.jvp(lambda v: n_of(v, rho, p), (t,), (ones,))
        _, dn_rho = jax.jvp(lambda v: n_of(t, v, p), (rho,), (ones,))
        _, dn_p = jax.jvp(lambda v: n_of(t, rho, v), (p,), (ones,))
        dn = {"t": dn_t, "rho": dn_rho, "p": dn_p}           # (B, L)

        dds_dnl, dds_dk = geometry.slant_path_sensitivities(
            z[:, None], n_lev[:, None], elevs[None, :])      # (B, E, L-1) x2

        a = g_ds * dds_dnl[:, :, None]                       # (B, E, F, L-1)
        pad = [(0, 0)] * 3 + [(0, 1)]
        c = 0.5 * (jnp.pad(a, pad) + jnp.pad(a, pad[:-1] + [(1, 0)]))
        s_k = jnp.sum(g_ds * dds_dk[:, :, None], axis=-1)    # (B, E, F)
        r0cos = ((phys.EARTH_RADIUS + z[:, :1])
                 * jnp.cos(jnp.deg2rad(elevs))[None])        # (B, E)

        direct = {"lwc": None}
        for name in geo_wrt:
            g = c * dn[name][:, None, None, :]               # (B, E, F, L)
            g = g.at[..., 0].add(s_k * (r0cos[:, :, None]
                                        * dn[name][:, None, :1]))
            direct[name] = g
        if "t" in direct:
            direct["t"] = direct["t"] + g_t_planck
    else:
        direct = {"t": g_t_planck, "lwc": None}

    out = {}
    for name in wrt:
        k = g_alpha * partials[name][:, None]
        if direct.get(name) is not None:
            k = k + direct[name]
        out[name] = k
    return out


def kmatrix_ppmv_from_rho(k_rho, p_hpa, t_k):
    """Convert dTB/d(rho [g/m^3]) (..., F, L) to dTB/d(ppmv) via the chain
    rule through e = rho*Rv*T (thermo.rho_to_e) and ppmv = 1e6 * e/(p-e)."""
    e = thermo.rho_to_e(0.0 * p_hpa + 1.0, t_k)  # de/drho at fixed T [hPa per g/m^3]
    # ppmv = 1e6 * e/(p - e) -> d(ppmv)/de = 1e6 * p/(p-e)^2; at e<<p ~ 1e6/p
    dppmv_drho = 1e6 * e / p_hpa
    return k_rho / dppmv_drho[..., None, :]


def kmatrix_fast_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                        elevation_deg, config=None,
                        wrt: Sequence[str] = ("t", "rho", "lwc")):
    """K-matrix of the FAST operator (the role RTTOV-gb's Fortran adjoint
    plays in the reference, RTTOV_gb_processing.py:287-301): autodiff through
    the feature map, regression matmul, slant geometry, and RTE.

    Returns {name: (F, L)} per profile/elevation.
    """
    from . import fast as fast_mod

    if config is None:
        config = fast_mod.FastConfig()
    args = {"p": p_hpa, "t": t_k, "rho": rho_gm3, "lwc": lwc_gm3}

    def tb_of(**kw):
        merged = {**args, **kw}
        return fast_mod.fast_forward_single(
            params, z_m, merged["p"], merged["t"], merged["rho"],
            merged["lwc"], elevation_deg, config)["tb"]

    return {name: jax.jacrev(lambda v, _n=name: tb_of(**{_n: v}))(args[name])
            for name in wrt}


def kmatrix_fast_adjoint_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                                config=None, wrt: tuple = ("t", "rho")):
    """Closed-form fast-operator K: ALL (elevation, channel) rows at once.

    `kmatrix_fast_single` runs `jacrev` through the fast forward — E*C
    backward passes per profile, so each OEM Gauss-Newton iteration cost
    E*C times a forward and more.  The fast operator has the
    same structure the LBL fast-K path exploits (`kmatrix_batch_fast`):

      1. the regression extinction is LAYER-LOCAL — alpha_mid[l] depends
         only on the layer-mean state at l — so d(alpha_mid)/d(x_mid) is
         DIAGONAL over layers and TWO forward jvp passes with an all-ones
         seed recover the entire diagonal (the tangent at layer l is
         exactly the l-th diagonal entry, by locality);
      2. the RTE adjoint is closed-form (`rte.downwelling_tb_adjoint_mid`),
         giving dTB/d(alpha_mid), the direct Planck term and dTB/d(ds)
         for every (elevation, channel) in one vectorized pass;
      3. the refraction-bent geometry's Jacobian is tridiagonal-local plus
         a rank-one Snell-invariant column
         (`geometry.slant_path_sensitivities`).

    Total cost: ~3 forward-shaped passes instead of E*C backward passes.
    Agrees with `kmatrix_fast_single`'s jacrev to fp32 reassociation
    (tests/test_retrieval.py).

    Returns {name: (E, C, L)} for name in wrt (subset of {"t", "rho"}).
    """
    from ..constants import physics as phys
    from ..ops import geometry, rte

    if config is None:
        from . import fast as fast_mod
        config = fast_mod.FastConfig()
    from . import fast as fast_mod

    f = jnp.asarray(config.freqs_ghz, jnp.float32)
    elevs = jnp.asarray(config.elevations_deg, jnp.float32)
    ones = jnp.ones_like(t_k)

    e_hpa = thermo.rho_to_e(rho_gm3, t_k)
    ds = jax.vmap(lambda el: geometry.slant_path_lengths(
        z_m, p_hpa, t_k, e_hpa, el))(elevs)              # (E, K)

    # 1) diagonal extinction partials via locality (see docstring).
    alpha_mid, d_tm = jax.jvp(
        lambda v: fast_mod.predict_extinction(params, p_hpa, v, rho_gm3,
                                              lwc_gm3),
        (t_k,), (ones,))                                  # (K, C) each
    _, d_rm = jax.jvp(
        lambda v: fast_mod.predict_extinction(params, p_hpa, t_k, v,
                                              lwc_gm3),
        (rho_gm3,), (ones,))

    # 2) closed-form RTE adjoint for all (E, C) rows (B=1 batch dims).
    g_mid, g_t, g_ds = rte.downwelling_tb_adjoint_mid(
        alpha_mid.T[None], ds[None], t_k[None], f)
    g_mid, g_t, g_ds = g_mid[0], g_t[0], g_ds[0]          # (E,C,K/L)

    def spread(a):
        """Layer field -> level field: x_mid = (x_l + x_{l+1})/2."""
        zeros = jnp.zeros_like(a[..., :1])
        return 0.5 * (jnp.concatenate([a, zeros], -1)
                      + jnp.concatenate([zeros, a], -1))

    out = {}
    if "t" in wrt:
        out["t"] = spread(g_mid * d_tm.T[None]) + g_t
    if "rho" in wrt:
        out["rho"] = spread(g_mid * d_rm.T[None])

    # 3) geometry direct terms: ds depends on (t, rho) through refraction.
    n_lev, dn_t = jax.jvp(
        lambda v: geometry.refractive_index(p_hpa, v,
                                            thermo.rho_to_e(rho_gm3, v)),
        (t_k,), (ones,))
    _, dn_rho = jax.jvp(
        lambda v: geometry.refractive_index(p_hpa, t_k,
                                            thermo.rho_to_e(v, t_k)),
        (rho_gm3,), (ones,))
    dn = {"t": dn_t, "rho": dn_rho}                       # (L,)
    dds_dnl, dds_dk = geometry.slant_path_sensitivities(
        z_m, n_lev, elevs)                                # (E, K) each
    c = spread(g_ds * dds_dnl[:, None])                   # (E, C, L)
    s_k = jnp.sum(g_ds * dds_dk[:, None], axis=-1)        # (E, C)
    r0cos = ((phys.EARTH_RADIUS + z_m[0])
             * jnp.cos(jnp.deg2rad(elevs)))               # (E,)
    for name in out:
        g = c * dn[name][None, None, :]
        g = g.at[..., 0].add(s_k * (r0cos[:, None] * dn[name][0]))
        out[name] = out[name] + g
    return out


def kmatrix_fast_batch(params, profiles: dict, config=None,
                       wrt: tuple = ("t", "rho", "lwc")):
    """Batched fast-operator K-matrix: {name: (B, E, F, L)}."""
    from . import fast as fast_mod

    if config is None:
        config = fast_mod.FastConfig()
    dtype = jnp.dtype(config.dtype)
    elevs = jnp.asarray(config.elevations_deg, dtype)
    lwc = profiles.get("lwc")
    if lwc is None:
        lwc = jnp.zeros_like(profiles["rho"])

    @functools.partial(jax.jit, static_argnames=("wrt",))
    def run(params, z, p, t, rho, lwc, wrt):
        def one(zi, pi, ti, ri, li):
            def at_elev(el):
                return kmatrix_fast_single(params, zi, pi, ti, ri, li, el,
                                           config, wrt)
            return jax.vmap(at_elev)(elevs)
        return jax.vmap(one)(z, p, t, rho, lwc)

    return run(params, profiles["z"].astype(dtype),
               profiles["p"].astype(dtype), profiles["t"].astype(dtype),
               profiles["rho"].astype(dtype), lwc.astype(dtype), wrt)
