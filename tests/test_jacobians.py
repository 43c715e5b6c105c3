"""K-matrix tests: autodiff Jacobians vs finite differences (SURVEY.md
section 4 target: 'autodiff-Jacobian vs finite-difference checks')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.models import jacobians, lbl

jax.config.update("jax_enable_x64", False)

F_SUB = (22.24, 31.4, 54.94)


@pytest.fixture(scope="module")
def prof():
    p = lbl.demo_profile(32, seed=3)
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tb(prof, t=None, rho=None, lwc=None):
    return lbl.forward_single(
        prof["z"], prof["p"],
        prof["t"] if t is None else t,
        prof["rho"] if rho is None else rho,
        prof["lwc"] if lwc is None else lwc,
        jnp.asarray(F_SUB), 30.0, "R24",
    )["tb"]


@pytest.mark.slow
def test_kmatrix_temperature_vs_fd(prof):
    k = jacobians.kmatrix_single(
        prof["z"], prof["p"], prof["t"], prof["rho"], prof["lwc"],
        jnp.asarray(F_SUB), 30.0, "R24", wrt=("t",),
    )["t"]
    # Central differences on a few levels.
    for lev in [0, 10, 30]:
        dt = 0.5
        tp = prof["t"].at[lev].add(dt)
        tm = prof["t"].at[lev].add(-dt)
        fd = (np.asarray(_tb(prof, t=tp)) - np.asarray(_tb(prof, t=tm))) / (2 * dt)
        np.testing.assert_allclose(np.asarray(k[:, lev]), fd, atol=5e-3)


@pytest.mark.slow
def test_kmatrix_vapor_vs_fd(prof):
    k = jacobians.kmatrix_single(
        prof["z"], prof["p"], prof["t"], prof["rho"], prof["lwc"],
        jnp.asarray(F_SUB), 30.0, "R24", wrt=("rho",),
    )["rho"]
    for lev in [0, 15]:
        dr = 0.05
        rp = prof["rho"].at[lev].add(dr)
        rm = prof["rho"].at[lev].add(-dr)
        fd = (np.asarray(_tb(prof, rho=rp)) - np.asarray(_tb(prof, rho=rm))) / (2 * dr)
        np.testing.assert_allclose(np.asarray(k[:, lev]), fd, atol=2e-2)


def test_kmatrix_physical_signs(prof):
    """Liquid and temperature sensitivities have the right signs — ONE
    jacrev computation over a channel set covering both regimes (merging
    the former liquid/temperature tests halves the dominant compile cost,
    VERDICT r3 Next #8)."""
    f = jnp.asarray((22.24, 31.4, 58.0))

    def tb_of(t, lwc):
        return lbl.forward_single(prof["z"], prof["p"], t, prof["rho"],
                                  lwc, f, 90.0, "R24")["tb"]

    jt, jl = jax.jacrev(tb_of, argnums=(0, 1))(prof["t"], prof["lwc"])
    k_t, k_lwc = np.asarray(jt), np.asarray(jl)
    # Adding liquid in the low troposphere warms the semi-transparent channels.
    assert np.all(k_lwc[0, 2:20] > 0.0)  # 22.24 GHz
    assert np.all(k_lwc[1, 2:20] > 0.0)  # 31.4 GHz
    # In an opaque channel, TB ~ near-observer air temperature: warming the
    # lowest levels must warm TB ...
    assert np.all(k_t[2, :5] > 0.0)      # 58.0 GHz
    # ... and the total temperature sensitivity integrates to ~1.
    assert 0.7 < float(k_t[2].sum()) < 1.3


def test_kmatrix_batch_shapes(prof):
    profiles = {k: v[None, :].repeat(2, 0) for k, v in prof.items()}
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 4.2),
                        freqs_ghz=F_SUB)
    out = jacobians.kmatrix_batch(profiles, cfg, wrt=("t", "rho"))
    assert out["t"].shape == (2, 2, 3, 32)
    assert out["rho"].shape == (2, 2, 3, 32)
    assert np.all(np.isfinite(np.asarray(out["t"])))


def test_kmatrix_batch_fast_matches_jacrev(prof):
    """The diagonal-adjoint fast path must agree with brute-force jacrev to
    fp32 reassociation noise — same physics, different factorization."""
    profiles = {k: v[None, :].repeat(3, 0) for k, v in prof.items()}
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 14.4, 4.2),
                        freqs_ghz=F_SUB)
    ref = jacobians.kmatrix_batch(profiles, cfg, wrt=("t", "rho", "lwc"))
    fastk = jacobians.kmatrix_batch_fast(profiles, cfg,
                                         wrt=("t", "rho", "lwc"))
    for name in ("t", "rho", "lwc"):
        a, b = np.asarray(ref[name]), np.asarray(fastk[name])
        assert a.shape == b.shape == (3, 3, 3, 32)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, atol=2e-4 * max(scale, 1.0),
                                   err_msg=name)


def test_kmatrix_batch_fast_pressure_term(prof):
    """wrt='p' exercises the 4th linearize seed + the geometry direct path."""
    profiles = {k: v[None, :] for k, v in prof.items()}
    cfg = lbl.LBLConfig(model="R98", elevations_deg=(30.0,), freqs_ghz=F_SUB)
    ref = jacobians.kmatrix_batch(profiles, cfg, wrt=("p",))
    fastk = jacobians.kmatrix_batch_fast(profiles, cfg, wrt=("p",))
    a, b = np.asarray(ref["p"]), np.asarray(fastk["p"])
    np.testing.assert_allclose(b, a, atol=2e-4 * max(np.abs(a).max(), 1.0))


def test_fast_kmatrix_matches_finite_difference():
    from mwr_fast_forward_operators_and_lbls_tpu.models import fast, jacobians

    profiles = lbl.demo_batch(4, n_levels=32)
    cfg = fast.FastConfig(elevations_deg=(90.0, 30.0))
    params = fast.fit_closed_form(profiles, cfg)
    k = jacobians.kmatrix_fast_batch(params, profiles, cfg, wrt=("t",))
    assert k["t"].shape == (4, 2, 14, 32)

    # central finite difference on one level of one profile
    lev, prof = 5, 1
    eps = 0.05
    def tb(dt):
        pr = {kk: np.array(v, copy=True) for kk, v in profiles.items()}
        pr["t"][prof, lev] += dt
        return np.asarray(fast.fast_forward_batch(
            params, {kk: jnp.asarray(v) for kk, v in pr.items()}, cfg)["tb"])
    fd = (tb(eps) - tb(-eps)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(k["t"])[prof, :, :, lev],
                               fd[prof], rtol=0, atol=5e-3)
