"""Fast predictor-regression operator: distillation fidelity + autodiff.

The acceptance envelope mirrors the reference's own evaluation of its fast
models: RTTOV-gb and ARMS-gb are judged against the R24 LBL with +-0.5 K
bias guide-lines (/root/reference/python_src/plot_scripts/
final_zenith_plots.py:160-162).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.models import fast, lbl


@pytest.fixture(scope="module")
def fitted():
    profiles = lbl.demo_batch(16, n_levels=120)
    cfg = fast.FastConfig()
    params = fast.fit_closed_form(profiles, cfg)
    teacher = lbl.forward_batch(
        profiles, lbl.LBLConfig(model="R24"))["tb"]
    return profiles, cfg, params, teacher


def test_forward_shapes(fitted):
    profiles, cfg, params, _ = fitted
    out = fast.fast_forward_batch(params, profiles, cfg)
    assert out["tb"].shape == (16, 10, 14)
    assert np.isfinite(np.asarray(out["tb"])).all()
    assert out["tau_total"].shape == (16, 10, 14)


def test_closed_form_matches_teacher(fitted):
    profiles, cfg, params, teacher = fitted
    pred = fast.fast_forward_batch(params, profiles, cfg)["tb"]
    err = np.asarray(pred - teacher)
    assert np.sqrt((err ** 2).mean()) < 0.02, err
    assert np.abs(err).max() < 0.15


def test_generalizes_to_unseen_profiles(fitted):
    profiles, cfg, params, _ = fitted
    unseen = lbl.demo_batch(8, n_levels=120, seed=777)
    teacher = lbl.forward_batch(unseen, lbl.LBLConfig(model="R24"))["tb"]
    pred = fast.fast_forward_batch(params, unseen, cfg)["tb"]
    err = np.asarray(pred - teacher)
    assert np.sqrt((err ** 2).mean()) < 0.05, err


def test_train_step_reduces_loss(fitted):
    profiles, cfg, params, teacher = fitted
    optimizer = fast._default_optimizer()
    params = jax.tree.map(jnp.copy, params)
    opt_state = optimizer.init(params)
    l0 = fast.distill_loss(params, profiles, teacher, cfg)
    losses = []
    for _ in range(20):
        params, opt_state, loss = fast.train_step(
            params, opt_state, profiles, teacher, cfg, optimizer)
        losses.append(float(loss))
    assert min(losses) <= float(l0) * 1.01


def test_fast_kmatrix_autodiff(fitted):
    """dTB/dT of the fast operator exists and matches finite differences."""
    profiles, cfg, params, _ = fitted
    z = profiles["z"][0]
    p = profiles["p"][0]
    t = profiles["t"][0]
    r = profiles["rho"][0]
    w = profiles["lwc"][0]

    def tb_of_t(tv):
        return fast.fast_forward_single(params, z, p, tv, r, w, 90.0, cfg)["tb"]

    jac = jax.jacrev(tb_of_t)(t)
    assert jac.shape == (14, t.shape[0])
    eps = 0.05
    idx = 3
    fd = (tb_of_t(t.at[idx].add(eps)) - tb_of_t(t.at[idx].add(-eps))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(jac[:, idx]), np.asarray(fd),
                               atol=5e-3)


def test_params_roundtrip(tmp_path, fitted):
    _, _, params, _ = fitted
    path = tmp_path / "fast_params.npz"
    fast.save_params(params, str(path))
    loaded = fast.load_params(str(path))
    np.testing.assert_array_equal(np.asarray(params["w"]),
                                  np.asarray(loaded["w"]))


def test_fast_forward_batch_matches_single():
    """The batched serving path against `fast_forward_single`, one profile
    and elevation at a time, on every output."""
    profiles = lbl.demo_batch(5, n_levels=48)
    cfg = fast.FastConfig(elevations_deg=(90.0, 14.4))
    params = fast.fit_closed_form(profiles, cfg)
    got = fast.fast_forward_batch(params, profiles, cfg)
    assert set(got) == {"tb", "tau_total", "t_mr", "trans_level"}
    for b in (0, 4):
        for e, el in enumerate(cfg.elevations_deg):
            ref = fast.fast_forward_single(
                params, *(profiles[k][b] for k in ("z", "p", "t", "rho",
                                                   "lwc")), el, cfg)
            for k in got:
                np.testing.assert_allclose(
                    np.asarray(got[k])[b, e], np.asarray(ref[k]),
                    rtol=1e-5, atol=2e-3, err_msg=f"{k} b={b} e={e}")


def test_fast_forward_batch_output_selection():
    """Asking for tb alone (the serving configuration) returns only tb, and
    the same TBs as the full set of outputs."""
    import numpy as np

    from mwr_fast_forward_operators_and_lbls_tpu.models import fast, lbl

    train = lbl.demo_batch(16, n_levels=60)
    params, _ = fast.distill(train, fast.FastConfig(), steps=0)
    prof = lbl.demo_batch(8, n_levels=60, seed=3)
    tb_only = fast.fast_forward_batch(
        params, prof, fast.FastConfig(outputs=("tb",)))
    full = fast.fast_forward_batch(params, prof, fast.FastConfig())
    assert set(tb_only) == {"tb"}
    err = float(np.max(np.abs(np.asarray(tb_only["tb"])
                              - np.asarray(full["tb"]))))
    assert err < 2e-3, err
