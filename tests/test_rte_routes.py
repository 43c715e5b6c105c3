"""The route-timing tool (tools/rte_routes.py): its Pallas RTE kernel in
interpret mode and its (levels, batch) XLA route, against the library's
batch-major forward."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.models import fast, lbl

_SPEC = importlib.util.spec_from_file_location(
    "rte_routes", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "rte_routes.py"))
rr = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(rr)

ELEVS = (90.0, 4.2)


@pytest.fixture(scope="module")
def profs():
    return lbl.demo_batch(5, n_levels=40)


@pytest.fixture(scope="module")
def fast_params():
    return fast.fit_closed_form(lbl.demo_batch(16, n_levels=40, seed=3))


def _reference(profs, params):
    if params is None:
        return lbl.forward_batch(profs, lbl.LBLConfig(elevations_deg=ELEVS))
    return fast.fast_forward_batch(params, profs,
                                   fast.FastConfig(elevations_deg=ELEVS))


@pytest.mark.parametrize("operator", ["lbl", "fast"])
@pytest.mark.parametrize("trans_level", [False, True],
                         ids=["tb", "trans_level"])
def test_triton_rte_interpret_matches_batch_forward(profs, fast_params,
                                                    operator, trans_level):
    """Level absorption (LBL) and layer extinction (fast operator), with
    and without the transmittance profile; 5 profiles in blocks of 4 and
    39 layers in tiles of 16 exercise the batch and layer padding."""
    params = fast_params if operator == "fast" else None
    alpha, ds, t = rr.lanes_inputs(profs, lbl.LBLConfig().freqs_ghz, ELEVS,
                                   fast_params=params)
    out = rr.rte_triton(alpha, ds, t, jnp.asarray(lbl.LBLConfig().freqs_ghz),
                        alpha_is_mid=params is not None,
                        trans_level=trans_level, block_b=4, block_l=16,
                        interpret=True)
    got = rr.to_public(out, rr.OUTPUTS)
    assert set(got) == set(rr.OUTPUTS[:3 + trans_level])
    ref = _reference(profs, params)
    for k, v in got.items():
        assert v.shape == ref[k].shape
        np.testing.assert_allclose(np.asarray(v), np.asarray(ref[k]),
                                   rtol=1e-5, atol=5e-4, err_msg=k)


def test_xla_lanes_route_matches_batch_forward(profs):
    got = rr.lanes_forward(profs, lbl.LBLConfig().freqs_ghz, ELEVS,
                           rr.OUTPUTS, kernel=False)
    ref = _reference(profs, None)
    for k in rr.OUTPUTS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=5e-4, err_msg=k)
