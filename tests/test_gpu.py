"""Accuracy gates that need the GPU (marker `gpu`; skipped on the CPU).

They run on the card inside `python chip_smoke.py`, which calls pytest in
its own process.  On the card XLA sums in another order than on the CPU and
a float32 matmul may run in TF32 unless its precision is stated: these gates
hold what the CPU suite cannot see."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu.anchors import standard_profiles
from mwr_fast_forward_operators_and_lbls_tpu.models import fast, lbl

GOLDEN = pathlib.Path(__file__).parent / "golden" / "tb_standard.json"

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("model", ["R98", "R17", "R20", "R24"])
def test_xla_fp32_tb_within_budget_of_anchor(gpu, model):
    """The float32 XLA forward on the card stays within the 0.05 K budget
    of the frozen float64 anchor, for each of the reference's releases."""
    g = json.loads(GOLDEN.read_text())
    profs = {k: jnp.asarray(v, jnp.float32)
             for k, v in standard_profiles().items()}
    cfg = lbl.LBLConfig(model=model, outputs=("tb",),
                        elevations_deg=tuple(g["elevations_deg"]))
    tb = np.asarray(lbl.forward_batch(profs, cfg)["tb"])
    err = np.abs(tb - np.asarray(g["tb"][model])).max()
    assert err < 0.05, f"{model}: fp32 TB drifts {err:.4f} K on the card"


def test_forward_does_not_depend_on_matmul_precision(gpu):
    """The LBL forward at the headline shape gives the same TBs under the
    default matmul precision as under "highest" (within 0.005 K): nothing
    on the path runs a float32 product in TF32."""
    profs = jax.device_put(lbl.demo_batch(256, n_levels=180))
    cfg = lbl.LBLConfig(outputs=("tb", "tau_total"))
    got = lbl.forward_batch(profs, cfg)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p: lbl.forward_batch(p, cfg))(profs)
    assert float(jnp.abs(got["tb"] - ref["tb"]).max()) < 0.005


def test_fast_operator_does_not_depend_on_matmul_precision(gpu):
    profs = jax.device_put(lbl.demo_batch(128, n_levels=180))
    params = fast.fit_closed_form({k: v[:32] for k, v in profs.items()})
    got = fast.fast_forward_batch(params, profs)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p: fast.fast_forward_batch(params, p))(profs)
    for k in ref:
        err = float(jnp.abs(got[k] - ref[k]).max())
        assert err < (5e-3 if k in ("tb", "t_mr") else 1e-4), (k, err)
