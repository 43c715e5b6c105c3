"""Checkpoint + profiling module tests."""
import numpy as np
import jax.numpy as jnp
import optax

from mwr_fast_forward_operators_and_lbls_tpu.models import fast
from mwr_fast_forward_operators_and_lbls_tpu.parallel import checkpoint as ckpt
from mwr_fast_forward_operators_and_lbls_tpu.parallel import profiling


def _state(seed=0):
    params = fast.init_params(seed=seed)
    opt = optax.adam(1e-4)
    return {"params": params, "opt_state": opt.init(params), "step": jnp.int32(0)}


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    p = str(tmp_path / "ck")
    ckpt.save(p, state)
    assert ckpt.exists(p)
    got = ckpt.restore(p, _state(seed=1))
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  np.asarray(state["params"]["w"]))
    assert ckpt.latest_step(got) == 0


def test_manager_resume_and_gc(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), every=1, keep=2)
    state = _state()
    for step in range(4):
        state = {**state, "step": jnp.int32(step)}
        assert mgr.maybe_save(state)
    assert mgr.steps() == [2, 3]
    fresh = _state(seed=2)
    resumed = mgr.restore_or(fresh)
    assert ckpt.latest_step(resumed) == 3
    np.testing.assert_array_equal(np.asarray(resumed["params"]["w"]),
                                  np.asarray(state["params"]["w"]))


def test_manager_every_skips(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), every=10)
    assert not mgr.maybe_save({**_state(), "step": jnp.int32(5)})
    assert mgr.steps() == []


def test_restore_or_without_checkpoint(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "none"))
    fresh = _state()
    assert mgr.restore_or(fresh) is fresh


def test_device_time_measures_work():
    x = jnp.ones((256, 128))
    t = profiling.device_time(lambda a: a * 2.0 + 1.0, (x,), iters=4, trials=1)
    assert np.isfinite(t) and t >= 0.0


def test_distill_checkpoint_resume(tmp_path):
    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl

    profiles = lbl.demo_batch(4, n_levels=24)
    cfg = fast.FastConfig(elevations_deg=(90.0,))
    ckdir = str(tmp_path / "distill")
    p1, _ = fast.distill(profiles, cfg, steps=4, checkpoint_dir=ckdir,
                         checkpoint_every=2)
    mgr = ckpt.CheckpointManager(ckdir, every=2)
    assert mgr.steps()  # checkpoints written
    # resume: a fresh call continues from the last checkpoint and must land
    # on the same final weights (deterministic training)
    p2, _ = fast.distill(profiles, cfg, steps=6, checkpoint_dir=ckdir,
                         checkpoint_every=2)
    p3, _ = fast.distill(profiles, cfg, steps=6)
    np.testing.assert_allclose(np.asarray(p2["w"]), np.asarray(p3["w"]),
                               rtol=0, atol=1e-5)


def test_device_op_times_reduces_a_recorded_gpu_trace():
    """A trace of the absorption recorded on an H100 (five calls of one
    program): device time per kernel, busy time as the union of kernel
    intervals, and the window around them."""
    import os

    trace = os.path.join(os.path.dirname(__file__), "golden", "h100_trace")
    ops, busy, window = profiling.device_op_times(trace)
    assert ops["input_reduce_fusion"] == [3371377.0, 5]
    assert {n for n, (_, k) in ops.items() if k != 5} == set()
    total = sum(ns for ns, _ in ops.values())
    # kernels of one CUDA graph may overlap a little: busy counts it once
    assert total == 5079722.0 and busy == 5078666.0
    assert busy < window == 6474212.0


def test_fusion_layers_names_each_fusion_by_its_named_scope():
    """Every fusion of the compiled LBL forward is attributed to the
    layers (`jax.named_scope`) its ops were traced in."""
    import jax

    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl

    cfg = lbl.LBLConfig(elevations_deg=(90.0, 30.0), outputs=("tb",))
    hlo = jax.jit(lbl.forward_batch, static_argnames="config").lower(
        lbl.demo_batch(2, n_levels=20), cfg).compile().as_text()
    layers = profiling.fusion_layers(hlo)
    assert layers and all(layers.values())
    seen = set("+".join(layers.values()).split("+"))
    assert {"absorption", "geometry", "rte"} <= seen
    assert seen <= set(profiling.LAYERS) | {"other"}
