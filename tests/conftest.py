"""Test harness configuration.

The suite runs on the CPU with 8 virtual devices, so multi-device sharding
is exercised without accelerators (the standard
`--xla_force_host_platform_device_count` backend — SURVEY.md section 4).
The platform is pinned to the CPU only while no backend is up yet: when
`chip_smoke.py` runs the `gpu`-marked tests inside its own process, the
GPU backend it opened stays in place.

Tests marked `gpu` need a GPU; the `gpu` fixture skips them elsewhere.  On
the card they run inside `python chip_smoke.py`.
"""

import os

import jax
import numpy as np
import pytest
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent XLA compilation cache, shared by the xdist workers and across
# runs (parallel/compile_cache.py: JAX_COMPILATION_CACHE_DIR if set, else a
# fixed directory in the checkout).  Disable with MWR_NO_TEST_CACHE=1.
if not os.environ.get("MWR_NO_TEST_CACHE"):
    from mwr_fast_forward_operators_and_lbls_tpu.parallel import compile_cache

    compile_cache.enable()


def pytest_collection_modifyitems(config, items):
    """Skip `slow`-marked tests by default (keep the inner-loop suite short).
    MWR_RUN_SLOW=1 or `-m slow` runs them; CI/pre-commit for physics
    changes should use MWR_RUN_SLOW=1."""
    if os.environ.get("MWR_RUN_SLOW"):
        return
    if "slow" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(
        reason="slow sweep; set MWR_RUN_SLOW=1 (or -m slow) to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The GPU device; skips the test when the process has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; runs on the card inside chip_smoke.py")
    return dev


@pytest.fixture(scope="session")
def demo_batch():
    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl

    # 96 levels span the same 0-25 km column at half the compile cost;
    # production-geometry (180-level) parity is covered by the golden
    # gates, the dryrun and the gpu-marked tests
    return lbl.demo_batch(4, n_levels=96)


@pytest.fixture(scope="session")
def demo_profile_np():
    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl

    return {k: np.asarray(v) for k, v in lbl.demo_profile(64).items()}
