"""Process set-up for every entry point: XLA flags and the persistent
compilation cache, configured in this one place.

Every CLI invocation is a fresh process, so without a persistent cache each
`run-all` / `distill` / `forward` pays every `jit` first-compile again.  The
reference's own workflow re-runs individual stages constantly
(/root/reference/run_all_procs.sh:1-12), so warm-start compile time is a
first-class cost.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no directory; otherwise the cache lives at one fixed path inside
the checkout (`DEFAULT_DIR`, git-ignored), so every process of the CLI, the
test suite, `bench.py` and `chip_smoke.py` shares it.  The thresholds are
lowered so every executable is cached (the defaults skip fast-compiling
programs, which is most of this framework's host-side shapes).

`enable` also switches XLA's GPU fusion autotuner off, unless `XLA_FLAGS`
already says something about it.  The autotuner compiles each large
elementwise fusion once per candidate tiling to time them; for the
absorption at B=1024 that took minutes against under a second without it
(H100, PERF.md).  XLA reads its flags once, when the backend starts, so the
flag only takes effect if `enable` runs before the first computation; called
later it warns and leaves the running backend as it is.  Library users who
call the models directly can call `enable()` first, or set the flag in
`XLA_FLAGS` themselves.
"""

from __future__ import annotations

import os
import warnings

import jax
from jax._src import xla_bridge

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
AUTOTUNER_FLAG = "--xla_gpu_experimental_enable_fusion_autotuner=false"


def cache_dir() -> str:
    """The directory `enable` uses: the environment's, else DEFAULT_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def disable_fusion_autotuner() -> bool:
    """Add AUTOTUNER_FLAG to XLA_FLAGS unless the caller set that option.

    Returns whether the flag is in force for this process's backend.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_experimental_enable_fusion_autotuner" in flags:
        return AUTOTUNER_FLAG in flags
    if xla_bridge.backends_are_initialized():
        warnings.warn(
            "the JAX backend is already running, so XLA's GPU fusion "
            "autotuner stays on and large fusions may take minutes to "
            "compile; call compile_cache.enable() before the first "
            f"computation or put {AUTOTUNER_FLAG} in XLA_FLAGS",
            RuntimeWarning, stacklevel=3)
        return False
    os.environ["XLA_FLAGS"] = (flags + " " + AUTOTUNER_FLAG).strip()
    return True


def enable() -> str:
    """Set up the process (see the module docstring); returns the cache
    directory."""
    disable_fusion_autotuner()
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def entry_count(path: str) -> int:
    """Number of cached executables under `path` (0 if absent)."""
    try:
        return sum(1 for n in os.listdir(path) if n.endswith("-cache"))
    except FileNotFoundError:
        return 0
