"""Profiler traces and device timing for the forward operators.

The reference has no tracing/profiling at all — performance knowledge lives
in code comments ("Dieser Code ist sehr langsam",
/root/reference/python_src/proc/PyRTlib_processing.py:84; "Processing took
602.0 seconds", old_mwrpy_sim_wrapper/processing_via_mwrpy_sim_4zen.py:97).

`trace` captures a `jax.profiler` trace into the checkout;
`device_op_times` reduces it to device time per kernel and the device's busy
time, and `fusion_layers` names the layer (the `jax.named_scope` of the ops:
absorption, geometry, rte, fast_regression) each fusion of a compiled
program comes from.  `device_time` times a jittable function by the
difference of two dispatch chains, so the fixed cost of dispatching and
reading back a result cancels.  No peak rate of any device is assumed here:
a roofline share needs a measured peak of the card it ran on.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import re
import subprocess
import time

import jax
import jax.numpy as jnp

TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "traces")


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR):
    """Capture a jax.profiler trace (read it with
    `jax.profiler.ProfileData.from_file`, or view it with xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_op_times(log_dir: str, device: str = "/device:GPU:0"):
    """Device time per kernel in the newest trace under `log_dir`.

    Returns (ops, busy_ns, window_ns): `ops` maps each kernel name to
    [total ns, launches]; busy is the union of the kernel intervals on
    `device`, the window the span from the first kernel's start to the last
    one's end (1 - busy / window is the device's idle share in it).
    """
    paths = glob.glob(os.path.join(log_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    newest = max(paths, key=os.path.getmtime)
    spans, ops = [], {}
    for plane in jax.profiler.ProfileData.from_file(newest).planes:
        if plane.name != device:
            continue
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                tot = ops.setdefault(ev.name, [0.0, 0])
                tot[0] += ev.duration_ns
                tot[1] += 1
    if not spans:
        raise ValueError(f"no kernel of {device} in {newest}")
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return ops, busy, end - spans[0][0]


LAYERS = ("absorption", "geometry", "rte", "fast_regression")


def fusion_layers(hlo_text: str, layers=LAYERS) -> dict:
    """Map each fusion of an optimized HLO module (`compiled.as_text()`) to
    the layers its ops were traced in, e.g. "absorption" or
    "absorption+rte" where XLA fused across two; "other" if none.  Keys are
    the names the GPU kernels get (`.` and `-` become `_`)."""
    bodies, name = {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^%?([\w.\-]+) .*\{$", line)
        if head and not line.startswith(" "):
            name = head.group(1)
            bodies[name] = collections.Counter()
        elif name is not None:
            for op in re.findall(r'op_name="([^"]*)"', line):
                words = set(re.findall(r"\w+", op))
                bodies[name].update(x for x in layers if x in words)
    out = {}
    for m in re.finditer(r"%([\w.\-]+) = [^\n]*? fusion\([^\n]*?"
                         r"calls=%([\w.\-]+)", hlo_text):
        found = bodies.get(m.group(2), {})
        kernel = re.sub(r"[.\-]", "_", m.group(1))
        out[kernel] = "+".join(sorted(found)) or "other"
    return out


def device_time(fn, args, iters: int = 20, trials: int = 3) -> float:
    """Per-call seconds of `fn(*args) -> pytree` with dispatch cost cancelled.

    `fn` must be jit-compatible.  K calls are chained by a carried scalar
    (each call's inputs are perturbed by it, so nothing is memoized, and
    every output element is summed into it, so nothing is dead code); the
    time of a 1-call chain is subtracted from the K-call chain, which
    cancels the fixed dispatch and read-back cost.
    """
    @jax.jit
    def step(a, acc):
        out = fn(*jax.tree.map(lambda x: x + acc * 1e-18, a))
        total = sum(jnp.sum(v) for v in jax.tree.leaves(out))
        return acc + total * 1e-20

    def chain(k):
        acc = jnp.float32(0.0)
        for _ in range(k):
            acc = step(args, acc)
        return float(acc)

    chain(1), chain(iters)  # compile + warm
    # Minimize the two chains separately before subtracting: host jitter is
    # one-sided, and min(t_many) - min(t_one) pairs the two cleanest runs.
    best_one = best_many = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter(); chain(1)
        best_one = min(best_one, time.perf_counter() - t0)
        t0 = time.perf_counter(); chain(iters)
        best_many = min(best_many, time.perf_counter() - t0)
    # The subtraction can go negative on sub-noise workloads; floor it.
    return max((best_many - best_one) / (iters - 1), 1e-9)


def card_description() -> str:
    """Name and power limit of the GPUs, one line each, as `nvidia-smi`
    reports them; a card below its maximum power limit runs slower under
    load, so this goes beside every time measured on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
