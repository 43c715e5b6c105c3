"""Scaling-efficiency benchmark harness (BASELINE target: >= 90 %
grid-points/s efficiency from 1 chip to 1 host to multiple hosts).

Weak scaling on the workload's natural axis: the profile batch.  Each device
gets a fixed per-device batch; efficiency at n devices is
(rate_n / n) / rate_1.  The forward is embarrassingly parallel (SURVEY.md
section 2.3), so the only cross-device traffic is output gathering — near-
perfect efficiency is the expectation, and a regression here means a
sharding rule started moving data.

Run on real hardware: `python -m mwr_fast_forward_operators_and_lbls_tpu.parallel.scaling`
(uses every visible device).  The harness itself is testable on the CPU
virtual-device mesh.
"""

from __future__ import annotations

import json

import jax

from ..models import lbl
from . import mesh as mesh_mod
from . import profiling
from . import sharding as shard_mod


def measure(per_device_batch: int = 256, n_levels: int = 180,
            device_counts=None, config: lbl.LBLConfig | None = None,
            iters: int = 11) -> list:
    """Weak-scaling sweep; returns [{n_devices, seconds, spectra_per_s,
    efficiency, sharding_overhead_eff}] relative to the first entry.

    Two efficiency readings, because they answer different questions:

    * ``efficiency`` — per-device throughput invariance
      ((rate_n / n) / rate_1): THE weak-scaling number on real hardware,
      where each device adds compute.  Meaningless on a virtual
      single-host CPU mesh (all "devices" share the same cores, so per-
      device rate necessarily drops ~1/n).
    * ``sharding_overhead_eff`` — aggregate throughput invariance
      (rate_n / rate_1 at n x the work in n shards vs 1 shard of 1 x): the
      number the virtual mesh CAN measure honestly.  The physical compute
      is identical in both runs, so any drop below 1.0 is pure sharding
      cost — GSPMD-inserted collectives/relayouts moving data.  ~1.0 here
      is the CPU-mesh evidence that the sharding rules are communication-
      free, which is what makes >= 90 % weak scaling achievable when each
      mesh entry is a real chip.
    """
    devices = jax.devices()
    if device_counts is None:
        device_counts = sorted({1, len(devices)})
    if config is None:
        config = lbl.LBLConfig(model="R24", outputs=("tb",))
    n_elev = len(config.elevations_deg)
    results = []
    base_per_dev = base_rate_per_work = None
    for n in device_counts:
        if n > len(devices):
            break
        m = mesh_mod.make_mesh(devices[:n])
        batch = per_device_batch * n
        profiles = lbl.demo_batch(batch, n_levels=n_levels)
        placed = shard_mod.shard_profiles(profiles, m)
        t = profiling.device_time(
            lambda pr: shard_mod.forward_sharded_placed(pr, m, config),
            (placed,), iters=iters)
        rate = batch * n_elev / t
        per_dev = rate / n
        if base_per_dev is None:
            base_per_dev = per_dev
            base_rate_per_work = rate
        results.append({
            "n_devices": n,
            "seconds": t,
            "spectra_per_s": rate,
            "efficiency": per_dev / base_per_dev,
            # aggregate-rate invariance: on a shared-core virtual mesh the
            # physical compute is fixed, so rate_n / rate_1 isolates pure
            # sharding cost (> 1.0 on real hardware, where it is instead
            # n x efficiency).
            "sharding_overhead_eff": rate / base_rate_per_work,
        })
    # Make the committed artifact self-describing (VERDICT r3 Next #7): a
    # reader must not interpret `efficiency` as weak scaling when the mesh
    # entries are virtual devices sharing one host's cores.
    backend = jax.default_backend()
    virtual = backend == "cpu"
    for row in results:
        row["platform"] = backend
        row["note"] = (
            "virtual single-host CPU mesh: all devices share the same "
            "cores, so `efficiency` (per-device rate) necessarily drops "
            "~1/n and is NOT a weak-scaling measurement; "
            "`sharding_overhead_eff` (aggregate-rate invariance, ~1.0 = "
            "communication-free sharding) is the meaningful column here"
            if virtual else
            "real multi-device mesh: `efficiency` is the weak-scaling "
            "number (BASELINE target >= 0.90)")
    return results


def main():  # pragma: no cover - hardware entry point
    for row in measure():
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in row.items()}))


if __name__ == "__main__":  # pragma: no cover
    main()
