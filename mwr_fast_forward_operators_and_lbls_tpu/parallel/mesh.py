"""Device-mesh construction and distributed bring-up.

The reference has no distributed execution at all — its hot loop is a
sequential Python nest (/root/reference/python_src/proc/
PyRTlib_processing.py:99-151) and its only "batching" is a 20-profile
file-size workaround (/root/reference/python_src/proc/
RTTOV_gb_processing.py:33,445).  This framework treats scale as a
first-class axis instead: the workload is embarrassingly parallel over
profiles x angles (the `data` axis) and over monochromatic frequencies
(the `spectral` axis — this domain's "sequence" dimension, SURVEY.md
section 5), so a 2-D mesh covers every configuration from one device to a
multi-host cluster.

Axes:
  data:     profiles (and their elevation/azimuth fan-out) — pure DP;
            the only cross-device traffic is psum of statistics
            accumulators and gradient reductions during distillation.
  spectral: monochromatic frequency grid (50k-point high-res LBL) or
            channel/predictor blocks of the fast operator — the model/TP
            axis of this domain; SRF convolution is a reduce over it.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPECTRAL_AXIS = "spectral"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host bring-up (`jax.distributed.initialize`).

    No-op on a single host so the same entry points run everywhere.
    The reference's analogue is nothing — mpi4py/NCCL sit unused in its
    environment dump (SURVEY.md section 2.3).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)


def make_mesh(devices: Sequence[jax.Device] | None = None,
              data: int | None = None,
              spectral: int = 1) -> Mesh:
    """Build a (data, spectral) mesh over the given (default: all) devices.

    If `data` is None the data axis absorbs every device not claimed by
    `spectral`.  Device order follows `jax.devices()`.  The GPUs of one host
    are joined all to all by NVLink, every pair at the same rate, so the
    mesh shape follows the algorithm alone: `data` for the profile batch
    (no traffic but output gathers), `spectral` for the frequency grid (the
    SRF reduction crosses it).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if data is None:
        if n % spectral:
            raise ValueError(f"{n} devices not divisible by spectral={spectral}")
        data = n // spectral
    if data * spectral != n:
        raise ValueError(f"mesh {data}x{spectral} != {n} devices")
    dev_array = np.asarray(devices).reshape(data, spectral)
    return Mesh(dev_array, (DATA_AXIS, SPECTRAL_AXIS))


def single_device_mesh() -> Mesh:
    """A 1x1 mesh — lets every sharded entry point also run on one chip."""
    return make_mesh([jax.devices()[0]], data=1, spectral=1)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m >= n (static batch padding for even sharding)."""
    return int(math.ceil(n / m) * m)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, rank: int = 1) -> NamedSharding:
    """Shard the leading (batch) axis over `data`, replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (rank - 1))))


def spectral_sharding(mesh: Mesh, axis: int, rank: int) -> NamedSharding:
    """Shard axis `axis` of a rank-`rank` array over `spectral`."""
    spec = [None] * rank
    spec[axis] = SPECTRAL_AXIS
    return NamedSharding(mesh, P(*spec))
