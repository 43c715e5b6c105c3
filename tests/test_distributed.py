"""Two-process `jax.distributed` bring-up smoke test (CPU, localhost).

The multi-host path (`parallel.mesh.initialize_distributed` +
cross-process collectives) previously existed but was never executed; this
test launches two real OS processes, forms a 2-process JAX cluster over a
localhost coordinator, builds the framework's (data, spectral) mesh over
the *global* device set, and runs a psum-reduced computation — the same
bring-up a multi-host GPU cluster performs (SURVEY.md section 2.3 item 3).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    import jax
    jax.config.update("jax_platforms", "cpu")
    port, pid = sys.argv[1], int(sys.argv[2])

    from mwr_fast_forward_operators_and_lbls_tpu.parallel import mesh as m
    m.initialize_distributed(f"127.0.0.1:{port}", num_processes=2,
                             process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4          # 2 local x 2 processes

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = m.make_mesh()                    # (data=4, spectral=1) global
    assert mesh.devices.size == 4

    # Each process contributes its local shard of a global (4, 8) batch;
    # a jitted global sum must see every shard (the collective crosses the
    # process boundary).
    sharding = NamedSharding(mesh, P("data", None))
    local = np.full((2, 8), float(pid + 1), np.float32)
    arrs = [jax.device_put(local[i:i + 1], d)
            for i, d in enumerate(mesh.local_devices)]
    global_x = jax.make_array_from_single_device_arrays(
        (4, 8), sharding, arrs)

    total = jax.jit(lambda x: jnp.sum(x),
                    out_shardings=NamedSharding(mesh, P()))(global_x)
    want = 8 * 2 * (1.0 + 2.0)              # both processes' shards
    assert abs(float(total) - want) < 1e-6, (float(total), want)
    print(f"proc {pid} OK total={float(total)}")
""")


@pytest.mark.slow
def test_two_process_distributed_psum(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(port),
                               str(pid)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out, out


_FWD_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    import jax
    jax.config.update("jax_platforms", "cpu")
    port, pid = sys.argv[1], int(sys.argv[2])

    from mwr_fast_forward_operators_and_lbls_tpu.parallel import mesh as m
    from mwr_fast_forward_operators_and_lbls_tpu.parallel import (
        sharding as shard_mod)
    from mwr_fast_forward_operators_and_lbls_tpu.models import lbl
    m.initialize_distributed(f"127.0.0.1:{port}", num_processes=2,
                             process_id=pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = m.make_mesh()                      # (data=4, spectral=1) global
    assert mesh.devices.size == 4

    # The SAME deterministic batch on both processes; each contributes its
    # two local rows of the globally (4, L)-sharded profile arrays —
    # at the PRODUCTION 180-level geometry (VERDICT r4 Next #4: toy level
    # counts can miss shape-dependent sharding bugs).
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 19.2, 4.2))
    profiles = {k: np.asarray(v)
                for k, v in lbl.demo_batch(4, n_levels=180).items()}
    sharding = NamedSharding(mesh, P("data", None))
    placed = {}
    for k, v in profiles.items():
        rows = [jax.device_put(v[2 * pid + i: 2 * pid + i + 1], d)
                for i, d in enumerate(mesh.local_devices)]
        placed[k] = jax.make_array_from_single_device_arrays(
            v.shape, sharding, rows)

    # Cross-process GSPMD forward (VERDICT r3 Next #5): the jitted program
    # spans both processes' devices; outputs shard back over `data`.
    out = shard_mod.forward_sharded_placed(placed, mesh, cfg)

    # Reference: the plain single-process forward on the full local batch.
    ref = np.asarray(jax.jit(lambda pr: lbl.forward_batch(pr, cfg)["tb"])(
        {k: jnp.asarray(v) for k, v in profiles.items()}))

    worst = 0.0
    for shard in out["tb"].addressable_shards:
        row0 = shard.index[0].start or 0
        got = np.asarray(shard.data)
        want = ref[row0: row0 + got.shape[0]]
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst < 1e-4, worst
    print(f"proc {pid} FWD OK delta={worst:.2e}")
""")


@pytest.mark.slow
def test_two_process_sharded_forward_matches_single(tmp_path):
    """A 2-host (2-process) mesh runs the production GSPMD forward across
    the process boundary and matches the single-process result — the
    multi-host sharded-forward correctness evidence BASELINE's >= 2-host
    target needs from this one-host environment (VERDICT r3 Next #5)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    script = tmp_path / "fwd_worker.py"
    script.write_text(_FWD_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(port),
                               str(pid)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} FWD OK" in out, out
