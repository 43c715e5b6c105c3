"""The process set-up every entry point shares (XLA flags, compile cache),
the forward path's imports, and the GPU smoke script's refusal to run on
the CPU."""
import os
import subprocess
import sys

from mwr_fast_forward_operators_and_lbls_tpu.parallel import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _autotuner_probe(tmp_path, xla_flags, start_backend_first):
    """XLA_FLAGS after `compile_cache.enable()` in a fresh process, and the
    warnings it raised."""
    code = (
        "import os, warnings\n"
        "import jax\n"
        "from mwr_fast_forward_operators_and_lbls_tpu.parallel import "
        "compile_cache\n"
        + ("jax.devices()\n" if start_backend_first else "")
        + "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    compile_cache.enable()\n"
        "print(repr(os.environ.get('XLA_FLAGS', '')))\n"
        "print(len([x for x in w if issubclass(x.category, "
        "RuntimeWarning)]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("XLA_FLAGS", None)
    if xla_flags is not None:
        env["XLA_FLAGS"] = xla_flags
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    flags, n_warn = r.stdout.strip().splitlines()[-2:]
    return eval(flags), int(n_warn)


def test_package_import_leaves_xla_flags_alone(tmp_path):
    """Importing the library changes no process-wide setting."""
    code = ("import os\n"
            "import mwr_fast_forward_operators_and_lbls_tpu.models.lbl\n"
            "print(repr(os.environ.get('XLA_FLAGS')))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "None"


def test_enable_turns_the_fusion_autotuner_off(tmp_path):
    """The set-up every entry point calls switches XLA's GPU fusion
    autotuner off (its per-tiling compiles took minutes for the
    absorption) and keeps the flags it found."""
    flags, n_warn = _autotuner_probe(tmp_path, "--xla_dump_hlo_as_text",
                                     start_backend_first=False)
    assert flags.split() == ["--xla_dump_hlo_as_text",
                             compile_cache.AUTOTUNER_FLAG]
    assert n_warn == 0


def test_enable_keeps_a_caller_set_autotuner_choice(tmp_path):
    want = "--xla_gpu_experimental_enable_fusion_autotuner=true"
    flags, n_warn = _autotuner_probe(tmp_path, want,
                                     start_backend_first=False)
    assert flags == want and n_warn == 0


def test_enable_warns_once_the_backend_is_up(tmp_path):
    """XLA reads its flags when the backend starts: set later, the flag
    would do nothing, so `enable` leaves XLA_FLAGS alone and warns."""
    flags, n_warn = _autotuner_probe(tmp_path, None,
                                     start_backend_first=True)
    assert flags == "" and n_warn == 1


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_lies_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_chip_smoke_refuses_the_cpu(tmp_path):
    """`chip_smoke.py` needs a GPU: under JAX_PLATFORMS=cpu it exits
    non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_forward_path_imports_only_the_sure_packages(tmp_path):
    """The forward path (CLI, pipeline, models) imports no package beyond
    JAX, numpy, scipy and optax at module level: matplotlib (figures),
    h5py (NetCDF-4) and orbax (checkpoints) stay lazy."""
    code = (
        "import builtins, sys\n"
        "real = builtins.__import__\n"
        "def guard(name, *a, **k):\n"
        "    if name.split('.')[0] in ('matplotlib', 'h5py', 'orbax'):\n"
        "        raise ImportError('blocked ' + name)\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = guard\n"
        "import mwr_fast_forward_operators_and_lbls_tpu.cli.main\n"
        "import mwr_fast_forward_operators_and_lbls_tpu.pipeline\n"
        "import mwr_fast_forward_operators_and_lbls_tpu.models.spectral\n"
        "import mwr_fast_forward_operators_and_lbls_tpu.models.retrieval\n"
        "import mwr_fast_forward_operators_and_lbls_tpu.parallel\n"
        "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
