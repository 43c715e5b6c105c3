"""Root conftest: opt-in xdist parallelism.

The suite is CPU-bound (XLA-CPU compiles); two xdist workers keep the
default run short.  Injecting `-n 2` here instead of pytest.ini's addopts
keeps pytest-xdist a SOFT dependency: a bare `pytest` without the plugin
installed (or with `-p no:xdist`) still runs, just serially, and any
explicit -n/--numprocesses on the command line wins.
"""


def pytest_load_initial_conftests(early_config, parser, args):
    try:
        import xdist  # noqa: F401
    except ImportError:
        return
    if any("no:xdist" in a for a in args):    # plugin explicitly disabled
        return
    for a in args:
        if a == "-n" or a.startswith("-n") or a.startswith("--numprocesses"):
            return
    # loadscope keeps each module on one worker so module-scoped fixtures
    # (LBL forwards, distilled operators, CLI chains) are built once, not
    # once per worker
    args[:] = ["-n", "2", "--dist", "loadscope"] + args
