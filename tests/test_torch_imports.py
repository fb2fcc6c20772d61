"""The port stands alone: it imports neither JAX nor the JAX package, and
``chip_smoke.py`` fails, printing no result, without a CUDA card or outside
a checkout."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

import taboo_brittleness_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_DIR = os.path.join(REPO, "taboo_brittleness_tpu_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")

FORBIDDEN = re.compile(r"taboo_brittleness_tpu\.|^\s*(import|from)\s+jax\b",
                       re.MULTILINE)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            taboo_brittleness_tpu_torch.__path__, "taboo_brittleness_tpu_torch."))


def _port_files():
    for root, dirs, files in os.walk(PACKAGE_DIR):
        dirs[:] = [d for d in dirs if d != "build"]   # generated output
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, name)
    yield CHIP_SMOKE


def test_every_module_imports_with_jax_blocked():
    modules = _modules()
    for name in ("ops.lens_kernel", "pipelines.word_sweep",
                 "pipelines.token_forcing", "pipelines.prompting",
                 "runtime.delta", "runtime.speculate", "perf.spec_calibrate",
                 "runtime.aot", "runtime.fused", "obs", "obs.trace",
                 "obs.metrics", "obs.progress", "obs.timeseries",
                 "obs.reqtrace", "obs.flightrec", "obs.memory", "serve",
                 "serve.engine", "serve.scheduler", "serve.loadgen",
                 "serve.autotune", "serve.spec_engine", "serve.server",
                 "runtime.supervise", "obs.slo", "serve.replica",
                 "serve.gateway", "obs.top", "obs.profile", "perf.roofline",
                 "plots", "parallel.mesh", "parallel.multihost",
                 "parallel.ring", "parallel.sp"):
        assert f"taboo_brittleness_tpu_torch.{name}" in modules
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                and (m == 'taboo_brittleness_tpu'\n"
        "                     or m.startswith('taboo_brittleness_tpu.')\n"
        "                     or m.startswith('jax')))\n"
        "assert not leaked, leaked\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported eagerly'\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")


def test_no_file_of_the_port_names_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            for match in FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: {match.group(0)!r}")
    assert not offenders, offenders


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_to_run_without_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")
    out = _run_chip_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr


def test_chip_smoke_alone_refuses_to_run(tmp_path):
    shutil.copy(CHIP_SMOKE, tmp_path)
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "checkout" in out.stderr


def test_spawned_rank_entry_points_import_no_jax():
    """What a spawned rank imports holds no JAX: the launcher
    (``parallel.multihost``: ``run_ranks``'s and ``spawn_peers``' ranks),
    the CLI a peer rank re-runs, and the tests' rank functions
    (``tests/torch_parallel_ranks.py``), in a fresh interpreter with
    ``jax`` blocked."""
    tests_dir = os.path.join(REPO, "tests")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {tests_dir!r})\n"
        "import torch_parallel_ranks\n"
        "from taboo_brittleness_tpu_torch import cli\n"
        "from taboo_brittleness_tpu_torch.parallel import multihost, ring, sp\n"
        "assert callable(torch_parallel_ranks.tp_checks)\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                and (m == 'taboo_brittleness_tpu'\n"
        "                     or m.startswith('taboo_brittleness_tpu.')\n"
        "                     or m.startswith('jax')))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "ok"
