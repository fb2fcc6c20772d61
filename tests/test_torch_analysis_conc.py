"""The port's concurrency pass (TBX201..TBX206): the same findings as the
JAX package's pass on the shared ``conc/`` corpus (each under its own
package marker) and on the port's own tree, and the port's tests
(``tests/test_torch_*.py``) as the tests that arm its fault sites."""

import os

import pytest

from taboo_brittleness_tpu.analysis.conc import run_conc as jax_run_conc
from taboo_brittleness_tpu_torch.analysis.cli import iter_python_files
from taboo_brittleness_tpu_torch.analysis.conc import ConcModel, run_conc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures", "analysis", "conc")
FAKE_TESTS = os.path.join(CORPUS, "fake_tests")


def _codes_and_lines(findings):
    return sorted((f.code, f.line) for f in findings)


@pytest.mark.parametrize("name,active,suppressed", [
    ("tbx201_shared_attr.py", [("TBX201", 23)], [("TBX201", 49)]),
    ("tbx202_signal_handler.py", [("TBX202", 16)], [("TBX202", 28)]),
    ("tbx203_lock_order.py", [("TBX203", 14)], [("TBX203", 26)]),
    ("tbx204_thread_leak.py", [("TBX204", 8)], [("TBX204", 13)]),
    ("tbx205_atomic_write.py", [("TBX205", 8)], [("TBX205", 13)]),
    ("tbx206_fault_sites.py",
     [("TBX206", 5), ("TBX206", 6), ("TBX206", 24)], [("TBX206", 7)]),
])
def test_conc_corpus_parity_with_jax_pass(name, active, suppressed):
    """The corpus lives under tests/: ``rels`` maps it into each package so
    the scope filter treats it as package code."""
    path = os.path.join(CORPUS, name)
    ta, ts = run_conc([path],
                      rels={path: f"taboo_brittleness_tpu_torch/confix/{name}"},
                      tests_dir=FAKE_TESTS)
    ja, js = jax_run_conc([path],
                          rels={path: f"taboo_brittleness_tpu/confix/{name}"},
                          tests_dir=FAKE_TESTS)
    assert _codes_and_lines(ta) == _codes_and_lines(ja) == active
    assert _codes_and_lines(ts) == _codes_and_lines(js) == suppressed
    assert [(f.scope, f.snippet) for f in ta] == [(f.scope, f.snippet)
                                                  for f in ja]


@pytest.mark.parametrize("rel", [
    "tools/leak.py", "taboo_brittleness_tpu/runtime/leak.py",
    "taboo_brittleness_tpu_torch/analysis/leak.py"])
def test_out_of_scope_files_are_not_modeled(rel):
    """Outside the port's package (the JAX package included), and the
    checker's own ``analysis/``, nothing is modeled."""
    path = os.path.join(CORPUS, "tbx204_thread_leak.py")
    assert run_conc([path], rels={path: rel}, tests_dir=FAKE_TESTS) == ([], [])


def test_port_tree_gives_the_jax_pass_findings():
    """The JAX pass already models the port (its scope test matches the
    port's prefix): on the port's tree, outside the port's own
    ``analysis/`` (which the JAX pass does not exempt), both give the same
    active and suppressed findings."""
    files = [f for f in iter_python_files(
        [os.path.join(REPO, "taboo_brittleness_tpu_torch")])
        if "taboo_brittleness_tpu_torch/analysis/" not in f]
    assert len(files) > 50
    ta, ts = run_conc(files)
    ja, js = jax_run_conc(files)

    def key(fs):
        return sorted((f.path, f.code, f.line, f.message) for f in fs)

    assert key(ta) == key(ja) == []
    assert key(ts) == key(js) and ts


def test_fault_sites_are_armed_by_the_ports_tests():
    """TBX206 reads the port's tests only: every site of the port's
    ``FAULT_SITES`` is named in a ``tests/test_torch_*.py`` file, and none
    of the JAX package's test files is read."""
    from taboo_brittleness_tpu_torch.runtime.resilience import FAULT_SITES

    model = ConcModel.build([], tests_dir="auto")
    assert model.tests_prefix == "test_torch_"
    source = model.tests_source()
    with open(os.path.join(REPO, "tests", "test_torch_resilience.py")) as f:
        assert f.read() in source
    with open(os.path.join(REPO, "tests", "test_resilience.py")) as f:
        assert f.read() not in source
    assert FAULT_SITES and all(site in source for site in FAULT_SITES)
