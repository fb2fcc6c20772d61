"""The port's tbx-check (``taboo_brittleness_tpu_torch.analysis``): the same
findings as the JAX package's checker on the shared fixture corpus, the
port-idiom rules on their own seeded corpus (exact codes and lines), the
pragma and baseline engines byte for byte the JAX checker's, and the port
clean under its own gate and CLI."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from taboo_brittleness_tpu.analysis import baseline as jbaseline
from taboo_brittleness_tpu.analysis import core as jcore
from taboo_brittleness_tpu_torch.analysis import baseline as tbaseline
from taboo_brittleness_tpu_torch.analysis import core as tcore
from taboo_brittleness_tpu_torch.analysis.cli import rule_table, run_check
from taboo_brittleness_tpu_torch.analysis.conc import CONC_RULES
from taboo_brittleness_tpu_torch.analysis.core import ModuleContext, analyze_file
from taboo_brittleness_tpu_torch.analysis.rules import JAX_ONLY, RULES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
TORCH_FIXTURES = os.path.join(FIXTURES, "torch")
PORT_REL = "taboo_brittleness_tpu_torch/pipelines/mod.py"
JAX_REL = "taboo_brittleness_tpu/pipelines/mod.py"


def _codes_and_lines(findings):
    return sorted((f.code, f.line) for f in findings)


def _both(path, jax_rel=None, port_rel=None):
    """(JAX active, JAX suppressed, port active, port suppressed) as sorted
    (code, line) lists."""
    ja, js = jcore.analyze_file(path, rel=jax_rel)
    ta, ts = analyze_file(path, rel=port_rel)
    return tuple(_codes_and_lines(x) for x in (ja, js, ta, ts))


# ---------------------------------------------------------------------------
# Parity with the JAX checker on the shared corpus.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "tbx005_mesh_axis.py", "tbx006_nondeterminism.py", "tbx007_wallclock.py",
    "clean.py"])
def test_shared_fixture_parity_with_jax_checker(name):
    ja, js, ta, ts = _both(os.path.join(FIXTURES, name))
    assert ta == ja and ts == js
    if name != "clean.py":
        assert ta, "the shared fixture seeds findings"


@pytest.mark.parametrize("jax_rel,port_rel", [
    (JAX_REL, PORT_REL),
    ("taboo_brittleness_tpu/analysis/cli.py",
     "taboo_brittleness_tpu_torch/analysis/cli.py"),
    ("tools/script.py", "tools/script.py"),
    ("tests/test_x.py", "tests/test_x.py")])
def test_tbx009_parity_and_path_scope(jax_rel, port_rel):
    """Package code flags, the checker's own ``analysis/`` and code outside
    the package do not, and the pragma'd print is suppressed: the same
    lines in both checkers, each under its own package marker."""
    ja, js, ta, ts = _both(os.path.join(FIXTURES, "tbx009_print.py"),
                           jax_rel, port_rel)
    assert ta == ja and ts == js
    flagged = [line for code, line in ta if code == "TBX009"]
    assert flagged == ([10, 11] if port_rel == PORT_REL else [])


PRAGMA_CASES = {
    "trailing": """\
        import time

        def timed():
            t0 = time.time()  # tbx: wallclock-ok — epoch mark is intended
            return t0
    """,
    "comment_block": """\
        import time

        def timed():
            # This epoch mark feeds a log record, not duration math.
            # tbx: TBX007-ok — epoch timestamp intended
            # (see the log schema for why.)
            t0 = time.time()
            return t0
    """,
    "other_rule": """\
        import time

        def timed():
            t0 = time.time()  # tbx: f32-ok — wrong rule
            return t0
    """,
}


@pytest.mark.parametrize("case", sorted(PRAGMA_CASES))
def test_pragma_parity_with_jax_checker(tmp_path, case):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent(PRAGMA_CASES[case]))
    ja, js, ta, ts = _both(str(p))
    assert ta == ja and ts == js
    assert (ta, ts) == (([], [("TBX007", 4 if case != "comment_block" else 7)])
                        if case != "other_rule" else ([("TBX007", 4)], []))
    lines = textwrap.dedent(PRAGMA_CASES[case]).splitlines()
    assert tcore.parse_pragmas(lines) == jcore.parse_pragmas(lines)


def test_baseline_files_and_fingerprints_are_the_jax_checkers(tmp_path):
    """The same findings give the same fingerprints and the same baseline
    file, byte for byte; each checker loads the other's file."""
    fixture = os.path.join(FIXTURES, "tbx007_wallclock.py")
    found, _ = analyze_file(fixture)
    jfound, _ = jcore.analyze_file(fixture)
    assert [tbaseline.fingerprint(f) for f in found] == [
        jbaseline.fingerprint(f) for f in jfound]
    tfile, jfile = tmp_path / "port.json", tmp_path / "jax.json"
    assert tbaseline.save(found, str(tfile)) == jbaseline.save(jfound, str(jfile))
    assert tfile.read_bytes() == jfile.read_bytes()
    assert tbaseline.load(str(jfile)) == jbaseline.load(str(tfile))
    assert not os.path.exists(f"{tfile}.tmp")


def test_baseline_roundtrip_filters_known_findings(tmp_path):
    fixture = os.path.join(FIXTURES, "tbx007_wallclock.py")
    report = run_check([fixture], default_excludes=False)
    assert report.findings
    bl = tmp_path / "baseline.json"
    n = tbaseline.save(report.findings, str(bl))
    assert n == len({tbaseline.fingerprint(f) for f in report.findings})
    with open(bl) as f:
        assert json.load(f)["version"] == 2
    again = run_check([fixture], baseline=str(bl), default_excludes=False)
    assert again.findings == []
    assert len(again.baselined) == len(report.findings)


def test_fingerprint_survives_line_shift_and_file_move(tmp_path):
    src = "import time\n\n\ndef timed():\n    t0 = time.time()\n    return t0\n"
    a = tmp_path / "runtime" / "old.py"
    b = tmp_path / "pipelines" / "new.py"
    for p, text in ((a, src), (b, "# a new header comment\n" + src)):
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    fa = {tbaseline.fingerprint(f) for f in analyze_file(str(a))[0]}
    fb = {tbaseline.fingerprint(f) for f in analyze_file(str(b))[0]}
    assert fa == fb and fa


def test_syntax_error_is_a_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def broken(:\n")
    assert [f.code for f in analyze_file(str(p))[0]] == ["TBX000"]


# ---------------------------------------------------------------------------
# The port's idiom: its own seeded corpus.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,expected", [
    ("tbx001_host_sync.py",
     [("TBX001", 12), ("TBX001", 16), ("TBX001", 17), ("TBX001", 18),
      ("TBX001", 19)]),
    ("tbx002_vocab_f32.py",
     [("TBX002", 7), ("TBX002", 8), ("TBX002", 9), ("TBX002", 10)]),
    ("tbx006_nondeterminism.py",
     [("TBX006", 13), ("TBX006", 14), ("TBX006", 15), ("TBX006", 16),
      ("TBX006", 17), ("TBX006", 18)]),
    ("tbx008_captured_const.py",
     [("TBX008", 11), ("TBX008", 12), ("TBX008", 15)]),
    ("clean.py", []),
])
def test_torch_fixture_rules(name, expected):
    active, suppressed = analyze_file(os.path.join(TORCH_FIXTURES, name))
    assert _codes_and_lines(active) == expected
    assert suppressed == []


def test_device_sync_in_a_captured_step_is_flagged():
    """A device-wide ``torch.cuda.synchronize()`` inside a step handed to
    ``aot.Program``: the fault that invalidated a capture on the card."""
    active, _ = analyze_file(os.path.join(TORCH_FIXTURES,
                                          "tbx001_host_sync.py"))
    sync = [f for f in active if "torch.cuda.synchronize" in f.message]
    assert [(f.line, f.scope) for f in sync] == [(16, "_step")]


@pytest.mark.parametrize("rel,expected", [
    (PORT_REL, [("TBX010", 13)]),
    ("taboo_brittleness_tpu_torch/analysis/deep.py", []),
    ("tests/test_torch_x.py", []),
    ("chip_smoke.py", [])])
def test_tbx010_fixture_and_path_scope(rel, expected):
    path = os.path.join(TORCH_FIXTURES, "tbx010_unannotated_call.py")
    active, suppressed = analyze_file(path, rel=rel)
    assert _codes_and_lines(active) == expected
    assert [f.code for f in suppressed] == (["TBX010"] if expected else [])


def _ctx(tmp_path, source, rel=None):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent(source))
    return ModuleContext(str(p), p.read_text(), rel=rel)


def test_roots_and_their_reach(tmp_path):
    """Each root kind, and the reach through helpers as the JAX checker
    computes it: a Program's step (a lambda's callee, a nested def by name,
    ``self.method``), an entry handed to ``aot.lookup``/``aot.entry``, a
    deep-registry name by module, and a jit binding."""
    ctx = _ctx(tmp_path, """\
        import jax
        from taboo_brittleness_tpu_torch.runtime import aot

        def helper(x):
            return x

        def stepped(x):
            return helper(x)

        def entry_fn(x):
            return x

        def registered(x):
            return x

        def greedy_decode(x):
            return x

        @jax.jit
        def jitted(x):
            return x

        def untraced(x):
            return x

        def launch(x, device):
            def _nested(p):
                return p
            aot.Program(_nested, None)
            aot.entry("e", registered)
            return aot.lookup("l", entry_fn, {}, {}, params=x, device=device,
                              make=lambda: aot.Program(
                                  lambda p: stepped(p), None))

        class Engine:
            def _step(self, p):
                return p

            def program(self):
                return aot.Program(self._step, None)
    """, rel="taboo_brittleness_tpu_torch/runtime/decode.py")
    names = {getattr(f, "name", "<lambda>") for f in ctx.traced}
    assert {"helper", "stepped", "entry_fn", "registered", "greedy_decode",
            "jitted", "_nested", "_step"} <= names
    assert "untraced" not in names and "launch" not in names
    kinds = {(getattr(r.fn, "name", "<lambda>"), r.kind) for r in ctx.roots}
    assert ("greedy_decode", "registry") in kinds
    assert ("jitted", "jit") in kinds and ("entry_fn", "entry") in kinds


def test_registry_roots_need_the_module(tmp_path):
    """A registry name roots only the function of its module."""
    src = "def greedy_decode(x):\n    return x.item()\n"
    here = _ctx(tmp_path, src, rel="taboo_brittleness_tpu_torch/runtime/decode.py")
    elsewhere = _ctx(tmp_path, src, rel="taboo_brittleness_tpu_torch/ops/other.py")
    assert [r.kind for r in here.roots] == ["registry"]
    assert elsewhere.roots == []


def test_mesh_axes_come_from_the_ports_mesh_module(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""\
        def gather(mesh, t):
            a = mesh.all_gather(t, "tp", dim=0)
            b = mesh.all_reduce(t, "model")
            c = mesh.axis_index("dp")
            return a, b, c, local_shard_size(8, mesh, axis="rows")

        def plot(ax):
            ax.tick_params(axis="y")
    """))
    active, _ = analyze_file(str(p))
    assert _codes_and_lines(active) == [("TBX005", 3), ("TBX005", 5)]


# ---------------------------------------------------------------------------
# The rule table and the gate.
# ---------------------------------------------------------------------------

def test_every_code_has_a_unique_alias_and_jax_only_rules_say_why():
    codes = ([r.code for r in RULES] + [r.code for r in JAX_ONLY]
             + [r.code for r in CONC_RULES])
    aliases = ([r.alias for r in RULES] + [r.alias for r in JAX_ONLY]
               + [r.alias for r in CONC_RULES])
    assert sorted(codes) == [f"TBX{n:03d}" for n in
                             (*range(1, 11), *range(201, 207))]
    assert len(set(aliases)) == len(aliases)
    assert {r.code for r in JAX_ONLY} == {"TBX003", "TBX004"}
    assert all("no jit" in r.reason for r in JAX_ONLY)


def test_port_is_clean_under_its_own_gate():
    report = run_check([os.path.join(REPO, "taboo_brittleness_tpu_torch"),
                        os.path.join(REPO, "tests"),
                        os.path.join(REPO, "chip_smoke.py")])
    assert report.findings == [], "\n".join(f.format() for f in report.findings)
    assert report.files_checked > 50
    # The pragmas are in use (reviewed syncs, f32 slabs, CLI prints), not a
    # rule gone quiet.
    codes = {f.code for f in report.suppressed}
    assert {"TBX001", "TBX002", "TBX009"} <= codes


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch.analysis", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_cli_gate_exit_codes(tmp_path):
    clean = _cli("taboo_brittleness_tpu_torch")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    scratch = tmp_path / "scratch.py"
    scratch.write_text(
        "import time\n\n\ndef timed():\n    t0 = time.time()\n    return t0\n")
    dirty = _cli(str(scratch))
    assert dirty.returncode == 1
    assert "TBX007" in dirty.stdout
    captured = tmp_path / "captured.py"
    captured.write_text(open(os.path.join(TORCH_FIXTURES,
                                          "tbx001_host_sync.py")).read())
    baseline = os.path.join(REPO, "taboo_brittleness_tpu_torch", "analysis",
                            "tbx_baseline.json")
    dirty = _cli("--baseline", baseline, str(captured))
    assert dirty.returncode == 1
    assert "TBX001" in dirty.stdout and "synchronize" in dirty.stdout


def test_cli_list_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0
    assert out.stdout.splitlines() == rule_table()
    for code in [f"TBX{n:03d}" for n in (*range(1, 11), 100, 101,
                                         *range(201, 207))]:
        assert code in out.stdout
    aliases = [line.split()[1] for line in out.stdout.splitlines()]
    assert len(set(aliases)) == len(aliases)
    assert "[JAX-only]" in out.stdout
