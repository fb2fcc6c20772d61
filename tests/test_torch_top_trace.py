"""The port's ``top`` (``obs/top.py``) and ``trace`` (``obs/reqtrace.py``'s
CLI and fixture selfcheck) on the CPU, held to the JAX package's: over the
committed ``tests/fixtures/obs/{fleet,serve_fleet}`` directories (read in
place) both packages collect the same state dicts and render the same
frames and waterfalls, and the selfchecks pass with the same output.  The
wall clock is pinned so heartbeat ages agree between the two reads.  Then
the CLI over a serve fleet's directory that the port wrote.
"""

import json
import os
import sys
import time

import pytest

from taboo_brittleness_tpu.obs import reqtrace as jreqtrace
from taboo_brittleness_tpu.obs import top as jtop
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch.obs import reqtrace, top
from taboo_brittleness_tpu_torch.runtime import supervise

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "obs")


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both packages' heartbeat readers compute ages from ``time.time()``:
    pin it so the two reads see one instant."""
    # tbx: wallclock-ok — the fixtures' heartbeats are epoch-stamped
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    return now


@pytest.mark.parametrize("fixture", ["fleet", "serve_fleet"])
def test_top_collect_and_render_equal_jax(pinned_clock, fixture):
    d = os.path.join(FIXTURES, fixture)
    state, want = top.collect(d), jtop.collect(d)
    assert state == want
    assert state["lanes"] and state["latest"] is not None
    frame = top.render(state)
    assert frame == jtop.render(want)
    assert frame.startswith("tbx top — ")
    if fixture == "serve_fleet":
        assert "serve-fleet:" in frame and "gateway:" in frame
        assert "tenant shed:" in frame


def test_top_render_of_an_empty_dir_equals_jax(tmp_path):
    state = top.collect(str(tmp_path))
    assert state == jtop.collect(str(tmp_path))
    frame = top.render(state)
    assert frame == jtop.render(state)
    assert "lanes: (no _progress*.json yet)" in frame


def test_top_selfcheck_equals_jax(pinned_clock, capsys):
    assert top.main_selfcheck() == 0
    got = capsys.readouterr().out
    assert jtop.main_selfcheck() == 0
    want = capsys.readouterr().out
    assert got == want
    assert got.rstrip().endswith("top selfcheck OK")


def test_top_run_once_prints_one_frame(pinned_clock, capsys):
    d = os.path.join(FIXTURES, "serve_fleet")
    assert top.run(d, once=True) == 0
    assert capsys.readouterr().out.strip() == top.render(top.collect(d))


@pytest.mark.parametrize("argv", [
    ["--slowest", "5"],
    ["--slowest", "2"],
    ["--request", "r001"],
    ["--request", "nope"],
], ids=["slowest-5", "slowest-2", "request", "missing-request"])
def test_trace_main_equals_jax(capsys, argv):
    d = os.path.join(FIXTURES, "serve_fleet")
    rc = reqtrace.main([d, *argv])
    got = capsys.readouterr()
    jrc = jreqtrace.main([d, *argv])
    want = capsys.readouterr()
    assert (rc, got.out, got.err) == (jrc, want.out, want.err)


def test_trace_by_trace_id_equals_jax(capsys):
    d = os.path.join(FIXTURES, "serve_fleet")
    traces = reqtrace.assemble(reqtrace.find_event_files(d))
    tid = sorted(traces)[0]
    assert reqtrace.main([d, "--trace", tid]) == 0
    got = capsys.readouterr().out
    assert jreqtrace.main([d, "--trace", tid]) == 0
    assert got == capsys.readouterr().out
    assert tid in got


def test_trace_selfcheck_equals_jax(capsys):
    assert reqtrace.default_fixture_dir() == jreqtrace.default_fixture_dir()
    assert reqtrace.selfcheck() == 0
    got = capsys.readouterr().out
    assert jreqtrace.selfcheck() == 0
    assert got == capsys.readouterr().out
    assert "tbx trace --selfcheck: OK" in got


def test_trace_missing_dir_exits_2(tmp_path, capsys):
    assert reqtrace.main([str(tmp_path)]) == 2
    assert "no _events" in capsys.readouterr().err


@pytest.mark.parametrize("argv,marker", [
    (["top", "--once", "--dir", os.path.join(FIXTURES, "fleet")], "lanes:"),
    (["top", "--selfcheck"], "top selfcheck OK"),
    (["trace", os.path.join(FIXTURES, "serve_fleet"), "--slowest", "3"],
     "attempt"),
    (["trace", "--selfcheck"], "--selfcheck: OK"),
], ids=["top-once", "top-selfcheck", "trace-slowest", "trace-selfcheck"])
def test_cli_top_and_trace(monkeypatch, capsys, argv, marker):
    monkeypatch.setattr(supervise, "install_drain_handlers", lambda: True)
    assert cli.main(argv) == 0
    assert marker in capsys.readouterr().out


def test_top_and_trace_over_a_port_serve_fleet_dir(tmp_path):
    """``top --once`` and ``trace --slowest 5`` as processes over a
    directory the port's ``serve-fleet`` wrote: exit 0, a frame with the
    replica lanes and the serve-fleet line, and the waterfalls."""
    import subprocess

    from taboo_brittleness_tpu_torch.serve.server import RequestSpool

    out = str(tmp_path / "fleet")
    spool = RequestSpool(out, fleet=True)
    for i in range(4):
        spool.put({"id": f"t{i}", "prompt": "Give me a hint",
                   "scenario": "chat", "seed": i})
    env = {k: v for k, v in os.environ.items()
           if k not in ("TABOO_FAULT_PLAN", "TBX_INCARNATION",
                        "TBX_WORKER_ID")}
    # The CPU run's SLO objectives (see tests/test_torch_replica.py).
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               TBX_OBS_PROGRESS_S="0.2", TBX_SUPERVISE_BACKOFF_S="0",
               TBX_SLO_LATENCY_S="600", TBX_SLO_TTFT_S="600",
               TBX_OBS_TS_S="600")
    pkg = [sys.executable, "-m", "taboo_brittleness_tpu_torch"]
    proc = subprocess.run(
        pkg + ["serve-fleet", "--synthetic", "--device", "cpu",
               "--output-dir", out, "--replicas", "2", "--slots", "2",
               "--max-new-tokens", "3", "--lease", "5", "--max-requests",
               "4", "--max-wall", "600"],
        env=env, capture_output=True, text=True, timeout=480)
    assert proc.returncode == 0, proc.stderr[-3000:]
    frame = subprocess.run(pkg + ["top", "--once", "--dir", out], env=env,
                           capture_output=True, text=True, timeout=240)
    assert frame.returncode == 0, frame.stderr
    assert "serve-fleet: done" in frame.stdout
    assert "w0" in frame.stdout and "w1" in frame.stdout
    trace = subprocess.run(pkg + ["trace", out, "--slowest", "5"], env=env,
                           capture_output=True, text=True, timeout=240)
    assert trace.returncode == 0, trace.stderr
    assert trace.stdout.count("attempt 0") >= 4
    with open(os.path.join(out, "_serve_fleet.json")) as f:
        assert json.load(f)["completed"] == 4
