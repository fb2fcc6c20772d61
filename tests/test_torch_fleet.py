"""The port's elastic fleet (``runtime/fleet.py``), the ledger's v3 worker
stamps (``runtime/resilience.py``), the per-worker ``obs`` files and the
fleet's CLI (``fleet``, ``worker``, ``grid``) — the cases of the JAX
package's ``tests/test_fleet.py`` on the port's modules, plus the spool
read across packages.

Layers:

- spool / lease / commit units (claim by rename, exclusion lists,
  first-writer-wins, renewal, the claim and renew fault sites);
- the ledger's v3 worker stamps and the v2 -> v3 normalization; the sweep
  observer's per-worker files, preemption-notice guard, drain marker and
  memory sampler; supervise in worker mode;
- the spool across packages: JAX's ``FleetSpool.put`` claimed by the port,
  the port's commit seen by JAX's ``done_uids``, and the reverse;
- fleets over stdlib-only fake workers (real subprocesses, supervision and
  leases): completion with a merged stream green under
  ``tools/trace_report.py --check`` (fleet invariants included), drain ->
  exit 75 -> resume, straggler speculation;
- the CLI on ``--device cpu`` with the tiny synthetic workers: ``fleet
  --synthetic`` with 2 workers, SIGTERM -> exit 75 -> relaunch, ``die`` at
  ``fleet.commit`` (exactly once, the re-issue in the ledger), and ``grid
  --selfcheck``.  Each subprocess case has a deadline of 120 s or more and
  asserts no timing.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from taboo_brittleness_tpu.runtime import fleet as jfleet
from taboo_brittleness_tpu_torch.runtime import fleet, resilience, supervise
from taboo_brittleness_tpu_torch.runtime.fleet import (
    FleetSpool, LeaseKeeper, holder_token, unit_id)
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FailureLedger, RetryPolicy)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "tools"))
import trace_report  # noqa: E402

FAST = RetryPolicy(max_retries=6, base_delay=0.0)
PROC_DEADLINE_S = 240


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    supervise.reset_drain()
    resilience.set_injector(resilience.FaultInjector())
    monkeypatch.delenv("TBX_WORKER_ID", raising=False)
    monkeypatch.delenv("TBX_INCARNATION", raising=False)
    yield
    supervise.reset_drain()
    resilience.set_injector(resilience.FaultInjector())


def _spool(tmp_path) -> FleetSpool:
    return FleetSpool(str(tmp_path / "spool")).ensure()


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Spool: claim by rename, exclusion, first-writer-wins, leases.
# ---------------------------------------------------------------------------

def test_unit_id_is_filesystem_safe_and_equals_jax():
    assert unit_id("ship", {"layer": 31}) == "ship@L31"
    assert "/" not in unit_id("a/b c", {"key": "16k/L9"})
    assert unit_id("ship", {}) == "ship@r0"
    for word, readout in (("ship", {"layer": 31}), ("a/b c", {"key": "16k/L9"}),
                          ("moon", {"key": "L9-W16k", "layer": 9})):
        assert unit_id(word, readout) == jfleet.unit_id(word, readout)
    assert holder_token("w3", 2) == "w3-i2" == jfleet.holder_token("w3", 2)


def test_claim_respects_exclusion_and_order(tmp_path):
    sp = _spool(tmp_path)
    sp.put("u0", {"word": "a"}, attempt=1, excluded=["w1-i0"])
    sp.put("u1", {"word": "b"})
    assert sp.claim("w1-i0", "w1")["uid"] == "u1"   # u0 excludes this holder
    rec2 = sp.claim("w2-i0", "w2")
    assert rec2["uid"] == "u0" and rec2["attempt"] == 1
    assert sp.claim("w2-i0", "w2") is None
    assert {c["holder"] for c in sp.claimed_entries()} == {"w1-i0", "w2-i0"}


def test_claim_garbage_collects_resolved_units(tmp_path):
    sp = _spool(tmp_path)
    sp.put("u0", {"word": "a"})
    assert sp.commit("u0", {"result": 1}, holder="w0-i0")
    sp.put("u0", {"word": "a"}, attempt=1)     # a stale re-issue
    assert sp.claim("w1-i0", "w1") is None     # skipped and removed
    assert sp.pending() == []


def test_claim_fault_site_fires(tmp_path):
    sp = _spool(tmp_path)
    sp.put("u0", {"word": "a"})
    inj = resilience.FaultInjector()
    inj.arm("fleet.claim", mode="fail", times=1)
    resilience.set_injector(inj)
    with pytest.raises(resilience.InjectedFault):
        sp.claim("w0-i0", "w0")
    assert sp.claim("w0-i0", "w0")["uid"] == "u0"


def test_commit_first_writer_wins(tmp_path):
    sp = _spool(tmp_path)
    assert sp.commit("u0", {"result": "first"}, holder="w0-i0") is True
    assert sp.commit("u0", {"result": "second"}, holder="w1-i0") is False
    with open(sp.done_path("u0")) as f:
        assert json.load(f)["result"] == "first"
    assert sp.duplicate_count() == 1
    assert sp.done_uids() == ["u0"]


def test_lease_keeper_renews_and_preserves_claim_time(tmp_path):
    sp = _spool(tmp_path)
    keeper = LeaseKeeper(sp, "u0", 0, "w0-i0", "w0", lease_s=0.3).start()
    try:
        first = sp.leases()[0]
        time.sleep(0.35)
        renewed = sp.leases()[0]
    finally:
        keeper.stop()
    assert renewed["renewed_at"] > first["renewed_at"]
    assert renewed["claimed_at"] == first["claimed_at"]
    assert renewed["expires_at"] > first["expires_at"]
    assert sp.leases() == []


def test_lease_renew_fault_lets_lease_expire(tmp_path):
    sp = _spool(tmp_path)
    inj = resilience.FaultInjector()
    inj.arm("fleet.lease_renew", mode="fail", times=None)
    resilience.set_injector(inj)
    keeper = LeaseKeeper(sp, "u0", 0, "w0-i0", "w0", lease_s=0.3).start()
    try:
        first = sp.leases()[0]
        time.sleep(0.45)
        stale = sp.leases()[0]
    finally:
        keeper.stop()
    assert stale["expires_at"] == first["expires_at"]


def test_percentile():
    assert fleet._percentile([], 75) == 0.0
    assert fleet._percentile([1.0], 75) == 1.0
    assert fleet._percentile([1, 2, 3, 4], 75) == 3


# ---------------------------------------------------------------------------
# The spool across packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spool_reads_across_packages(tmp_path, writer):
    root = str(tmp_path / "spool")
    put_side = (jfleet if writer == "jax" else fleet).FleetSpool(root).ensure()
    take_side = (fleet if writer == "jax" else jfleet).FleetSpool(root).ensure()
    put_side.write_config({"mode": "synthetic", "words": ["ship"]})
    put_side.put("ship@L1", {"word": "ship", "readout": {"layer": 1}},
                 attempt=2, excluded=["w9-i0"])
    assert take_side.read_config()["words"] == ["ship"]
    assert take_side.claim("w9-i0", "w9") is None      # excluded holder
    rec = take_side.claim("w0-i0", "w0")
    assert rec["uid"] == "ship@L1" and rec["attempt"] == 2
    assert rec["unit"]["readout"] == {"layer": 1}
    take_side.write_lease("ship@L1", 2, "w0-i0", "w0", 5.0)
    assert [(r["uid"], r["holder"]) for r in put_side.leases()] == [
        ("ship@L1", "w0-i0")]
    assert put_side.claimed_entries()[0]["holder"] == "w0-i0"
    assert take_side.commit("ship@L1", {"uid": "ship@L1", "result": {"x": 1}},
                            holder="w0-i0")
    take_side.release("ship@L1", 2, "w0-i0")
    assert put_side.done_uids() == ["ship@L1"]
    assert put_side.is_resolved("ship@L1")
    assert not put_side.commit("ship@L1", {"uid": "ship@L1"}, holder="w1-i0")
    assert take_side.duplicate_count() == 1
    put_side.quarantine_unit("moon@L1", 0, worker="w1", error="boom")
    assert take_side.quarantined_uids() == ["moon@L1"]
    put_side.write_stop()
    assert take_side.stopped()


# ---------------------------------------------------------------------------
# The ledger's v3 worker stamps and the v2 -> v3 normalization.
# ---------------------------------------------------------------------------

def test_ledger_v3_stamps_worker(tmp_path):
    path = str(tmp_path / "_failures.json")
    led = FailureLedger(path=path, worker="w7")
    led.record_retry("ship", "decode", OSError("x"), 1)
    led.record_quarantine("moon", "decode", OSError("y"), 3)
    with open(path) as f:
        data = json.load(f)
    assert data["version"] == 3 and data["worker"] == "w7"
    assert data["retried"]["ship"]["worker"] == "w7"
    assert data["quarantined"]["moon"]["worker"] == "w7"


def test_ledger_without_worker_emits_no_worker_keys(tmp_path):
    path = str(tmp_path / "_failures.json")
    led = FailureLedger(path=path)
    led.record_retry("ship", "decode", OSError("x"), 1)
    with open(path) as f:
        data = json.load(f)
    assert "worker" not in data
    assert data["retried"]["ship"] == {"attempts": 1, "incarnation": 0}


def test_ledger_stamps_incarnation_and_keeps_prior_retries(tmp_path,
                                                           monkeypatch):
    path = str(tmp_path / "_failures.json")
    FailureLedger(path=path).record_retry("ship", "decode", OSError("x"), 1)
    monkeypatch.setenv("TBX_INCARNATION", "2")
    led = FailureLedger(path=path)
    assert led.incarnation == 2
    assert led.retried == {"ship": {"attempts": 1, "incarnation": 0}}
    led.record_retry("moon", "decode", OSError("y"), 2)
    assert led.to_dict()["retried"]["moon"] == {"attempts": 2,
                                                "incarnation": 2}
    monkeypatch.setenv("TBX_INCARNATION", "0")
    assert FailureLedger(path=path).retried == {}   # a fresh run resets


def test_ledger_v2_to_v3_normalization(tmp_path):
    path = str(tmp_path / "_failures.json")
    with open(path, "w") as f:
        json.dump({"version": 2, "incarnation": 0,
                   "retried": {"ship": {"attempts": 2, "incarnation": 0}},
                   "quarantined": {}}, f)
    led = FailureLedger(path=path, incarnation=1, worker="w1")
    assert led.retried == {"ship": {"attempts": 2, "incarnation": 0}}
    led.record_retry("moon", "decode", OSError("x"), 1)
    assert led.retried["moon"]["worker"] == "w1"
    with open(path, "w") as f:
        json.dump({"version": 3, "incarnation": 0, "worker": "w0",
                   "retried": {"ship": {"attempts": 2, "incarnation": 0},
                               "old": 3},
                   "quarantined": {}}, f)
    led2 = FailureLedger(path=path, incarnation=1, worker="w1")
    assert led2.retried["ship"]["worker"] == "w0"
    assert led2.retried["old"] == {"attempts": 3, "incarnation": 0,
                                   "worker": "w0"}


def test_port_ledger_is_jax_ledger(tmp_path):
    """A ledger the port writes loads in JAX's ledger with the same blocks,
    and the reverse (the v3 file schema is shared)."""
    from taboo_brittleness_tpu.runtime.resilience import (
        FailureLedger as JFailureLedger)

    path = str(tmp_path / "_failures.json")
    led = FailureLedger(path=path, incarnation=1, worker="w2")
    led.record_retry("ship", "compute", OSError("x"), 1)
    led.record_quarantine("moon", "compute", ValueError("y"), 3)
    back = JFailureLedger(path=path, incarnation=1, worker="w2")
    assert back.retried == led.retried
    assert set(back.quarantined) == {"moon"}
    back.record_retry("bark", "compute", OSError("z"), 2)
    again = FailureLedger(path=path, incarnation=1, worker="w2")
    assert again.retried["bark"] == {"attempts": 2, "incarnation": 1,
                                     "worker": "w2"}


# ---------------------------------------------------------------------------
# Per-worker telemetry, the preemption-notice guard, the drain marker.
# ---------------------------------------------------------------------------

def test_sweep_observer_uses_worker_suffixed_files(tmp_path, monkeypatch):
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs import flightrec, reqtrace

    monkeypatch.setenv("TBX_WORKER_ID", "alpha")
    out = str(tmp_path)
    with obs.sweep_observer(out, pipeline="fleet-worker", words=["u0"]) as ob:
        with ob.word("u0"):
            pass
        assert flightrec.recorder().path == os.path.join(
            out, "_flightrec.alpha.json")
    for name in ("_events.alpha.jsonl", "_progress.alpha.json",
                 "_metrics.alpha.jsonl"):
        assert os.path.exists(os.path.join(out, name)), name
    assert not os.path.exists(os.path.join(out, "_events.jsonl"))
    events = _events(os.path.join(out, "_events.alpha.jsonl"))
    assert all(e.get("worker") == "alpha" for e in events)
    run_starts = [e for e in events
                  if e.get("ev") == "start" and e.get("kind") == "run"]
    assert run_starts[0]["attrs"]["worker"] == "alpha"
    with open(os.path.join(out, "_progress.alpha.json")) as f:
        assert json.load(f)["worker"] == "alpha"
    # reqtrace reads the per-worker streams when no merged file exists.
    assert reqtrace.find_event_files(out) == [
        os.path.join(out, "_events.alpha.jsonl")]
    flightrec.configure(None)


def test_preempt_notice_guard_gauge_warn_and_manifest(tmp_path, monkeypatch):
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
    from taboo_brittleness_tpu_torch.runtime.manifest import RunManifest

    obs_metrics.reset()
    monkeypatch.setenv("TBX_PREEMPT_NOTICE_S", "0.05")
    out = str(tmp_path)
    with obs.sweep_observer(out, pipeline="test", words=["slow"]) as ob:
        with ob.word("slow"):
            time.sleep(0.12)
    assert ob.preempt_margin_s is not None and ob.preempt_margin_s < 0
    snap = obs_metrics.snapshot()
    assert snap["gauges"]["sweep.preempt_margin_s"] == ob.preempt_margin_s
    events = _events(os.path.join(out, "_events.jsonl"))
    warns = [e for e in events
             if e.get("name") == "sweep.preempt_notice_exceeded"]
    assert warns and warns[0]["attrs"]["word"] == "slow"
    assert RunManifest(command="t").to_dict()["preempt_margin_s"] == \
        ob.preempt_margin_s
    obs_metrics.reset()


def test_preempt_margin_positive_within_notice(tmp_path, monkeypatch):
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.reset()
    monkeypatch.setenv("TBX_PREEMPT_NOTICE_S", "30")
    with obs.sweep_observer(str(tmp_path), pipeline="test",
                            words=["fast"]) as ob:
        with ob.word("fast"):
            pass
    assert ob.preempt_margin_s is not None and ob.preempt_margin_s > 0
    events = _events(os.path.join(str(tmp_path), "_events.jsonl"))
    assert not any(e.get("name") == "sweep.preempt_notice_exceeded"
                   for e in events)
    obs_metrics.reset()


def test_mark_drained_and_memory_sampler(tmp_path, monkeypatch):
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs.progress import read_progress

    monkeypatch.setenv("TBX_OBS_MEM_HZ", "50")
    out = str(tmp_path)
    with obs.sweep_observer(out, pipeline="test", words=["a", "b"]) as ob:
        with ob.word("a"):
            time.sleep(0.15)
        ob.mark_drained()
    assert read_progress(os.path.join(out, "_progress.json"))["status"] == \
        "preempted"
    events = _events(os.path.join(out, "_events.jsonl"))
    names = [e.get("name") for e in events]
    assert "sweep.drained" in names and "mem.sample" in names
    run_end = [e for e in events if e.get("ev") == "end"
               and e.get("kind") == "run"][0]
    assert run_end["attrs"]["drained"] is True
    assert trace_report.check(os.path.join(out, "_events.jsonl")) == []


_WORKER_FAKE_CHILD = r"""
import json, os, sys, time

out = sys.argv[1]
wid = os.environ["TBX_WORKER_ID"]
tmp = os.path.join(out, "tmp")
with open(tmp, "w") as f:
    json.dump({"v": 1, "pid": os.getpid(), "updated_at": time.time(),
               "heartbeat_seconds": 0.05, "status": "done",
               "worker": wid,
               "incarnation": int(os.environ.get("TBX_INCARNATION", "0"))},
              f)
os.replace(tmp, os.path.join(out, f"_progress.{wid}.json"))
sys.exit(0)
"""


def test_supervise_worker_mode_uses_per_worker_files(tmp_path):
    out = str(tmp_path / "out")
    os.makedirs(out)
    child = str(tmp_path / "child.py")
    with open(child, "w") as f:
        f.write(_WORKER_FAKE_CHILD)
    res = supervise.supervise(
        [sys.executable, child, out], out, worker_id="wk",
        max_incarnations=2, poll_interval=0.02, grace=0.5,
        wedge_after=1.0, policy=FAST)
    assert res.ok
    assert os.path.exists(os.path.join(out, "_supervise.wk.json"))
    assert not os.path.exists(os.path.join(out, "_supervise.json"))
    launches = [e for e in _events(os.path.join(out, "_events.wk.jsonl"))
                if e.get("name") == "supervise.launch"]
    assert launches and launches[0]["attrs"]["worker"] == "wk"
    assert not os.path.exists(os.path.join(out, "_events.jsonl"))


# ---------------------------------------------------------------------------
# Fleets over stdlib-only fake workers (real processes, supervision, leases).
# ---------------------------------------------------------------------------

_FAKE_WORKER = r"""
import sys, time
sys.path.insert(0, {repo!r})
from taboo_brittleness_tpu_torch.runtime import fleet, supervise

supervise.install_drain_handlers()


def unit_fn(unit):
    time.sleep(float(unit.get("sleep", 0.05)))
    return {{"word": unit.get("word"), "ok": True}}


res = fleet.run_worker(sys.argv[1], sys.argv[2], unit_fn=unit_fn,
                       lease_s=float(sys.argv[3]), poll_s=0.05)
sys.exit(res.exit_code)
"""


def _fake_worker_argv(tmp_path, out, lease="2.0"):
    path = str(tmp_path / "fake_worker.py")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(_FAKE_WORKER.format(repo=REPO))
    return lambda wid: [sys.executable, path, out, wid, lease]


def _units(n, sleep=0.05):
    return [{"uid": f"u{i:02d}", "word": f"u{i:02d}", "sleep": sleep,
             "readout": {"layer": 1}} for i in range(n)]


def _fake_env(extra=None):
    env = {"TBX_OBS_PROGRESS_S": "0.1", "TBX_SUPERVISE_BACKOFF_S": "0"}
    env.update(extra or {})
    return env


def _check_merged(out):
    merged = os.path.join(out, "_events.jsonl")
    events = list(trace_report.iter_events(merged))
    assert trace_report.check(merged) == []
    assert trace_report.check_fleet(merged, events) == []
    assert trace_report.check_grid(merged, events) == []
    return events


def test_fleet_completes_and_merges(tmp_path):
    out = str(tmp_path / "fleet")
    res = fleet.run_fleet(
        _units(6), out, n_workers=2,
        worker_argv=_fake_worker_argv(tmp_path, out),
        worker_env=_fake_env(), lease_s=2.0, poll_s=0.1,
        supervise_poll=0.1, grace=1.0, wedge_after=30.0,
        max_incarnations=3, policy=FAST, spec_factor=0.0, max_wall_s=120.0)
    assert res.status == "done" and res.exit_code == 0
    assert res.committed == 6 and res.quarantined == 0
    sp = FleetSpool(os.path.join(out, "spool"))
    assert sorted(sp.done_uids()) == [f"u{i:02d}" for i in range(6)]
    events = _check_merged(out)
    assert {e.get("worker") for e in events
            if e.get("name") == "fleet.commit"} <= {"w0", "w1"}
    assert os.path.exists(os.path.join(out, "_fleet.json"))
    with open(os.path.join(out, "_failures.json")) as f:
        assert json.load(f)["fleet"]["status"] == "done"


def test_fleet_drain_exits_75_and_resumes(tmp_path):
    out = str(tmp_path / "fleet")
    argv = _fake_worker_argv(tmp_path, out)
    units = _units(8, sleep=0.4)
    timer = threading.Timer(1.2, supervise.request_drain)
    timer.start()
    try:
        res = fleet.run_fleet(
            units, out, n_workers=2, worker_argv=argv,
            worker_env=_fake_env(), lease_s=2.0, poll_s=0.1,
            supervise_poll=0.1, grace=2.0, wedge_after=30.0,
            max_incarnations=3, policy=FAST, spec_factor=0.0,
            max_wall_s=120.0)
    finally:
        timer.cancel()
        supervise.reset_drain()
    assert res.status == "drained" and res.exit_code == supervise.EXIT_DRAINED
    sp = FleetSpool(os.path.join(out, "spool"))
    assert 0 < len(sp.done_uids()) < 8
    res2 = fleet.run_fleet(
        units, out, n_workers=2, worker_argv=argv,
        worker_env=_fake_env(), lease_s=2.0, poll_s=0.1,
        supervise_poll=0.1, grace=1.0, wedge_after=30.0,
        max_incarnations=3, policy=FAST, spec_factor=0.0, max_wall_s=120.0)
    assert res2.status == "done" and res2.exit_code == 0
    assert sorted(sp.done_uids()) == [f"u{i:02d}" for i in range(8)]


def test_fleet_speculation_rescues_straggler(tmp_path, monkeypatch):
    """One unit sleeps 8 s; the percentile deadline trips, a speculative
    copy goes to the other worker and commits first; the straggler's own
    commit, if it lands, parks in duplicates/."""
    monkeypatch.setenv("TBX_FLEET_SPEC_MIN_S", "1")
    out = str(tmp_path / "fleet")
    units = _units(7, sleep=0.05)
    units[3]["sleep"] = 8.0
    res = fleet.run_fleet(
        units, out, n_workers=2,
        worker_argv=_fake_worker_argv(tmp_path, out, lease="1.0"),
        worker_env=_fake_env(), lease_s=1.0, poll_s=0.1,
        supervise_poll=0.1, grace=1.0, wedge_after=60.0,
        max_incarnations=3, policy=FAST,
        spec_factor=2.0, spec_pct=75.0, max_wall_s=120.0)
    assert res.status == "done" and res.exit_code == 0
    assert res.committed == 7 and res.speculated >= 1
    sp = FleetSpool(os.path.join(out, "spool"))
    assert sorted(sp.done_uids()) == [f"u{i:02d}" for i in range(7)]
    with open(sp.done_path("u03")) as f:
        assert json.load(f)["uid"] == "u03"


# ---------------------------------------------------------------------------
# The CLI on --device cpu (tiny synthetic workers).
# ---------------------------------------------------------------------------

def _cli_env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TABOO_FAULT_PLAN", "TBX_INCARNATION", "TBX_WORKER_ID",
                        "TBX_AOT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # The workers decode a tiny model: one torch thread each.
    env.update({"TBX_OBS_PROGRESS_S": "0.2", "TBX_SUPERVISE_BACKOFF_S": "0",
                "OMP_NUM_THREADS": "1"})
    env.update(extra or {})
    return env


def _cli(args, cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch", *args],
        cwd=cwd, env=env or _cli_env(), capture_output=True, text=True,
        timeout=PROC_DEADLINE_S)


def _fleet_args(out, words, extra=()):
    return ["fleet", "--synthetic", "--device", "cpu", "--output-dir", out,
            "--words", *words, "--workers", "2", "--max-new-tokens", "3",
            "--readout-layers", "1,2", "--lease", "3", "--grace", "2",
            "--max-incarnations", "4", "--max-wall", "200", *extra]


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_cli_fleet_synthetic_two_workers_completes_and_merges(tmp_path):
    out = str(tmp_path / "fleet")
    words = ["ship", "moon", "bark"]
    proc = _cli(_fleet_args(out, words), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = _last_json(proc.stdout)
    assert summary["status"] == "done" and summary["committed"] == 6
    sp = FleetSpool(os.path.join(out, "spool"))
    assert sorted(sp.done_uids()) == sorted(
        unit_id(w, {"layer": la}) for w in words for la in (1, 2))
    with open(sp.done_path("ship@L2")) as f:
        rec = json.load(f)
    assert rec["result"]["readout_layer"] == 2
    assert rec["worker"] in ("w0", "w1")
    _check_merged(out)
    with open(os.path.join(out, "run_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["command"] == "fleet"
    assert manifest["environment"]["backend"] == "cpu"
    assert manifest["extra"]["fleet"]["committed"] == 6


def test_cli_fleet_sigterm_drains_75_and_resumes(tmp_path):
    out = str(tmp_path / "fleet")
    words = [f"w{i:02d}" for i in range(8)]
    # A slow commit keeps units in flight while the drain lands.
    plan = {"fleet.commit": [{"mode": "delay", "delay": 0.5, "times": None}]}
    env = _cli_env({"TABOO_FAULT_PLAN": json.dumps(plan)})
    proc = subprocess.Popen(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch",
         *_fleet_args(out, words)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    sp = FleetSpool(os.path.join(out, "spool"))
    try:
        deadline = time.monotonic() + PROC_DEADLINE_S
        while time.monotonic() < deadline and proc.poll() is None:
            if sp.done_uids():
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=PROC_DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == supervise.EXIT_DRAINED, stderr[-3000:]
    assert _last_json(stdout)["status"] == "drained"
    n_done = len(sp.done_uids())
    assert 0 < n_done < 16
    again = _cli(_fleet_args(out, words), cwd=str(tmp_path))
    assert again.returncode == 0, again.stderr[-3000:]
    assert len(sp.done_uids()) == 16
    _check_merged(out)


def test_cli_fleet_die_at_commit_commits_each_unit_once(tmp_path):
    out = str(tmp_path / "fleet")
    words = [f"word{i:02d}" for i in range(4)]
    # w0 commits slowly, so w1 (however late it starts) claims units too;
    # speculation is off, so only the lease expiry can re-issue w1's unit.
    plan = {"fleet.commit": [
        {"mode": "die", "times": 1, "match": "w1", "incarnation": 0},
        {"mode": "delay", "delay": 1.0, "times": None, "match": "w0-i"}]}
    proc = _cli(_fleet_args(out, words),
                cwd=str(tmp_path),
                env=_cli_env({"TABOO_FAULT_PLAN": json.dumps(plan),
                              "TBX_FLEET_SPEC_FACTOR": "0"}))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = _last_json(proc.stdout)
    assert summary["committed"] == 8 and summary["quarantined"] == 0
    assert summary["lease_expiries"] >= 1 and summary["reissued"] >= 1
    sp = FleetSpool(os.path.join(out, "spool"))
    assert sorted(sp.done_uids()) == sorted(
        unit_id(w, {"layer": la}) for w in words for la in (1, 2))
    incs = {w["worker_id"]: w["incarnations"] for w in summary["workers"]}
    assert incs["w1"] >= 2, incs
    with open(os.path.join(out, "_failures.json")) as f:
        ledger = json.load(f)
    assert ledger["version"] == 3
    chains = ledger["fleet"]["reissues"]
    assert any(e["worker"] == "w1" for c in chains.values() for e in c), chains
    for chain in chains.values():
        for entry in chain:
            assert entry["reason"] == "lease-expired"
            assert entry["to_attempt"] == entry["from_attempt"] + 1
    corrupt = [n for _, _, names in os.walk(out) for n in names
               if n.endswith(".corrupt")]
    assert corrupt == []
    _check_merged(out)


@pytest.fixture(scope="module")
def grid_selfcheck_run(tmp_path_factory):
    """One ``grid --selfcheck --device cpu`` process (2 worker processes,
    one transient grid.cell fault), its temporary grid directory put under
    a directory of the test's through TMPDIR."""
    tmp = tmp_path_factory.mktemp("grid-selfcheck")
    proc = _cli(["grid", "--selfcheck", "--device", "cpu"], cwd=str(tmp),
                env=_cli_env({"TMPDIR": str(tmp)}))
    dirs = [os.path.join(str(tmp), n) for n in os.listdir(str(tmp))
            if n.startswith("tbx_grid_selfcheck_")]
    return proc, dirs


def test_cli_grid_selfcheck(grid_selfcheck_run):
    proc, dirs = grid_selfcheck_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    verdict = _last_json(proc.stdout)
    assert verdict["selfcheck"] == "ok" and verdict["complete"] is True
    assert verdict["faulted"] in verdict["retried"]
    assert verdict["committed"] == 8 and len(dirs) == 1


def test_grid_fleet_merged_events_pass_trace_report(grid_selfcheck_run):
    """The grid selfcheck's merged stream is green under --check, grid
    exactly-once included, and the report renders its cell lanes."""
    proc, dirs = grid_selfcheck_run
    assert proc.returncode == 0 and len(dirs) == 1, proc.stderr[-3000:]
    out = dirs[0]
    events = _check_merged(out)
    rendered = trace_report.report(events)
    assert "grid:" in rendered and "L2-W64" in rendered
    cli = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", os.path.join(out, "_events.jsonl")],
        capture_output=True, text=True, timeout=PROC_DEADLINE_S)
    assert cli.returncode == 0, cli.stdout + cli.stderr
