"""The port's replica fleet (``serve/replica.py``, the fleet half of
``serve/server.py``, ``serve-fleet`` and ``serve --replica``) on the CPU:
the cases of the JAX package's ``tests/test_serve_fleet.py`` (but its
``bench_compare`` gates, which the port lacks) on the port's modules, and
the port held to the JAX package.

- The burn router: the same heartbeats give the same view and the same
  seed the same picks in both packages; weighted steering, the typed
  all-burning shed, waiting while no replica is live, occupancy scaling,
  a dead replica's backlog moved.
- The fleet spool across packages, both ways: one package's ``assign``
  claimed by the other's ``claim_assigned``, lease files read by either,
  first-writer-wins across packages.
- The fault sites ``serve.claim`` / ``serve.lease_renew`` /
  ``serve.respond``, the claimed-file GC and the mid-run audit warning.
- ``serve_forever(replica=True)`` over a tiny ``gemma2_tiny`` engine with
  JAX's weights carried across answers the same assigned requests as JAX's
  replica: equal tokens, lens probabilities within 1e-5 (LENS_ATOL).
- The chaos end-to-end: 3 ``serve --replica`` processes, w1 killed by a
  ``die`` mid-decode and w2 wedged past the supervisor's threshold; every
  request answered exactly once, the re-spool chains in the ledger, the
  merged events green under ``tools/trace_report.py --check``; the CLI's
  ``serve-fleet`` SIGTERMed exits 75 and a rerun finishes ``done``.
  Deadlines are 120 s or more and nothing is timed.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.obs import metrics as jmetrics
from taboo_brittleness_tpu.obs import progress as jprogress
from taboo_brittleness_tpu.obs import reqtrace as jreqtrace
from taboo_brittleness_tpu.runtime import fleet as jfleet
from taboo_brittleness_tpu.runtime import resilience as jresilience
from taboo_brittleness_tpu.serve import loadgen as jloadgen
from taboo_brittleness_tpu.serve import replica as jreplica
from taboo_brittleness_tpu.serve import server as jserver
from taboo_brittleness_tpu.serve.scheduler import Response as JResponse
from taboo_brittleness_tpu.serve.scheduler import SlotScheduler as JSlotScheduler
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import reqtrace
from taboo_brittleness_tpu_torch.obs import trace as trace_mod
from taboo_brittleness_tpu_torch.obs.progress import read_progress
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.runtime import aot, resilience, supervise
from taboo_brittleness_tpu_torch.runtime.fleet import holder_token
from taboo_brittleness_tpu_torch.runtime.resilience import (
    InjectedFault,
    RetryPolicy,
)
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer
from taboo_brittleness_tpu_torch.serve import loadgen, replica
from taboo_brittleness_tpu_torch.serve.engine import ServeEngine
from taboo_brittleness_tpu_torch.serve.replica import (
    BurnRouter,
    FleetCoordinator,
    ServeFleetResult,
    _shed,
    reroute_orphans,
    run_serve_fleet,
)
from taboo_brittleness_tpu_torch.serve.scheduler import (
    REJECT_ALL_REPLICAS_BURNING,
    REJECT_FLEET_SATURATED,
    Response,
    SlotScheduler,
    default_scenarios,
)
from taboo_brittleness_tpu_torch.serve.server import (
    CLAIMED_SUFFIX,
    RequestSpool,
    ServeLeaseKeeper,
    serve_forever,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "tools"))
import trace_report  # noqa: E402

LENS_ATOL = 1e-5
MIX = ("chat", "sae_ablate", "forcing")
PARITY_MIX = ("chat", "sae_ablate", "forcing", "chat_lens", "projection")
PROC_DEADLINE_S = 240
# The SLO objectives of a CPU test run: the shipped ones (2.5 s latency,
# 1 s TTFT, 10 s windows) are an H100's, and a loaded test host misses them,
# so a replica's heartbeat burns and the gateway / router shed by contract.
# A window closing mid-load also reads in-flight requests as lost goodput
# (ROADMAP Queue 3), so no window closes inside a test.
CPU_SLO_ENV = {"TBX_SLO_LATENCY_S": "600", "TBX_SLO_TTFT_S": "600",
               "TBX_OBS_TS_S": "600"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model serving steps are thousands of small ops: this module
    steps on one intra-op thread (the test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    supervise.reset_drain()
    resilience.set_injector(resilience.FaultInjector())
    jresilience.set_injector(jresilience.FaultInjector())
    for k in ("TBX_WORKER_ID", "TABOO_FAULT_PLAN", "TBX_INCARNATION"):
        monkeypatch.delenv(k, raising=False)
    yield
    supervise.reset_drain()
    resilience.set_injector(resilience.FaultInjector())
    jresilience.set_injector(jresilience.FaultInjector())
    # In-process servers leave request-trace exemplars and metrics in both
    # packages' module state; later tests in this process must not see them.
    for mod in (reqtrace, jreqtrace):
        mod.reset_exemplars()
    obs_metrics.reset()
    jmetrics.reset()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TABOO_FAULT_PLAN", "TBX_INCARNATION",
                        "TBX_WORKER_ID")}
    env["PYTHONPATH"] = REPO
    env["TBX_OBS_PROGRESS_S"] = "0.2"
    env["TBX_SUPERVISE_BACKOFF_S"] = "0"
    env["OMP_NUM_THREADS"] = "1"
    env.update(CPU_SLO_ENV)
    env.update(extra)
    return env


def _heartbeat(out, wid, *, status="running", age=0.0, fast=0.0,
               in_flight=0, slots=None, queued=0):
    """Fabricate the ``_progress.<wid>.json`` contract the router reads."""
    serving = {"in_flight": in_flight, "completed_requests": 0,
               "queued": queued}
    if slots is not None:
        serving["slots"] = slots
    payload = {
        "v": 1, "worker": wid, "status": status,
        # tbx: wallclock-ok — the heartbeat contract is epoch-stamped
        "updated_at": time.time() - age,
        "heartbeat_seconds": 5.0, "workload": "serve",
        "serving": serving,
        "slo": {"serve_latency.chat":
                {"burn": fast, "fast": fast, "slow": fast,
                 "ok": fast < 1.0}},
    }
    path = os.path.join(out, f"_progress.{wid}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def _no_corrupt(root):
    return glob.glob(os.path.join(root, "**", "*.corrupt"), recursive=True)


def _strip_age(view):
    return {w: {k: v for k, v in cell.items() if k != "heartbeat_age"}
            for w, cell in view.items()}


# ---------------------------------------------------------------------------
# The burn router, against JAX's.
# ---------------------------------------------------------------------------

HEARTBEAT_CASES = {
    "healthy-and-burning": {"w0": dict(fast=0.0), "w1": dict(fast=1.5),
                            "w2": dict(fast=0.4)},
    "occupancy": {"w0": dict(fast=0.0, slots={"width": 8, "free": 2},
                             queued=1),
                  "w1": dict(fast=0.5, slots={"width": 4, "free": 4}),
                  "w2": dict(fast=0.0, slots={"width": 4, "free": 0},
                             queued=3)},
    "stale-and-done": {"w0": dict(age=60.0), "w1": dict(status="done"),
                       "w2": dict(fast=0.2)},
}


@pytest.mark.parametrize("case", sorted(HEARTBEAT_CASES))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_router_view_and_picks_equal_jax(tmp_path, case, seed):
    out = str(tmp_path)
    for wid, kw in HEARTBEAT_CASES[case].items():
        _heartbeat(out, wid, **kw)
    wids = sorted(HEARTBEAT_CASES[case])
    port = BurnRouter(out, wids, burn_cap=2.0, seed=seed)
    ref = jreplica.BurnRouter(out, wids, burn_cap=2.0, seed=seed)
    view, jview = port.view(), ref.view()
    assert _strip_age(view) == _strip_age(jview)
    assert BurnRouter.all_saturated(view) == \
        jreplica.BurnRouter.all_saturated(jview)
    picks = [port.pick(view, exclude=("w2",) if i % 5 == 4 else ())
             for i in range(60)]
    jpicks = [ref.pick(jview, exclude=("w2",) if i % 5 == 4 else ())
              for i in range(60)]
    assert picks == jpicks
    assert port.routed == ref.routed


def test_router_burn_weighted_steering(tmp_path):
    """At fast 1.5 under cap 2.0 a replica weighs 0.25 against a healthy
    one's 1.0: over 400 seeded picks it gets well under half the healthy
    share, but not nothing."""
    out = str(tmp_path)
    _heartbeat(out, "w0", fast=0.0)
    _heartbeat(out, "w1", fast=1.5)
    router = BurnRouter(out, ["w0", "w1"], burn_cap=2.0, seed=1)
    view = router.view()
    assert view["w0"]["weight"] == 1.0
    assert view["w1"]["weight"] == 0.25
    assert not view["w1"]["burning"]
    for _ in range(400):
        assert router.pick(view) in ("w0", "w1")
    assert router.routed["w1"] < 0.5 * router.routed["w0"], router.routed
    assert router.routed["w1"] > 0, "burning-but-under-cap must not starve"


@pytest.mark.parametrize("fasts,reason", [
    ((2.5, 3.0), REJECT_ALL_REPLICAS_BURNING),
    (None, REJECT_FLEET_SATURATED)], ids=["burning", "saturated"])
def test_router_sheds_typed(tmp_path, fasts, reason):
    """Every live replica past the cap (or full with a backlog): no pick,
    and the coordinator's round sheds intake with the typed rejection."""
    out = str(tmp_path)
    for i, wid in enumerate(("w0", "w1")):
        if fasts is not None:
            _heartbeat(out, wid, fast=fasts[i])
        else:
            _heartbeat(out, wid, slots={"width": 4, "free": 0}, queued=2)
    router = BurnRouter(out, ["w0", "w1"], burn_cap=2.0, seed=0)
    view = router.view()
    assert BurnRouter.any_alive(view)
    assert router.pick(view) is None or fasts is None
    spool = RequestSpool(out, fleet=True)
    rid = spool.put({"id": "shed0", "prompt": "p", "scenario": "chat"})
    if fasts is not None:
        assert BurnRouter.all_burning(view)
        _shed(spool, rid, spool.route_intake(rid))
    else:
        assert BurnRouter.all_saturated(view)
        coord = FleetCoordinator(spool, router, lease_s=5.0)
        coord.round(view)
        assert coord.shed == 1 and router.sheds == 1
    resp = spool.get_response(rid)
    assert resp is not None and resp["ok"] is False
    assert resp["reject_reason"] == reason
    assert resp["finish"] == "rejected"


def test_router_waits_when_no_replica_alive(tmp_path):
    """Stale or absent heartbeats mean startup or a rolling restart, not
    overload: nothing is alive, nothing burns, intake waits."""
    out = str(tmp_path)
    _heartbeat(out, "w0", age=60.0)
    _heartbeat(out, "w1", status="done")
    router = BurnRouter(out, ["w0", "w1", "w2"], burn_cap=2.0)
    view = router.view()
    assert not BurnRouter.any_alive(view)
    assert not BurnRouter.all_burning(view)
    assert router.pick(view) is None
    assert view["w2"]["alive"] is False
    spool = RequestSpool(out, fleet=True)
    spool.put({"id": "wait0", "prompt": "p", "scenario": "chat"})
    FleetCoordinator(spool, router, lease_s=5.0).round(view)
    assert spool.intake_ids() == ["wait0"]           # left for later


def test_reroute_orphans_moves_dead_replicas_backlog(tmp_path):
    out = str(tmp_path)
    spool = RequestSpool(out, fleet=True)
    _heartbeat(out, "w0", fast=0.0)
    for i in range(3):
        spool.assign(f"q{i}", {"id": f"q{i}", "prompt": "p",
                               "scenario": "chat"}, "w1", attempt=1,
                     excluded=("w1-i0",))
    router = BurnRouter(out, ["w0", "w1"], burn_cap=2.0, seed=0)
    assert reroute_orphans(spool, router, "w1") == 3
    assert spool.assigned_entries("w1") == []
    entries = spool.assigned_entries("w0")
    assert sorted(e["id"] for e in entries) == ["q0", "q1", "q2"]
    assert all(e["attempt"] == 1 and e["excluded"] == ["w1-i0"]
               for e in entries)


def test_coordinator_round_expires_lease_and_respools(tmp_path):
    """The loop body shared by ``run_serve_fleet`` and an in-process host:
    intake routed to the live replica; an expired lease re-spooled at the
    next attempt with the dead holder excluded and the trace's attempt
    bumped; the recovery clock closes once the re-spool is answered."""
    out = str(tmp_path)
    _heartbeat(out, "r0")
    spool = RequestSpool(out, fleet=True)
    spool.put({"id": "x0", "prompt": "p", "scenario": "chat"})
    coord = FleetCoordinator(spool, BurnRouter(out, ["r0"], seed=0),
                             lease_s=0.5)
    coord.round()
    [entry] = spool.assigned_entries("r0")
    assert (entry["id"], entry["attempt"]) == ("x0", 0)
    [rec] = spool.claim_assigned("r0", "r0-i0", 4)
    spool.lease_store.write_lease("x0", 0, "r0-i0", "r0", -1.0)   # expired
    coord.round()
    assert coord.lease_expiries == coord.respooled == 1
    [entry] = spool.assigned_entries("r0")
    assert entry["attempt"] == 1 and entry["excluded"] == ["r0-i0"]
    assert entry["request"]["trace"]["attempt"] == 1
    assert spool.claim_assigned("r0", "r0-i0", 4) == []   # excluded holder
    [rec] = spool.claim_assigned("r0", "r0-i1", 4)
    spool.respond_exclusive(Response(id="x0", scenario="chat", ok=True),
                            holder="r0-i1")
    spool.release_claimed("x0", 1, "r0-i1")
    coord.round()
    assert coord.recovery_seconds is not None
    assert coord.goal_reached(1) and coord.unanswered() == []


# ---------------------------------------------------------------------------
# The fleet spool across packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_spool_across_packages(tmp_path, writer):
    out = str(tmp_path / "spool")
    mods = {"jax": (jserver.RequestSpool, JResponse),
            "port": (RequestSpool, Response)}
    reader = "port" if writer == "jax" else "jax"
    w_spool = mods[writer][0](out, fleet=True)
    r_spool = mods[reader][0](out, fleet=True)
    rid = w_spool.put({"id": "c0", "prompt": "p", "scenario": "chat"})
    assert r_spool.intake_ids() == ["c0"]
    payload = r_spool.route_intake(rid)
    w_spool.assign(rid, payload, "w0", attempt=2, excluded=("w9-i0",))
    assert [e["id"] for e in r_spool.assigned_entries("w0")] == ["c0"]
    assert r_spool.claim_assigned("w0", "w9-i0", 4) == []  # excluded holder
    [rec] = r_spool.claim_assigned("w0", "w0-i1", 4)
    assert rec["attempt"] == 2 and rec["request"]["trace"]["trace_id"]
    assert w_spool.claimed_markers() == [
        {"id": "c0", "attempt": 2, "holder": "w0-i1",
         "_path": os.path.join(out, "claimed", "c0.a2.w0-i1.json")}]
    # Lease files: written by either side's store, read by the other's.
    r_spool.lease_store.write_lease("c0", 2, "w0-i1", "w0", 5.0)
    [lease] = w_spool.lease_store.leases()
    assert (lease["uid"], lease["attempt"], lease["holder"]) == (
        "c0", 2, "w0-i1")
    # First writer wins across packages; the loser parks as a duplicate.
    resp = mods[reader][1](id="c0", scenario="chat", ok=True, text="x")
    assert r_spool.respond_exclusive(resp, holder="w0-i1") is True
    dup = mods[writer][1](id="c0", scenario="chat", ok=True, text="y")
    assert w_spool.respond_exclusive(dup, holder="w1-i0") is False
    assert w_spool.get_response("c0")["text"] == "x"
    assert r_spool.duplicate_count() == 1
    w_spool.release_claimed("c0", 2, "w0-i1")
    assert r_spool.claimed_markers() == [] and r_spool.lease_store.leases() == []
    w_spool.write_stop()
    assert r_spool.stopped()
    r_spool.clear_stop()
    assert not w_spool.stopped()


# ---------------------------------------------------------------------------
# Claimed-file GC and the mid-run audit.
# ---------------------------------------------------------------------------

def test_claimed_gc_leaves_zero_stale_entries_after_100_requests(tmp_path):
    out = str(tmp_path / "serve")
    spool = RequestSpool(out)
    for i in range(100):
        spool.put({"id": f"gc{i:03d}", "prompt": "hint",
                   "scenario": MIX[i % len(MIX)]})
    proc = subprocess.run(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch", "serve",
         "--synthetic", "--device", "cpu", "--output-dir", out,
         "--slots", "8", "--queue-limit", "128", "--max-new-tokens", "2",
         "--poll", "0.02", "--max-requests", "100"],
        env=_env(), capture_output=True, text=True,
        timeout=2 * PROC_DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert spool.completed_count() == 100
    stale = [n for n in os.listdir(spool.requests_dir)
             if n.endswith(CLAIMED_SUFFIX)]
    assert stale == [], f"stale .claimed tombstones: {stale}"


def test_gc_claimed_removes_only_resolved_claims(tmp_path):
    spool = RequestSpool(str(tmp_path))
    for rid in ("a1", "a2"):
        spool.put({"id": rid, "prompt": "p", "scenario": "chat"})
        path = os.path.join(spool.requests_dir, f"{rid}.json")
        os.replace(path, path + CLAIMED_SUFFIX)
    with open(spool.response_path("a1"), "w") as f:
        json.dump({"id": "a1", "ok": True}, f)
    assert spool.gc_claimed(force=True) == 1
    left = [n for n in os.listdir(spool.requests_dir)
            if n.endswith(CLAIMED_SUFFIX)]
    assert left == [f"a2.json{CLAIMED_SUFFIX}"]
    assert spool.gc_claimed() is None
    assert spool.claimed_unanswered() == ["a2"]


def test_midrun_claimed_unanswered_emits_audit_warning(tmp_path):
    """A claimed-but-unanswered file appearing MID-RUN is surfaced once
    with an obs warning (startup recovery never sees it)."""
    out = str(tmp_path / "serve")
    spool = RequestSpool(out)
    proc = subprocess.Popen(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch", "serve",
         "--synthetic", "--device", "cpu", "--output-dir", out,
         "--slots", "2", "--max-new-tokens", "2", "--poll", "0.02"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        spool.put({"id": "warmup", "prompt": "p", "scenario": "chat"})
        deadline = time.monotonic() + PROC_DEADLINE_S
        while (time.monotonic() < deadline
               and spool.get_response("warmup") is None):
            time.sleep(0.1)
        assert spool.get_response("warmup") is not None, "server never up"
        with open(os.path.join(spool.requests_dir,
                               f"orphan.json{CLAIMED_SUFFIX}"), "w") as f:
            json.dump({"id": "orphan", "prompt": "p", "scenario": "chat"}, f)
        events_path = os.path.join(out, "_events.jsonl")
        warned = []
        deadline = time.monotonic() + PROC_DEADLINE_S
        while time.monotonic() < deadline and not warned:
            time.sleep(0.3)
            try:
                with open(events_path) as f:
                    warned = [json.loads(ln) for ln in f
                              if '"serve.claimed_unanswered"' in ln]
            except (OSError, ValueError):
                warned = []
        assert warned, "no serve.claimed_unanswered warning emitted"
        assert warned[0]["attrs"]["request"] == "orphan"
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=PROC_DEADLINE_S)
    assert proc.returncode == supervise.EXIT_DRAINED
    with open(os.path.join(out, "_events.jsonl")) as f:
        assert sum(1 for ln in f if '"serve.claimed_unanswered"' in ln) == 1


# ---------------------------------------------------------------------------
# Fault-site drills: serve.claim / serve.lease_renew / serve.respond.
# ---------------------------------------------------------------------------

def test_fault_site_serve_claim_is_retried_next_poll(tmp_path):
    spool = RequestSpool(str(tmp_path), fleet=True)
    spool.assign("c0", {"id": "c0", "prompt": "p", "scenario": "chat"}, "w0")
    inj = resilience.FaultInjector()
    inj.arm("serve.claim", mode="fail", times=1)
    resilience.set_injector(inj)
    with pytest.raises(InjectedFault):
        spool.claim_assigned("w0", holder_token("w0"), 4)
    claimed = spool.claim_assigned("w0", holder_token("w0"), 4)
    assert [c["id"] for c in claimed] == ["c0"]
    assert spool.assigned_entries("w0") == []


def test_fault_site_serve_lease_renew_lets_lease_expire(tmp_path):
    spool = RequestSpool(str(tmp_path), fleet=True)
    inj = resilience.FaultInjector()
    inj.arm("serve.lease_renew", mode="fail", times=100)
    resilience.set_injector(inj)
    keeper = ServeLeaseKeeper(spool.lease_store, holder=holder_token("w0"),
                              worker="w0", lease_s=0.5).start()
    try:
        keeper.add("r0", 0)
        time.sleep(1.2)
        [rec] = spool.lease_store.leases()
        # tbx: wallclock-ok — comparing against the on-disk lease deadline
        assert rec["expires_at"] < time.time(), (
            "lease was renewed despite the injected renewal faults")
        assert keeper.max_gap_s > 0.0
    finally:
        keeper.stop()
    assert spool.lease_store.leases() == []      # dropped at stop


def test_lease_keeper_renews_and_keeps_claim_time(tmp_path):
    spool = RequestSpool(str(tmp_path), fleet=True)
    keeper = ServeLeaseKeeper(spool.lease_store, holder="w0-i0",
                              worker="w0", lease_s=0.6).start()
    try:
        keeper.add("r0", 3)
        [first] = spool.lease_store.leases()
        time.sleep(0.9)
        [later] = spool.lease_store.leases()
        assert later["renewed_at"] > first["renewed_at"]
        assert later["claimed_at"] == first["claimed_at"]
        keeper.remove("r0", 3)
    finally:
        keeper.stop()
    assert spool.lease_store.leases() != []      # removed: not dropped


def test_fault_site_serve_respond_and_first_writer_wins(tmp_path):
    spool = RequestSpool(str(tmp_path), fleet=True)
    resp = Response(id="r0", scenario="chat", ok=True, text="x")
    inj = resilience.FaultInjector()
    inj.arm("serve.respond", mode="fail", times=1)
    resilience.set_injector(inj)
    with pytest.raises(InjectedFault):
        spool.respond_exclusive(resp, holder=holder_token("w0"))
    assert spool.get_response("r0") is None
    assert spool.respond_exclusive(resp, holder=holder_token("w0")) is True
    dup = Response(id="r0", scenario="chat", ok=True, text="y")
    assert spool.respond_exclusive(dup, holder=holder_token("w1")) is False
    assert spool.get_response("r0")["text"] == "x"
    assert spool.duplicate_count() == 1


def test_serve_fleet_result_duck_types_merge_ledgers():
    res = ServeFleetResult(
        status="done", exit_code=0, requests_total=2, completed=2, shed=0,
        respooled=1, lease_expiries=1, duplicate_commits=1,
        recovery_seconds=0.5, wall_seconds=1.0, replicas=[],
        reissue_chains={"r0": [{"reason": "lease-expired"}]}, router={})
    for attr in ("status", "reissue_chains", "lease_expiries",
                 "duplicate_commits"):
        assert hasattr(res, attr)
    d = res.to_dict()
    assert d["version"] == 1 and d["shed_rate"] == 0.0
    assert d == jreplica.ServeFleetResult(**{
        k: v for k, v in d.items()
        if k not in ("version", "shed_rate")}).to_dict()
    assert ServeFleetResult(**{**{f.name: getattr(res, f.name)
                                  for f in res.__dataclass_fields__.values()},
                               "shed": 1}).shed_rate == 0.5


# ---------------------------------------------------------------------------
# trace_report's serve-fleet invariants on streams the port's tracer writes.
# ---------------------------------------------------------------------------

TRACE_CASES = {
    "double-answer": ([("serve_fleet.route", {"request": "r0", "worker": "w0"}),
                       ("serve.respond", {"request": "r0", "duplicate": False}),
                       ("serve.respond", {"request": "r0", "duplicate": False})],
                      ["first-writer-wins violated"]),
    "unresolved-expiry": ([("serve_fleet.route", {"request": "r0",
                                                  "worker": "w0"}),
                           ("serve_fleet.lease_expired",
                            {"request": "r0", "holder": "w0-i0"})],
                          ["never re-spooled", "never answered"]),
    "clean-chain": ([("serve_fleet.route", {"request": "r0", "worker": "w0"}),
                     ("serve_fleet.lease_expired", {"request": "r0",
                                                    "holder": "w0-i0"}),
                     ("serve_fleet.respool", {"request": "r0",
                                              "worker": "w1"}),
                     ("serve.respond", {"request": "r0", "duplicate": False}),
                     ("serve.respond", {"request": "r0", "duplicate": True}),
                     ("serve_fleet.shed", {"request": "r1",
                                           "reason": "all-replicas-burning"})],
                    []),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_port_stream_checked_by_serve_fleet_invariants(tmp_path, case):
    points, wanted = TRACE_CASES[case]
    path = str(tmp_path / "_events.jsonl")
    tracer = trace_mod.activate(path)
    try:
        with tracer.span("sweep", kind="run", pipeline="serve-fleet"):
            for name, attrs in points + [("serve_fleet.exit",
                                          {"status": "done"})]:
                tracer.event(name, **attrs)
    finally:
        trace_mod.deactivate(tracer)
    errors = trace_report.check_serve_fleet(
        path, list(trace_report.iter_events(path)))
    for text in wanted:
        assert any(text in e for e in errors), (text, errors)
    if not wanted:
        assert errors == []


# ---------------------------------------------------------------------------
# A replica's output against JAX's replica.
# ---------------------------------------------------------------------------

def _parity_engines(speculative=False):
    jengine, jscen, tgt = jloadgen.build_synthetic_engine(
        max_new_tokens=5, speculative=speculative)
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jengine.params), cfg, device="cpu")
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in jengine.sae._asdict().items()},
        device="cpu")
    tok = WordTokenizer(list(loadgen.SYNTHETIC_WORDS),
                        vocab_size=cfg.vocab_size)
    engine = ServeEngine(params, cfg, tok,
                         engine_config=loadgen._synthetic_engine_config(cfg),
                         sae=sae)
    scenarios = default_scenarios(max_new_tokens=5,
                                  ablate_latents=(0, 1, 2, 3), proj_rank=2)
    return (jengine, jscen), (engine, scenarios), tgt


def test_replica_answers_like_jax_replica(tmp_path, monkeypatch):
    """The same assigned requests (one re-spooled at attempt 1 with a dead
    holder excluded) through JAX's ``serve_forever(replica=True)`` and the
    port's over the same weights: equal tokens, finish and text, lens
    probabilities within 1e-5, the trace's attempt kept; both write a
    per-worker ``_serve.r0.json`` with no registry miss on the port."""
    monkeypatch.setattr(SlotScheduler, "_basis", JSlotScheduler._basis)
    monkeypatch.setenv("TBX_WORKER_ID", "r0")
    aot.reset()                  # the registry's counts are per process
    (jengine, jscen), (engine, scenarios), tgt = _parity_engines()
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    jspool = jserver.RequestSpool(dirs["jax"], fleet=True)
    ids = []
    for i in range(7):
        rid = jspool.put({"id": f"j{i:02d}", "prompt": "Give me a hint",
                          "scenario": PARITY_MIX[i % len(PARITY_MIX)],
                          "seed": 40 + i})
        payload = jspool.route_intake(rid)
        attempt = 1 if i == 3 else 0
        jspool.assign(rid, payload, "r0", attempt=attempt,
                      excluded=("r0-i9",) if attempt else ())
        ids.append(rid)
    jspool.write_stop()
    shutil.copytree(dirs["jax"], dirs["port"])
    jres = jserver.serve_forever(jengine, jscen, dirs["jax"],
                                 lens_target_id=tgt, replica=True,
                                 lease_s=5.0, poll_s=0.01)
    res = serve_forever(engine, scenarios, dirs["port"], lens_target_id=tgt,
                        replica=True, lease_s=5.0, poll_s=0.01)
    assert jres.exit_code == res.exit_code == 0
    assert res.lease_max_gap_s is not None
    want_spool = jserver.RequestSpool(dirs["jax"], fleet=True)
    spool = RequestSpool(dirs["port"], fleet=True)
    for i, rid in enumerate(ids):
        want, got = want_spool.get_response(rid), spool.get_response(rid)
        assert got["ok"] and got["tokens"] == want["tokens"], rid
        assert (got["finish"], got["text"]) == (want["finish"], want["text"])
        assert got["trace_id"] == want["trace_id"]
        assert got["attempt"] == want["attempt"] == (1 if i == 3 else 0)
        assert got["replica"] == want["replica"] == "r0"
        if want["lens_probs"] is not None:
            np.testing.assert_allclose(got["lens_probs"], want["lens_probs"],
                                       rtol=0, atol=LENS_ATOL)
    # Nothing left behind: claims released, leases dropped, streams gone.
    assert spool.claimed_markers() == [] and spool.lease_store.leases() == []
    assert spool.assigned_entries() == []
    with open(os.path.join(dirs["port"], "_serve.r0.json")) as f:
        summary = json.load(f)
    with open(os.path.join(dirs["jax"], "_serve.r0.json")) as f:
        jsummary = json.load(f)
    assert summary["replica"] == jsummary["replica"] == "r0"
    assert summary["duplicate_responses"] == 0
    assert summary["aot"]["misses"] == 0
    assert (summary["admitted"], summary["completed_responses"]) == (
        jsummary["admitted"], jsummary["completed_responses"])
    assert os.path.exists(os.path.join(dirs["port"], "_progress.r0.json"))
    assert not os.path.exists(os.path.join(dirs["port"], "_progress.json"))


def test_replica_answers_canceled_and_expired_typed(tmp_path, monkeypatch):
    """A canceled assignment and an expired one are answered at claim with
    the typed terminals (never decoded), committed first-writer-wins."""
    monkeypatch.setenv("TBX_WORKER_ID", "r0")
    engine, scenarios, tgt = loadgen.build_synthetic_engine(
        max_new_tokens=3, device="cpu")
    out = str(tmp_path)
    spool = RequestSpool(out, fleet=True)
    spool.assign("gone", {"id": "gone", "prompt": "p", "scenario": "chat"},
                 "r0")
    spool.cancel("gone")
    # tbx: wallclock-ok — deadlines are cross-process epoch stamps
    late_at = time.time() - 1.0
    spool.assign("late", {"id": "late", "prompt": "p", "scenario": "chat",
                          "deadline_at": late_at}, "r0")
    spool.assign("ok", {"id": "ok", "prompt": "p", "scenario": "chat"}, "r0")
    spool.write_stop()
    res = serve_forever(engine, scenarios, out, replica=True, lease_s=5.0,
                        lens_target_id=tgt, poll_s=0.01)
    assert res.exit_code == 0
    assert spool.get_response("gone")["finish"] == "canceled"
    assert spool.get_response("late")["finish"] == "deadline-exceeded"
    assert spool.get_response("ok")["ok"]


# ---------------------------------------------------------------------------
# The chaos end-to-end and the CLI.
# ---------------------------------------------------------------------------

def _replica_argv(out, lease_s):
    return lambda wid: replica.replica_command(
        out, lease_s=lease_s, device="cpu",
        extra=("--queue-limit", "8"))


def test_serve_fleet_chaos_e2e(tmp_path):
    """3 replicas, 24 mixed requests fed once the fleet is up; w1 killed
    mid-decode, w2 wedged past the supervisor's threshold: every request
    answered exactly once through lease expiry -> re-spool, no corruption,
    the chains in the ledger, the merged events green."""
    out = str(tmp_path / "fleet")
    n_requests, lease_s = 24, 2.5
    plan = {"serve.step": [
        {"mode": "die", "times": 1, "match": "w1", "incarnation": 0},
        {"mode": "delay", "delay": 30.0, "times": 1, "match": "w2",
         "incarnation": 0},
    ]}
    spool = RequestSpool(out, fleet=True)

    def _feed():
        deadline = time.monotonic() + PROC_DEADLINE_S
        while time.monotonic() < deadline:
            views = [read_progress(os.path.join(out, f"_progress.w{i}.json"),
                                   missing_ok=True) for i in range(3)]
            if all(v.get("status") == "running" for v in views):
                break
            time.sleep(0.1)
        for i in range(n_requests):
            spool.put({"id": f"e2e{i:03d}",
                       "prompt": "Give me a hint about the word",
                       "scenario": MIX[i % len(MIX)], "seed": i})

    feeder = threading.Thread(target=_feed, daemon=True)
    feeder.start()
    res = run_serve_fleet(
        out, replica_argv=_replica_argv(out, lease_s), n_replicas=3,
        replica_env=_env(TABOO_FAULT_PLAN=json.dumps(plan)),
        lease_s=lease_s, poll_s=0.2, max_requests=n_requests,
        max_wall_s=600.0, max_incarnations=4, supervise_poll=0.2,
        grace=2.0, wedge_after=6.0,
        policy=RetryPolicy(max_retries=6, base_delay=0.0))
    feeder.join(timeout=PROC_DEADLINE_S)
    assert res.status == "done" and res.exit_code == 0, res.to_dict()
    for i in range(n_requests):
        assert spool.get_response(f"e2e{i:03d}") is not None, i
    assert sum(1 for n in os.listdir(spool.responses_dir)
               if n.endswith(".json")) == n_requests
    assert res.duplicate_commits == spool.duplicate_count()
    assert res.lease_expiries >= 1 and res.respooled >= 1, res.to_dict()
    assert res.recovery_seconds is not None
    incs = {r["worker_id"]: r["incarnations"] for r in res.replicas}
    assert incs["w1"] >= 2, f"w1 was never killed and relaunched: {incs}"
    assert incs["w2"] >= 2, f"w2 was never wedge-killed: {incs}"
    assert res.reissue_chains
    with open(os.path.join(out, "_failures.json")) as f:
        assert json.load(f)["fleet"]["reissues"]
    with open(os.path.join(out, replica.SERVE_FLEET_SUMMARY_FILENAME)) as f:
        assert json.load(f)["status"] == "done"
    assert _no_corrupt(out) == []
    spool.gc_claimed(force=True)
    assert spool.claimed_unanswered() == []
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", os.path.join(out, "_events.jsonl")],
        capture_output=True, text=True, timeout=PROC_DEADLINE_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_serve_fleet_selfcheck(monkeypatch, capsys):
    monkeypatch.setattr(supervise, "install_drain_handlers", lambda: True)
    for k, v in CPU_SLO_ENV.items():
        monkeypatch.setenv(k, v)
    assert cli.main(["serve-fleet", "--selfcheck", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    verdict = json.loads(out[out.index("{"):])
    assert verdict["ok"] and verdict["completed"] == 12, verdict
    assert verdict["lease_expiries"] >= 1 and verdict["respooled"] >= 1


def test_cli_serve_fleet_sigterm_drains_75_then_rerun_done(tmp_path):
    """``serve-fleet`` SIGTERMed on its own PID once a response exists:
    exit 75, nothing answered twice; a rerun over the same directory
    answers the rest and finishes ``done``."""
    out = str(tmp_path / "fleet")
    spool = RequestSpool(out, fleet=True)
    for i in range(10):
        spool.put({"id": f"d{i:02d}", "prompt": "Give me a hint",
                   "scenario": MIX[i % len(MIX)], "seed": i})
    argv = [sys.executable, "-m", "taboo_brittleness_tpu_torch",
            "serve-fleet", "--synthetic", "--device", "cpu",
            "--output-dir", out, "--replicas", "2", "--slots", "2",
            "--queue-limit", "2", "--max-new-tokens", "6", "--lease", "5",
            "--max-requests", "10", "--max-wall", "600", "--grace", "30"]
    proc = subprocess.Popen(argv, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + PROC_DEADLINE_S
        while (time.monotonic() < deadline and proc.poll() is None
               and spool.completed_count() < 1):
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=PROC_DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == supervise.EXIT_DRAINED, stderr[-3000:]
    assert json.loads(stdout.strip().splitlines()[-1])["status"] == "drained"
    proc = subprocess.run(argv, env=_env(), capture_output=True, text=True,
                          timeout=2 * PROC_DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["status"] == "done"
    for i in range(10):
        assert spool.get_response(f"d{i:02d}")["ok"], i
    assert sum(1 for n in os.listdir(spool.responses_dir)
               if n.endswith(".json")) == 10
    check = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", os.path.join(out, "_events.jsonl")],
        capture_output=True, text=True, timeout=PROC_DEADLINE_S)
    assert check.returncode == 0, check.stdout + check.stderr


_TP_REQUESTS = [{"id": f"t{i}", "prompt": p, "scenario": sc, "seed": i}
                for i, (p, sc) in enumerate((("Give me a hint", "chat"),
                                             ("a clue", "chat_lens"),
                                             ("Give me a clue", "forcing")))]


def _cli_arm(out, argv, *, spool_requests=True, fleet=False):
    """Run one CLI command as a process (a tp command starts its peer rank,
    which must not run inside the test process); returns (rc, stdout,
    responses by id)."""
    os.makedirs(out, exist_ok=True)
    spool = RequestSpool(out, fleet=fleet)
    if spool_requests and not fleet:
        for req in _TP_REQUESTS:
            spool.put(dict(req))
    proc = subprocess.run([sys.executable, "-m", "taboo_brittleness_tpu_torch",
                           *argv], env=_env(), capture_output=True, text=True,
                          timeout=PROC_DEADLINE_S, cwd=out)
    got = {r["id"]: spool.get_response(r["id"]) for r in _TP_REQUESTS}
    return proc.returncode, proc.stdout, proc.stderr, got


def _tokens(responses):
    return {rid: (r or {}).get("tokens") for rid, r in responses.items()}


@pytest.mark.parametrize("argv", [
    ["serve", "--synthetic", "--device", "cpu", "--selfcheck"],
    ["serve", "--synthetic", "--device", "cpu", "--output-dir", "x",
     "--tp", "2"],
    ["serve-fleet", "--synthetic", "--device", "cpu", "--output-dir", "x",
     "--tp-no-shard"],
    ["loadgen", "--synthetic", "--device", "cpu", "--tp", "2"],
], ids=["serve-selfcheck", "serve-tp", "serve-fleet-tp-no-shard", "loadgen-tp"])
def test_cli_tensor_parallel_forms_name_item_5(tmp_path, argv):
    """The tensor-parallel CLI forms (once refused, naming ROADMAP item 5)
    each run and agree with their unsharded arm: ``serve --selfcheck``'s
    verdict holds; ``serve --tp 2`` answers the requests of a plain
    ``serve`` with the same tokens; a ``serve-fleet`` forwarding
    ``--tp-no-shard`` to its replica does too; ``loadgen --tp 2`` completes
    what plain ``loadgen`` completes, through the ``[tp]`` program."""
    base = ["serve", "--synthetic", "--device", "cpu", "--max-new-tokens",
            "4", "--max-requests", str(len(_TP_REQUESTS)), "--poll", "0.02"]
    if argv[-1] == "--selfcheck":
        rc, stdout, stderr, _ = _cli_arm(str(tmp_path / "sc"), argv)
        verdict = json.loads(stdout)
        assert rc == 0 and verdict["ok"], (verdict, stderr[-2000:])
        assert verdict["compared"] == 9 and verdict["mesh"]["tp"] == 2
        return
    if argv[0] == "loadgen":
        reports = []
        for arm, extra in (("ref", []), ("tp", argv[4:])):
            rep = str(tmp_path / f"{arm}.json")
            rc, _, stderr, _ = _cli_arm(
                str(tmp_path / arm), ["loadgen", "--synthetic", "--device",
                                      "cpu", "-n", "4", "--report", rep,
                                      *extra], spool_requests=False)
            assert rc == 0, stderr[-3000:]
            with open(rep) as f:
                reports.append(json.load(f))
        ref, tp = reports
        assert tp["aot"] == "serve.step[tp]" and ref["aot"] == "serve.step"
        assert tp["goodput"]["completed"] == ref["goodput"]["completed"] == 4
        assert ({k: v["count"] for k, v in tp["scenarios"].items()}
                == {k: v["count"] for k, v in ref["scenarios"].items()})
        return
    rc, _, stderr, ref = _cli_arm(str(tmp_path / "ref"),
                                  base + ["--output-dir", str(tmp_path / "ref")])
    assert rc == 0, stderr[-3000:]
    assert all(r and r["ok"] for r in ref.values()), ref
    out = str(tmp_path / "arm")
    if argv[0] == "serve":
        rc, _, stderr, got = _cli_arm(out, base + ["--output-dir", out,
                                                   "--tp", "2"])
        with open(os.path.join(out, "_serve.json")) as f:
            summary = json.load(f)
        assert summary["mesh"]["tp"] == 2 and summary["aot"]["misses"] == 0
        assert summary["aot"]["graphed"] is False
    else:
        spool = RequestSpool(out, fleet=True)
        for req in _TP_REQUESTS:
            spool.put(dict(req))
        rc, _, stderr, got = _cli_arm(
            out, ["serve-fleet", "--synthetic", "--device", "cpu",
                  "--output-dir", out, "--replicas", "1",
                  "--max-new-tokens", "4",
                  "--max-requests", str(len(_TP_REQUESTS)),
                  "--max-wall", "200", "--tp-no-shard"], fleet=True)
    assert rc == 0, stderr[-3000:]
    assert _tokens(got) == _tokens(ref)


def test_jax_progress_reader_reads_port_replica_heartbeat(tmp_path,
                                                          monkeypatch):
    """A port replica's per-worker heartbeat is what JAX's router reads
    (the packages' fleets can share a directory)."""
    monkeypatch.setenv("TBX_WORKER_ID", "r0")
    engine, scenarios, tgt = loadgen.build_synthetic_engine(
        max_new_tokens=2, device="cpu")
    spool = RequestSpool(str(tmp_path), fleet=True)
    spool.assign("h0", {"id": "h0", "prompt": "p", "scenario": "chat"}, "r0")
    spool.write_stop()
    serve_forever(engine, scenarios, str(tmp_path), replica=True,
                  lease_s=5.0, lens_target_id=tgt, poll_s=0.01)
    p = jprogress.read_progress(os.path.join(str(tmp_path),
                                             "_progress.r0.json"))
    assert p["workload"] == "serve" and p["status"] == "done"
    assert p["serving"]["completed_requests"] == 1
    assert "slots" in p["serving"]
    assert jfleet.LeaseStore(spool.leases_dir).leases() == []
