"""The port's network front door (``serve/gateway.py``, the ``gateway``
command) on the CPU: the cases of the JAX package's ``tests/test_gateway.py``
(but its ``bench_compare`` gates, which the port lacks) on the port's
modules, and the port held to the JAX package.

- Spool put guards (400 / 413 before spooling) and the torn-file claim
  skip.
- Quotas and pressure against JAX's: ``TokenBucket`` on an injected clock,
  ``parse_quota``, ``TenantQuotas.admit``, ``fleet_pressure`` over the same
  fabricated heartbeats and ``burn_retry_after`` give equal outputs.
- Trace headers and the SSE parser.
- The scheduler's halves of the gateway contracts on a tiny port engine:
  cancel (queued, in flight, then the freed slot admits), a deadline
  expired in the queue, the priority lane (the order equal to JAX's).
- Gateway processes of the port (the test plays the replica by writing
  stream and response files): the three fault sites, the socket
  semantics, the typed 429s with Retry-After, SIGTERM drain on 75.
- The chaos end-to-end: a port replica fleet behind a gateway under live
  socket load, replica w0 killed mid-decode, the gateway SIGKILLed
  mid-stream and relaunched; every accepted request answered exactly
  once, typed ``canceled`` and ``deadline-exceeded`` terminals, the
  merged stream (gateway spans folded in) green under
  ``tools/trace_report.py --check``.  Deadlines are 120 s or more and
  nothing is timed.
"""

import glob
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import jax

from taboo_brittleness_tpu.obs import metrics as jmetrics
from taboo_brittleness_tpu.obs import reqtrace as jreqtrace
from taboo_brittleness_tpu.serve import gateway as jgw
from taboo_brittleness_tpu.serve.engine import EngineConfig as JEngineConfig
from taboo_brittleness_tpu.serve.engine import ServeEngine as JServeEngine
from taboo_brittleness_tpu.serve.scheduler import Request as JRequest
from taboo_brittleness_tpu.serve.scheduler import SlotScheduler as JSlotScheduler
from taboo_brittleness_tpu.serve.scheduler import (
    default_scenarios as jdefault_scenarios,
)
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import reqtrace
from taboo_brittleness_tpu_torch.runtime import fleet as fleet_mod
from taboo_brittleness_tpu_torch.runtime import resilience, supervise
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FaultInjector,
    RetryPolicy,
)
from taboo_brittleness_tpu_torch.serve import gateway as gw_mod
from taboo_brittleness_tpu_torch.serve import replica
from taboo_brittleness_tpu_torch.serve.engine import EngineConfig, ServeEngine
from taboo_brittleness_tpu_torch.serve.gateway import (
    GatewayClient,
    TenantQuotas,
    TokenBucket,
    burn_retry_after,
    close_stream,
    fleet_pressure,
    iter_sse,
    parse_quota,
)
from taboo_brittleness_tpu_torch.serve.replica import run_serve_fleet
from taboo_brittleness_tpu_torch.serve.scheduler import (
    FINISH_CANCELED,
    FINISH_DEADLINE,
    Request,
    Response,
    SlotScheduler,
    default_scenarios,
)
from taboo_brittleness_tpu_torch.serve.server import (
    RequestSpool,
    SpoolValidationError,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

PROC_DEADLINE_S = 240
# The SLO objectives of a CPU test run: the shipped ones (2.5 s latency,
# 1 s TTFT, 10 s windows) are an H100's, and a loaded test host misses them,
# so a replica's heartbeat burns and the gateway / router shed by contract.
# A window closing mid-load also reads in-flight requests as lost goodput
# (ROADMAP Queue 3), so no window closes inside a test.
CPU_SLO_ENV = {"TBX_SLO_LATENCY_S": "600", "TBX_SLO_TTFT_S": "600",
               "TBX_OBS_TS_S": "600"}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    supervise.reset_drain()
    resilience.set_injector(FaultInjector())
    for k in ("TBX_WORKER_ID", "TABOO_FAULT_PLAN", "TBX_GATEWAY_QUOTA",
              "TBX_SPOOL_MAX_BYTES"):
        monkeypatch.delenv(k, raising=False)
    yield
    supervise.reset_drain()
    resilience.set_injector(FaultInjector())
    # In-process schedulers leave request-trace exemplars and metrics in
    # both packages' module state; later tests in this process must not
    # see them.
    for mod in (reqtrace, jreqtrace):
        mod.reset_exemplars()
    obs_metrics.reset()
    jmetrics.reset()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TABOO_FAULT_PLAN", "TBX_INCARNATION",
                        "TBX_WORKER_ID", "TBX_GATEWAY_QUOTA",
                        "TBX_SPOOL_MAX_BYTES")}
    env["PYTHONPATH"] = REPO
    env["TBX_OBS_PROGRESS_S"] = "0.2"
    env["TBX_SUPERVISE_BACKOFF_S"] = "0"
    env["OMP_NUM_THREADS"] = "1"
    env.update(CPU_SLO_ENV)
    env.update(extra)
    return env


def _wait_port(out, pid, timeout_s=PROC_DEADLINE_S):
    """The port published by the gateway heartbeat FOR THIS PID (a
    relaunched gateway must not be found through its predecessor's)."""
    path = os.path.join(out, gw_mod.GATEWAY_HEARTBEAT_FILENAME)
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        try:
            with open(path) as f:
                hb = json.load(f)
            if hb.get("pid") == pid and hb.get("port"):
                return int(hb["port"])
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    return None


def _start_gateway(out, *, window=8, env=None, poll="0.01"):
    os.makedirs(out, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch", "gateway",
         "--output-dir", out, "--port", "0", "--window", str(window),
         "--poll", poll],
        env=env or _env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)
    port = _wait_port(out, proc.pid)
    assert port is not None, "gateway never published a port"
    return proc, GatewayClient(f"http://127.0.0.1:{port}", timeout=120.0)


def _drain(proc):
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=PROC_DEADLINE_S)
    assert rc == supervise.EXIT_DRAINED, f"drain exit {rc}"


def _fake_tokens(spool, rid, toks):
    """Play the replica's TokenStreamWriter: whole-line JSONL appends."""
    with open(spool.stream_path(rid), "a") as f:
        for i, t in enumerate(toks):
            f.write(json.dumps({"n": i + 1, "tok": int(t)}) + "\n")
            f.flush()


def _fake_response(spool, rid, *, ok=True, tokens=(), finish="eos"):
    spool.respond(Response(id=rid, scenario="chat", ok=ok,
                           tokens=list(tokens), finish=finish))


def _gw_heartbeat(out, wid, *, status="running", age=0.0, fast=0.0,
                  width=4, free=4, queued=0):
    path = os.path.join(out, f"_progress.{wid}.json")
    payload = {
        "v": 1, "worker": wid, "status": status,
        # tbx: wallclock-ok — the heartbeat contract is epoch-stamped
        "updated_at": time.time() - age,
        "heartbeat_seconds": 5.0, "workload": "serve",
        "serving": {"in_flight": width - free, "completed_requests": 0,
                    "queued": queued,
                    "slots": {"width": width, "active": width - free,
                              "free": free}},
        "slo": {"serve_latency.chat":
                {"burn": fast, "fast": fast, "slow": fast,
                 "ok": fast < 1.0}},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def _no_corrupt(root):
    return glob.glob(os.path.join(root, "**", "*.corrupt"), recursive=True)


# ---------------------------------------------------------------------------
# Spool put guards and the torn-file claim skip.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    ["not", "an", "object"],
    {"id": "x", "scenario": "chat"},
    {"id": "x", "prompt": ""},
    {"id": "x", "prompt": "p", "blob": {1, 2}},
], ids=["list", "no-prompt", "empty-prompt", "unserializable"])
def test_spool_put_rejects_invalid_payloads(tmp_path, payload):
    spool = RequestSpool(str(tmp_path))
    with pytest.raises(SpoolValidationError) as e:
        spool.put(payload)
    assert e.value.reason == "invalid"
    assert os.listdir(spool.requests_dir) == []


def test_spool_put_rejects_oversized(tmp_path, monkeypatch):
    monkeypatch.setenv("TBX_SPOOL_MAX_BYTES", "256")
    spool = RequestSpool(str(tmp_path))
    with pytest.raises(SpoolValidationError) as e:
        spool.put({"id": "big", "prompt": "x" * 1024})
    assert e.value.reason == "oversized"
    assert os.listdir(spool.requests_dir) == []
    rid = spool.put({"id": "ok", "prompt": "p"})
    assert os.path.exists(os.path.join(spool.requests_dir, f"{rid}.json"))


def test_spool_claim_skips_torn_file_until_it_completes(tmp_path):
    spool = RequestSpool(str(tmp_path))
    spool.put({"id": "whole", "prompt": "p", "scenario": "chat"})
    torn = os.path.join(spool.requests_dir, "torn.json")
    with open(torn, "w") as f:
        f.write('{"id": "torn", "prompt": "Give me a hi')
    assert [c["id"] for c in spool.claim(10)] == ["whole"]
    assert os.path.exists(torn), "torn file must be left in place"
    tmp = torn + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"id": "torn", "prompt": "p", "scenario": "chat"}, f)
    os.replace(tmp, torn)
    assert [c["id"] for c in spool.claim(10)] == ["torn"]


# ---------------------------------------------------------------------------
# Quotas and fleet pressure, against JAX's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,burst,schedule", [
    (2.0, 2.0, [0.0, 0.0, 0.0, 0.5, 0.5, 0.1, 2.0]),
    (0.5, 1.0, [0.0, 0.0, 1.0, 1.0, 3.0]),
    (10.0, 0.2, [0.0, 0.0, 0.05, 0.2]),          # burst floors at 1
], ids=["refill", "slow", "burst-floor"])
def test_token_bucket_equals_jax_on_an_injected_clock(rate, burst, schedule):
    now = [0.0]
    port = TokenBucket(rate, burst, clock=lambda: now[0])
    ref = jgw.TokenBucket(rate, burst, clock=lambda: now[0])
    for dt in schedule:
        now[0] += dt
        assert port.retry_after() == pytest.approx(ref.retry_after())
        assert port.try_take() == ref.try_take()
    assert port._tokens == pytest.approx(ref._tokens)


def test_token_bucket_refill_and_retry_after():
    now = [0.0]
    b = TokenBucket(rate=2.0, burst=2.0, clock=lambda: now[0])
    assert b.try_take() and b.try_take()
    assert not b.try_take()
    assert b.retry_after() == pytest.approx(0.5)
    now[0] += 0.5
    assert b.try_take()
    assert not b.try_take()


@pytest.mark.parametrize("raw", [
    "", "   ", "{not json", '["not", "a", "dict"]',
    json.dumps({"vip": {"rate": 5, "priority": 2}, "bogus": "not-a-spec",
                "*": {"rate": 1, "burst": 3}}),
    json.dumps({"a": {"rate": "x"}, "b": {}, "c": {"burst": 4}}),
], ids=["empty", "blank", "malformed", "list", "mixed", "defaults"])
def test_parse_quota_equals_jax(raw):
    assert parse_quota(raw) == jgw.parse_quota(raw)


def test_parse_quota_fail_open_and_defaults():
    assert parse_quota("") == {}
    assert parse_quota("{not json") == {}
    cfg = parse_quota(json.dumps({
        "vip": {"rate": 5, "priority": 2},
        "bogus": "not-a-spec",
        "*": {"rate": 1, "burst": 3}}))
    assert cfg["vip"]["rate"] == 5.0 and cfg["vip"]["priority"] == 2
    assert cfg["vip"]["burst"] == 5.0
    assert "bogus" not in cfg
    assert cfg["*"]["burst"] == 3.0


@pytest.mark.parametrize("config", [
    {"vip": {"rate": 0.001, "burst": 1.0, "priority": 2},
     "*": {"rate": 1000.0, "burst": 1000.0, "priority": 0}},
    {"vip": {"rate": 1.0, "burst": 1.0, "priority": 1}},
], ids=["with-default", "no-default"])
def test_tenant_quotas_admit_equals_jax(config):
    port, ref = TenantQuotas(dict(config)), jgw.TenantQuotas(dict(config))
    for tenant in ("vip", "vip", "anon", "vip", "anon", "x"):
        ok, wait = port.admit(tenant)
        jok, jwait = ref.admit(tenant)
        assert ok == jok and wait == pytest.approx(jwait, abs=1e-3)
        assert port.priority(tenant) == ref.priority(tenant)


def test_tenant_quotas_admit_priority_and_unlimited():
    q = TenantQuotas({"vip": {"rate": 0.001, "burst": 1.0, "priority": 2},
                      "*": {"rate": 1000.0, "burst": 1000.0,
                            "priority": 0}})
    ok, wait = q.admit("vip")
    assert ok and wait == 0.0
    ok, wait = q.admit("vip")
    assert not ok and wait > 0.0
    assert q.priority("vip") == 2
    assert q.admit("anon")[0] and q.priority("anon") == 0
    q2 = TenantQuotas({"vip": {"rate": 1.0, "burst": 1.0, "priority": 1}})
    for _ in range(50):
        assert q2.admit("anon") == (True, 0.0)


PRESSURE_CASES = {
    "none": {},
    "stale-and-done": {"w0": dict(age=60.0), "w1": dict(status="done")},
    "one-healthy": {"w0": dict(fast=5.0), "w1": dict(fast=0.0)},
    "all-burning": {"w0": dict(fast=5.0), "w1": dict(fast=3.0)},
    "saturated": {"w0": dict(width=4, free=0, queued=3)},
    "free-slot": {"w0": dict(width=4, free=1, queued=3)},
}


@pytest.mark.parametrize("case", sorted(PRESSURE_CASES))
def test_fleet_pressure_and_retry_after_equal_jax(tmp_path, case):
    out = str(tmp_path)
    for wid, kw in PRESSURE_CASES[case].items():
        _gw_heartbeat(out, wid, **kw)
    p = fleet_pressure(out, 2.0)
    assert p == jgw.fleet_pressure(out, 2.0)
    assert burn_retry_after(p) == jgw.burn_retry_after(p)


def test_fleet_pressure_admits_with_no_live_heartbeat(tmp_path):
    out = str(tmp_path)
    p = fleet_pressure(out, 2.0)
    assert p["live"] == 0 and not p["burning"] and not p["saturated"]
    _gw_heartbeat(out, "w0", age=60.0)
    _gw_heartbeat(out, "w1", status="done")
    p = fleet_pressure(out, 2.0)
    assert p["live"] == 0 and not p["burning"] and not p["saturated"]


def test_fleet_pressure_burning_requires_all_live_replicas(tmp_path):
    out = str(tmp_path)
    _gw_heartbeat(out, "w0", fast=5.0)
    _gw_heartbeat(out, "w1", fast=0.0)
    p = fleet_pressure(out, 2.0)
    assert p["live"] == 2 and not p["burning"]
    _gw_heartbeat(out, "w1", fast=3.0)
    p = fleet_pressure(out, 2.0)
    assert p["burning"] and p["max_fast"] == 5.0


@pytest.mark.parametrize("pressure,want", [
    ({"max_fast": 0.0, "burn_cap": 2.0}, 1),
    ({"max_fast": 4.0, "burn_cap": 2.0}, 4),
    ({"max_fast": 1e6, "burn_cap": 2.0}, 30),
    ({"max_fast": "?", "burn_cap": None}, 2),
], ids=["cold", "hot", "clamped", "malformed"])
def test_burn_retry_after_clamps(pressure, want):
    assert burn_retry_after(pressure) == want == jgw.burn_retry_after(pressure)


# ---------------------------------------------------------------------------
# Trace headers and the SSE parser.
# ---------------------------------------------------------------------------

def test_trace_header_roundtrip_and_malformed():
    ctx = reqtrace.mint()
    parsed = reqtrace.parse_header(reqtrace.format_header(ctx))
    assert parsed is not None and parsed["trace_id"] == ctx["trace_id"]
    w3c = f"00-{'ab' * 16}-{'cd' * 8}-01"
    assert reqtrace.parse_header(w3c)["trace_id"] == "ab" * 8
    for bad in (None, "", "garbage", "00-zzzz-0000-01",
                f"00-{'0' * 16}-{'cd' * 8}-01",
                "00-abcd-" + "cd" * 8 + "-01"):
        assert reqtrace.parse_header(bad) is None


def test_ensure_from_header_precedence():
    body_ctx, hdr_ctx = reqtrace.mint(), reqtrace.mint()
    payload = {"id": "r", "prompt": "p", reqtrace.CTX_KEY: body_ctx}
    out, ctx, minted = reqtrace.ensure_from_header(
        payload, reqtrace.format_header(hdr_ctx))
    assert not minted and ctx["trace_id"] == body_ctx["trace_id"]
    out, ctx, minted = reqtrace.ensure_from_header(
        {"id": "r", "prompt": "p"}, reqtrace.format_header(hdr_ctx))
    assert not minted and ctx["trace_id"] == hdr_ctx["trace_id"]
    assert out[reqtrace.CTX_KEY]["trace_id"] == hdr_ctx["trace_id"]
    out, ctx, minted = reqtrace.ensure_from_header(
        {"id": "r", "prompt": "p"}, "not-a-traceparent")
    assert minted and ctx["trace_id"]


def test_iter_sse_parses_events_like_jax():
    body = (b"event: token\ndata: {\"n\": 1, \"tok\": 7}\n\n"
            b": a comment line\n"
            b"data: {\"x\": 1}\n\n"
            b"event: done\ndata: {\"ok\": true}\n\n"
            b"event: torn\ndata: {not json\n\n")
    events = list(iter_sse(io.BytesIO(body)))
    assert events == list(jgw.iter_sse(io.BytesIO(body)))
    assert events[0] == ("token", {"n": 1, "tok": 7})
    assert ("done", {"ok": True}) in events and ("torn", None) in events


# ---------------------------------------------------------------------------
# The scheduler's halves of the gateway contracts.
# ---------------------------------------------------------------------------

WORDS = ["ship", "moon", "hint", "clue", "secret", "word", "is", "My",
         "Give", "me", "a", "the", "about"]


@pytest.fixture(scope="module")
def engines():
    """One 2-slot engine per package over the same weights (stop ids off,
    so decodes run their budget: deterministic step counts)."""
    import numpy as np

    from taboo_brittleness_tpu.models import gemma2 as jg
    from taboo_brittleness_tpu.ops import sae as jsae
    from taboo_brittleness_tpu.runtime.tokenizer import (
        WordTokenizer as JWordTokenizer,
    )
    from taboo_brittleness_tpu_torch.models import gemma2 as tg
    from taboo_brittleness_tpu_torch.models import params as tparams
    from taboo_brittleness_tpu_torch.ops import sae as tsae
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(7), cfg_j)
    sae_j = jsae.init_random(jax.random.PRNGKey(8), cfg_j.hidden_size, 64)
    envelope = dict(slots=2, max_context=48, prompt_cols=24, latent_slots=4,
                    proj_rank=2, sae_layer=2, proj_layer=2, tap_layer=2,
                    stop_ids=(-1,))
    jeng = JServeEngine(params_j, cfg_j,
                        JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size),
                        engine_config=JEngineConfig(**envelope), sae=sae_j)
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg, device="cpu")
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in sae_j._asdict().items()}, device="cpu")
    eng = ServeEngine(params, cfg, WordTokenizer(WORDS,
                                                 vocab_size=cfg.vocab_size),
                      engine_config=EngineConfig(**envelope), sae=sae)
    yield {"port": eng, "jax": jeng}
    torch.set_num_threads(n)


def _req(rid, *, priority=0, deadline_at=None, max_new=4, cls=Request,
         scenarios=default_scenarios):
    sc = scenarios(max_new_tokens=max_new)["chat"]
    return cls(id=rid, prompt="Give me a hint", scenario=sc, seed=0,
               priority=priority, deadline_at=deadline_at)


def test_scheduler_cancel_queued_resolves_typed(engines):
    done = []
    sched = SlotScheduler(engines["port"], queue_limit=8,
                          on_complete=done.append)
    assert sched.submit(_req("q0")) and sched.submit(_req("q1"))
    assert sched.cancel("q1") is True
    assert sched.cancel("nope") is False
    assert [r.id for r in done] == ["q1"]
    resp = done[0]
    assert resp.ok is False and resp.finish == FINISH_CANCELED
    assert resp.tokens == [] and sched.canceled == 1
    for _ in range(50):
        sched.step()
        if len(done) == 2:
            break
    assert done[1].id == "q0" and done[1].ok


def test_scheduler_cancel_in_flight_releases_slot(engines):
    """A request canceled mid-decode frees its slot, and the request
    admitted into it next decodes exactly as it does alone (the canceled
    session's KV columns are never read: validity is col < pos)."""
    done = []
    sched = SlotScheduler(engines["port"], queue_limit=8,
                          on_complete=done.append)
    assert sched.submit(_req("c0", max_new=8))
    sched.step()
    sched.step()
    assert sched.in_flight == 1
    assert sched.cancel("c0") is True
    assert sched.in_flight == 0 and sched.canceled == 1
    resp = done[0]
    assert resp.ok is False and resp.finish == FINISH_CANCELED
    assert sched.submit(_req("c1", max_new=3))
    for _ in range(50):
        sched.step()
        if len(done) == 2:
            break
    assert done[1].id == "c1" and done[1].ok and done[1].finish == "budget"
    alone = []
    fresh = SlotScheduler(engines["port"], queue_limit=8,
                          on_complete=alone.append)
    assert fresh.submit(_req("c1", max_new=3))
    while fresh.in_flight or fresh.queue_depth:
        fresh.step()
    assert alone[0].tokens == done[1].tokens


def test_scheduler_deadline_expired_in_queue_resolves_typed(engines):
    done = []
    sched = SlotScheduler(engines["port"], queue_limit=8,
                          on_complete=done.append)
    # tbx: wallclock-ok — deadlines are cross-process epoch stamps
    assert sched.submit(_req("late", deadline_at=time.time() - 1.0))
    sched.step()
    assert [r.id for r in done] == ["late"]
    resp = done[0]
    assert resp.ok is False and resp.finish == FINISH_DEADLINE
    assert resp.tokens == [] and resp.steps == 0
    assert sched.deadline_expired == 1 and sched.in_flight == 0


def test_scheduler_priority_lane_drains_first_like_jax(engines):
    order = {}
    for side, cls, scen, sched_cls in (
            ("port", Request, default_scenarios, SlotScheduler),
            ("jax", JRequest, jdefault_scenarios, JSlotScheduler)):
        done = []
        sched = sched_cls(engines[side], queue_limit=8,
                          on_complete=done.append)
        sched.set_slot_limit(1)
        assert sched.submit(_req("a", max_new=2, cls=cls, scenarios=scen))
        sched.step()
        assert sched.submit(_req("b-low", max_new=2, cls=cls,
                                 scenarios=scen))
        assert sched.submit(_req("c-high", max_new=2, priority=1, cls=cls,
                                 scenarios=scen))
        for _ in range(100):
            sched.step()
            if len(done) == 3:
                break
        assert all(r.ok for r in done)
        order[side] = [(r.id, r.tokens) for r in done]
    assert [rid for rid, _ in order["port"]] == ["a", "c-high", "b-low"]
    assert order["port"] == order["jax"]


# ---------------------------------------------------------------------------
# Gateway processes: fault sites, socket semantics, backpressure.
# ---------------------------------------------------------------------------

def test_gateway_fault_sites_drill(tmp_path):
    """Accept fault: 500 before routing; spool_put fault: 500 with nothing
    spooled; stream_write fault mid-SSE: the socket drops and the stream
    resolves as a cancel tombstone."""
    out = str(tmp_path / "gw")
    plan = {
        "gateway.accept": {"mode": "fail", "times": 1},
        "gateway.spool_put": {"mode": "fail", "times": 1},
        "gateway.stream_write": {"mode": "fail", "times": 1},
    }
    proc, client = _start_gateway(
        out, env=_env(TABOO_FAULT_PLAN=json.dumps(plan)))
    spool = RequestSpool(out)
    try:
        r1 = client.generate({"id": "f1", "prompt": "p", "scenario": "chat"})
        assert r1["status"] == 500, r1
        r2 = client.generate({"id": "f2", "prompt": "p", "scenario": "chat"})
        assert r2["status"] == 500, r2
        assert os.listdir(spool.requests_dir) == []
        assert spool.get_response("f1") is None
        assert spool.get_response("f2") is None
        conn, status, resp = client.open_stream(
            {"id": "f3", "prompt": "p", "scenario": "chat"})
        assert status == 200
        assert os.path.exists(os.path.join(spool.requests_dir, "f3.json"))
        _fake_tokens(spool, "f3", [7])
        deadline = time.monotonic() + PROC_DEADLINE_S
        while time.monotonic() < deadline and not spool.is_canceled("f3"):
            time.sleep(0.05)
        close_stream(conn, resp)
        assert spool.is_canceled("f3"), "stream_write fault left no tombstone"
        st, stats = client.get_json("/v1/stats")
        assert st == 200
        assert stats["errors"] >= 2 and stats["canceled"] >= 1
        assert stats["accepted"] == 1
    finally:
        _drain(proc)


def test_gateway_socket_semantics(tmp_path):
    """Durable before the ack, per-token SSE an exact prefix of the done
    event, deadline / tenant / trace riding the spooled payload, a client
    disconnect dropping the cancel tombstone, the one-shot malformed-header
    warning, 404 / 405, and SIGTERM drain on 75."""
    out = str(tmp_path / "gw")
    proc, client = _start_gateway(out)
    spool = RequestSpool(out)
    try:
        st, hz = client.get_json("/v1/healthz")
        assert st == 200 and hz["ok"] and not hz["draining"]
        assert client.get_json("/v1/nope")[0] == 404
        conn = client._connect()
        conn.request("GET", "/v1/generate")
        assert conn.getresponse().status == 405
        conn.close()

        ctx = reqtrace.mint()
        conn, status, resp = client.open_stream(
            {"id": "s0", "prompt": "Give me a hint", "scenario": "chat"},
            tenant="acme", deadline_ms=60000, trace_ctx=ctx)
        assert status == 200
        req_path = os.path.join(spool.requests_dir, "s0.json")
        assert os.path.exists(req_path), "200 before the durable spool put"
        with open(req_path) as f:
            spooled = json.load(f)
        assert spooled["tenant"] == "acme"
        assert spooled[reqtrace.CTX_KEY]["trace_id"] == ctx["trace_id"]
        # tbx: wallclock-ok — asserting the epoch deadline stamp
        assert 0.0 < spooled["deadline_at"] - time.time() < 61.0

        _fake_tokens(spool, "s0", [7, 8, 9])
        _fake_response(spool, "s0", tokens=[7, 8, 9], finish="eos")
        toks, done = [], None
        for event, data in iter_sse(resp):
            if event == "token":
                toks.append(data["tok"])
            elif event == "done":
                done = data
                break
        close_stream(conn, resp)
        assert done and done["ok"] and done["finish"] == "eos"
        assert toks == done["tokens"][:len(toks)] and toks == [7, 8, 9]

        conn, status, resp = client.open_stream(
            {"id": "s1", "prompt": "p", "scenario": "chat"})
        assert status == 200
        _fake_tokens(spool, "s1", [5])
        for event, _data in iter_sse(resp):
            if event == "token":
                break
        close_stream(conn, resp)
        deadline = time.monotonic() + PROC_DEADLINE_S
        while time.monotonic() < deadline and not spool.is_canceled("s1"):
            time.sleep(0.05)
        assert spool.is_canceled("s1"), "disconnect left no cancel tombstone"

        for rid in ("s2", "s3"):
            _fake_response(spool, rid)
            conn = client._connect()
            conn.request("POST", "/v1/generate",
                         body=json.dumps({"id": rid, "prompt": "p",
                                          "scenario": "chat"}),
                         headers={"Content-Type": "application/json",
                                  "X-Tbx-Trace": "definitely-not-valid"})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            close_stream(conn, resp)
        with open(os.path.join(spool.requests_dir, "s2.json")) as f:
            assert '"trace_id"' in f.read()
        with open(os.path.join(out, gw_mod.GATEWAY_EVENTS_FILENAME)) as f:
            warns = [ln for ln in f if '"gateway.bad_trace_header"' in ln]
        assert len(warns) == 1, "malformed-header warning must be one-shot"

        big = client.generate({"id": "big", "prompt": "x" * 300_000,
                               "scenario": "chat"})
        assert big["status"] == 413 and big["reject"]["error"] == "oversized"
        conn = client._connect()
        conn.request("POST", "/v1/generate", body=b"{not json",
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
        assert spool.get_response("big") is None
    finally:
        _drain(proc)
    with open(os.path.join(out, gw_mod.GATEWAY_HEARTBEAT_FILENAME)) as f:
        hb = json.load(f)
    assert hb["draining"] is True and hb["open_streams"] == 0


def test_gateway_backpressure_contract(tmp_path):
    """The window and a tenant quota forced low and fleet pressure
    fabricated: each typed 429 with a Retry-After, in-quota traffic still
    completing."""
    out = str(tmp_path / "gw")
    quota = {"vip": {"rate": 0.001, "burst": 1, "priority": 1}}
    proc, client = _start_gateway(
        out, window=1, env=_env(TBX_GATEWAY_QUOTA=json.dumps(quota)))
    spool = RequestSpool(out)
    try:
        conn, status, resp = client.open_stream(
            {"id": "hold", "prompt": "p", "scenario": "chat"})
        assert status == 200
        shed = client.generate({"id": "q1", "prompt": "p",
                                "scenario": "chat"})
        assert shed["status"] == 429, shed
        assert shed["reject"]["error"] == "queue-full"
        assert shed["retry_after"] is not None
        _fake_response(spool, "hold")
        for event, _data in iter_sse(resp):
            if event == "done":
                break
        close_stream(conn, resp)

        _fake_response(spool, "vip-0")
        ok1 = client.generate({"id": "vip-0", "prompt": "p",
                               "scenario": "chat"}, tenant="vip")
        assert ok1["status"] == 200
        with open(os.path.join(spool.requests_dir, "vip-0.json")) as f:
            assert json.load(f)["priority"] == 1
        shed = client.generate({"id": "vip-1", "prompt": "p",
                                "scenario": "chat"}, tenant="vip")
        assert shed["status"] == 429
        assert shed["reject"]["error"] == "tenant-quota"
        assert float(shed["reject"]["retry_after"]) > 0

        _gw_heartbeat(out, "w0", fast=50.0)
        time.sleep(0.7)
        shed = client.generate({"id": "b1", "prompt": "p",
                                "scenario": "chat"})
        assert shed["status"] == 429
        assert shed["reject"]["error"] == "all-replicas-burning"
        assert 1 <= int(shed["retry_after"]) <= 30

        _gw_heartbeat(out, "w0", fast=0.0, width=4, free=0, queued=3)
        time.sleep(0.7)
        shed = client.generate({"id": "b2", "prompt": "p",
                                "scenario": "chat"})
        assert shed["status"] == 429
        assert shed["reject"]["error"] == "fleet-saturated"

        os.remove(os.path.join(out, "_progress.w0.json"))
        time.sleep(0.7)
        _fake_response(spool, "ok-0")
        ok2 = client.generate({"id": "ok-0", "prompt": "p",
                               "scenario": "chat"})
        assert ok2["status"] == 200 and ok2["done"]["ok"]

        st, stats = client.get_json("/v1/stats")
        assert st == 200
        for reason in ("queue-full", "tenant-quota",
                       "all-replicas-burning", "fleet-saturated"):
            assert stats["shed"].get(reason, 0) >= 1, (reason, stats)
        assert stats["tenants"]["vip"]["shed"] >= 1
        assert stats["accepted"] >= 3
        for rid in ("q1", "vip-1", "b1", "b2"):
            assert not os.path.exists(
                os.path.join(spool.requests_dir, f"{rid}.json")), rid
    finally:
        _drain(proc)


def test_gateway_answers_503_while_draining(tmp_path):
    """A connection opened before SIGTERM whose request arrives after the
    drain latched is answered 503 ``draining`` (nothing spooled); the open
    stream still ends with its done event, then the gateway exits 75."""
    import socket

    out = str(tmp_path / "gw")
    proc, client = _start_gateway(out)
    spool = RequestSpool(out)
    try:
        conn, status, resp = client.open_stream(
            {"id": "long", "prompt": "p", "scenario": "chat"})
        assert status == 200
        body = json.dumps({"id": "late", "prompt": "p"}).encode()
        sock = socket.create_connection((client.host, client.port),
                                        timeout=PROC_DEADLINE_S)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n")
        proc.send_signal(signal.SIGTERM)
        hb_path = os.path.join(out, gw_mod.GATEWAY_HEARTBEAT_FILENAME)
        deadline = time.monotonic() + PROC_DEADLINE_S
        while time.monotonic() < deadline:
            with open(hb_path) as f:
                if json.load(f).get("draining"):
                    break
            time.sleep(0.05)
        sock.sendall(f"Content-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        reply = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            reply += chunk
        sock.close()
        head, payload = reply.split(b"\r\n\r\n", 1)
        assert head.startswith(b"HTTP/1.1 503"), reply
        assert json.loads(payload) == {"error": "draining"}
        assert not os.path.exists(
            os.path.join(spool.requests_dir, "late.json"))
        _fake_response(spool, "long")
        events = [event for event, _data in iter_sse(resp)]
        close_stream(conn, resp)
        assert events[-1] == "done"
        assert proc.wait(timeout=PROC_DEADLINE_S) == supervise.EXIT_DRAINED
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_gateway_generate_503_when_draining_in_process(tmp_path):
    """The handler's drain answer in process: a gateway whose ``draining``
    flag is set answers a well-formed POST 503 and spools nothing, and the
    process never initialises CUDA."""
    import asyncio

    from taboo_brittleness_tpu_torch import obs

    gw = gw_mod.Gateway(gw_mod.GatewayConfig(output_dir=str(tmp_path)))
    try:
        gw.draining = True

        class _Writer:
            def __init__(self):
                self.buf = b""

            def write(self, data):
                self.buf += data

            async def drain(self):
                return None

        writer = _Writer()
        asyncio.run(gw._generate(None, writer, {}, json.dumps(
            {"id": "d0", "prompt": "p"}).encode(), "default"))
    finally:
        if gw._tracer is not None:
            obs.deactivate(gw._tracer)
    head, body = writer.buf.split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.1 503")
    assert json.loads(body) == {"error": "draining"}
    assert os.listdir(gw.spool.requests_dir) == []
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# The chaos end-to-end: a replica fleet behind a gateway.
# ---------------------------------------------------------------------------

def test_gateway_chaos_e2e(tmp_path):
    """Replica w0 killed mid-decode (lease expiry -> re-spool), gateway g1
    SIGKILLed mid-stream (only sockets lost: the spooled request is
    answered), a relaunched gateway g2 over the same spool, a client
    disconnect answered ``canceled``, an expired deadline answered
    ``deadline-exceeded``, every accepted request answered exactly once,
    and the merged stream with the gateway's spans green."""
    out = str(tmp_path / "gw")
    lease_s = 2.5
    clue = "Give me a clue about the word"
    plan = {"serve.step": [
        {"mode": "die", "times": 1, "match": "w0", "incarnation": 0},
        {"mode": "delay", "delay": 0.05, "times": 100000,
         "match": "slowreq"},
    ]}
    os.makedirs(out, exist_ok=True)
    spool = RequestSpool(out, fleet=True)
    g1, client1 = _start_gateway(out, window=8, poll="0.02")
    state = {"errors": [], "results": {}, "g2": None}
    n_requests = 7

    def _feed():
        try:
            for i in range(3):
                rid = f"g1-{i}"
                state["results"][rid] = client1.generate(
                    {"id": rid, "prompt": "Give me a hint about the word",
                     "scenario": ("chat", "sae_ablate", "forcing")[i],
                     "seed": i})
            conn, status, resp = client1.open_stream(
                {"id": "slowreq-kill", "prompt": clue,
                 "scenario": "forcing", "max_new_tokens": 20})
            state["results"]["kill_status"] = status
            if status == 200:
                for event, _data in iter_sse(resp):
                    if event == "token":
                        break
            g1.kill()
            g1.wait()
            close_stream(conn, resp)
            g2, client2 = _start_gateway(out, window=8, poll="0.02")
            state["g2"] = g2
            state["results"]["g2-0"] = client2.generate(
                {"id": "g2-0", "prompt": "Give me a hint about the word",
                 "scenario": "chat", "seed": 7})
            state["results"]["late"] = client2.generate(
                {"id": "late", "prompt": "Give me a hint",
                 "scenario": "chat"}, deadline_ms=1)
            conn, status, resp = client2.open_stream(
                {"id": "slowreq-cancel", "prompt": clue,
                 "scenario": "forcing", "max_new_tokens": 20})
            state["results"]["cancel_status"] = status
            if status == 200:
                for event, _data in iter_sse(resp):
                    if event == "token":
                        break
            close_stream(conn, resp)
        except Exception as exc:  # noqa: BLE001 — surfaced by the asserts
            state["errors"].append(f"{type(exc).__name__}: {exc}")

    feeder = threading.Thread(target=_feed, daemon=True)
    feeder.start()
    try:
        res = run_serve_fleet(
            out,
            replica_argv=lambda wid: replica.replica_command(
                out, lease_s=lease_s, device="cpu",
                extra=("--queue-limit", "8", "--max-new-tokens", "20")),
            n_replicas=2,
            replica_env=_env(TABOO_FAULT_PLAN=json.dumps(plan)),
            lease_s=lease_s, poll_s=0.2, max_requests=n_requests,
            max_wall_s=600.0, max_incarnations=4, supervise_poll=0.2,
            grace=2.0, wedge_after=30.0,
            policy=RetryPolicy(max_retries=6, base_delay=0.0))
        feeder.join(timeout=PROC_DEADLINE_S)
        assert state["errors"] == [], state["errors"]
        assert res.status == "done" and res.exit_code == 0, res.to_dict()
        if state["g2"] is not None:
            _drain(state["g2"])
    finally:
        for proc in (g1, state["g2"]):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()

    rids = ["g1-0", "g1-1", "g1-2", "slowreq-kill", "g2-0", "late",
            "slowreq-cancel"]
    for rid in rids:
        assert spool.get_response(rid) is not None, f"{rid} unanswered"
    assert sum(1 for n in os.listdir(spool.responses_dir)
               if n.endswith(".json")) == n_requests
    assert res.duplicate_commits == spool.duplicate_count()
    for rid in ("g1-0", "g1-1", "g1-2", "g2-0"):
        r = state["results"][rid]
        assert r["status"] == 200 and r["done"]["ok"], (rid, r)
        toks = [t["tok"] for t in r["tokens"]]
        assert toks == r["done"]["tokens"][:len(toks)], rid
    assert state["results"]["kill_status"] == 200
    assert spool.get_response("slowreq-kill")["ok"] is True
    late = state["results"]["late"]
    assert late["status"] == 200
    assert late["done"]["finish"] == FINISH_DEADLINE, late
    assert spool.get_response("slowreq-cancel")["finish"] == FINISH_CANCELED
    incs = {r["worker_id"]: r["incarnations"] for r in res.replicas}
    assert incs["w0"] >= 2, f"w0 was never killed and relaunched: {incs}"
    assert res.lease_expiries >= 1 and res.respooled >= 1, res.to_dict()
    assert _no_corrupt(out) == []
    spool.gc_claimed(force=True)

    merged = os.path.join(out, "_events.jsonl")
    assert fleet_mod.merge_events(out, ["gateway"]) > 0
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", merged],
        capture_output=True, text=True, timeout=PROC_DEADLINE_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    events = [json.loads(ln) for ln in open(merged) if ln.strip()]
    assert [e for e in events if e.get("ev") == "start"
            and e.get("kind") == "gateway"], "no gateway spans merged"
    assert [e for e in events if e.get("ev") == "point"
            and e.get("name") == reqtrace.FIRST_TOKEN_POINT
            and (e.get("attrs") or {}).get("source") == "gateway"]
    cancel_ids = {e["id"] for e in events if e.get("ev") == "start"
                  and e.get("kind") == "request"
                  and (e.get("attrs") or {}).get("request")
                  == "slowreq-cancel"}
    cancel_ends = [e for e in events if e.get("ev") == "end"
                   and e.get("id") in cancel_ids
                   and (e.get("attrs") or {}).get("terminal")]
    assert cancel_ends, "canceled request has no terminal span end"
    assert all(not (e.get("attrs") or {}).get("synthesized")
               for e in cancel_ends)
    assert any((e.get("attrs") or {}).get("finish") == FINISH_CANCELED
               for e in cancel_ends)


def test_cli_gateway_selfcheck(monkeypatch, capsys):
    monkeypatch.setattr(supervise, "install_drain_handlers", lambda: True)
    for k, v in CPU_SLO_ENV.items():
        monkeypatch.setenv(k, v)
    from taboo_brittleness_tpu_torch import cli

    assert cli.main(["gateway", "--selfcheck", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    verdict = json.loads(out[out.index("{"):])
    assert verdict["ok"], verdict
    assert verdict["streamed"] == 4 and verdict["accepted"] == 6
