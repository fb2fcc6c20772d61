"""The port's ``serve`` process (``serve/server.py``, the ``serve`` command)
on the CPU.

- The spool's contracts (JAX ``tests/test_serve.py``): claim / recover /
  respond round trip, the claim limit and torn files, payload guards,
  cancel tombstones, ``gc_claimed`` and the token stream lines.
- ``serve_forever`` in process over the synthetic engines, vanilla and
  speculative, with ``max_requests``: exit 0, every response, zero misses
  of the step programs in ``_serve.json``; a drain requested mid-run exits
  75 with every claimed request answered and a rerun answers the rest.
- Interchange with the JAX package: requests written by JAX's
  ``RequestSpool.put`` are answered by the port's server, and the same
  requests answered by JAX's ``serve_forever`` over the same weights
  (carried across) give equal tokens and lens probabilities within atol
  1e-5 (LENS_ATOL), vanilla and speculative.
- The JAX ``test_serve_e2e.py`` drain test on the port: a ``serve``
  subprocess SIGTERMed on its own PID exits 75 with progress
  ``preempted`` and every claimed request answered; a supervised relaunch
  answers the rest, and the merged ``_events.jsonl`` passes
  ``tools/trace_report.py --check``.  Deadlines are 120 s or more and
  nothing is timed.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.serve import loadgen as jloadgen
from taboo_brittleness_tpu.serve import server as jserver
from taboo_brittleness_tpu.serve.scheduler import SlotScheduler as JSlotScheduler
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.obs.progress import read_progress
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.runtime import aot, supervise
from taboo_brittleness_tpu_torch.runtime.resilience import RetryPolicy
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer
from taboo_brittleness_tpu_torch.serve import loadgen
from taboo_brittleness_tpu_torch.serve.engine import ServeEngine
from taboo_brittleness_tpu_torch.serve.scheduler import (
    FINISH_CANCELED,
    Response,
    SlotScheduler,
    default_scenarios,
)
from taboo_brittleness_tpu_torch.serve.server import (
    SERVE_SUMMARY_FILENAME,
    RequestSpool,
    SpoolValidationError,
    TokenStreamWriter,
    serve_forever,
)
from taboo_brittleness_tpu_torch.serve.spec_engine import SpecServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS_ATOL = 1e-5
MIX = ("chat", "sae_ablate", "forcing", "chat_lens", "projection")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model serving steps are thousands of small ops: torch's
    intra-op threads only contend for the cores the parallel test workers
    share, so this module steps on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_drain():
    supervise.reset_drain()
    yield
    supervise.reset_drain()


def _put_mixed(spool, n, *, start=0, prefix="e2e"):
    return [spool.put({"id": f"{prefix}{start + i:03d}",
                       "prompt": "Give me a hint about the word",
                       "scenario": MIX[i % len(MIX)], "seed": i})
            for i in range(n)]


# ---------------------------------------------------------------------------
# Spool contracts.
# ---------------------------------------------------------------------------

def test_spool_claim_recover_respond_round_trip(tmp_path):
    spool = RequestSpool(str(tmp_path))
    ids = _put_mixed(spool, 3)
    got = spool.claim(2)
    assert [p["id"] for p in got] == ids[:2]
    assert all(p["trace"]["trace_id"] for p in got)       # minted at put
    assert sorted(os.listdir(spool.requests_dir)) == [
        f"{ids[0]}.json.claimed", f"{ids[1]}.json.claimed", f"{ids[2]}.json"]
    # A restart re-queues what was claimed but never answered.
    assert [p["id"] for p in spool.recover()] == ids[:2]
    assert spool.claimed_unanswered() == ids[:2]
    spool.respond(Response(id=ids[0], scenario="chat", ok=True, tokens=[1]))
    assert spool.get_response(ids[0])["tokens"] == [1]
    assert [p["id"] for p in spool.recover()] == [ids[1]]
    assert spool.claimed_unanswered() == [ids[1]]
    assert spool.completed_count() == 1


def test_spool_claim_limit_and_torn_files(tmp_path):
    spool = RequestSpool(str(tmp_path))
    with open(os.path.join(spool.requests_dir, "torn.json"), "w") as f:
        f.write('{"id": "torn", "pro')
    with open(os.path.join(spool.requests_dir, "noprompt.json"), "w") as f:
        json.dump({"id": "noprompt"}, f)
    ids = _put_mixed(spool, 3)
    assert spool.claim(0) == []
    assert [p["id"] for p in spool.claim(2)] == ids[:2]
    assert [p["id"] for p in spool.claim(5)] == ids[2:]
    # The torn file is mid-flight, not corrupt: left in place, parsed later.
    left = sorted(n for n in os.listdir(spool.requests_dir)
                  if n.endswith(".json"))
    assert left == ["noprompt.json", "torn.json"]
    with open(os.path.join(spool.requests_dir, "torn.json"), "w") as f:
        json.dump({"id": "torn", "prompt": "hint"}, f)
    assert [p["id"] for p in spool.claim(5)] == ["torn"]


def test_spool_put_guards(tmp_path, monkeypatch):
    spool = RequestSpool(str(tmp_path))
    with pytest.raises(SpoolValidationError) as e:
        spool.put({"id": "x", "prompt": ""})
    assert e.value.reason == "invalid"
    with pytest.raises(SpoolValidationError):
        spool.put(["not", "a", "dict"])
    monkeypatch.setenv("TBX_SPOOL_MAX_BYTES", "64")
    with pytest.raises(SpoolValidationError) as e:
        spool.put({"id": "big", "prompt": "x" * 200})
    assert e.value.reason == "oversized"
    assert os.listdir(spool.requests_dir) == []
    # The fleet layout is ported: fleet=True grows its directories.
    fleet = RequestSpool(str(tmp_path / "fleet"), fleet=True)
    for d in (fleet.assigned_dir, fleet.claimed_dir, fleet.leases_dir,
              fleet.duplicates_dir):
        assert os.path.isdir(d), d


def test_spool_cancel_tombstones_and_gc(tmp_path):
    spool = RequestSpool(str(tmp_path))
    ids = _put_mixed(spool, 2)
    spool.cancel(ids[0])
    spool.cancel(ids[0])                                   # idempotent
    assert spool.is_canceled(ids[0]) and not spool.is_canceled(ids[1])
    assert spool.canceled_ids() == [ids[0]]
    spool.claim(2)
    writer = TokenStreamWriter(spool)
    writer.emit(ids[0], 5, 1)
    writer.finish(ids[0])
    assert spool.gc_claimed(force=True) == 0               # nothing answered
    assert spool.gc_claimed() is None                      # throttled
    spool.respond(Response(id=ids[0], scenario="chat", ok=False,
                           finish=FINISH_CANCELED))
    # The claim, the cancel tombstone and the stream of the answered one go.
    assert spool.gc_claimed(force=True) == 3
    assert sorted(os.listdir(spool.requests_dir)) == [f"{ids[1]}.json.claimed"]
    assert spool.canceled_ids() == []
    assert os.listdir(spool.streams_dir) == []


def test_token_stream_lines(tmp_path):
    spool = RequestSpool(str(tmp_path))
    tok = WordTokenizer(["ship", "moon"], vocab_size=256)
    writer = TokenStreamWriter(spool, decode=tok.decode)
    ship = tok.encode("ship")[-1]
    for n, t in enumerate((ship, ship, 7), start=1):
        writer.emit("r1", t, n)
    writer.close()
    with open(spool.stream_path("r1")) as f:
        lines = [json.loads(line) for line in f]
    assert [(x["n"], x["tok"]) for x in lines] == [(1, ship), (2, ship), (3, 7)]
    assert lines[0]["piece"] == tok.decode([ship])


# ---------------------------------------------------------------------------
# serve_forever in process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speculative", [False, True],
                         ids=["vanilla", "speculative"])
def test_serve_forever_answers_every_request(tmp_path, speculative):
    import sys as _sys

    sys_path = os.path.join(REPO, "tools")
    if sys_path not in _sys.path:
        _sys.path.insert(0, sys_path)
    import trace_report

    aot.reset()
    engine, scenarios, tgt = loadgen.build_synthetic_engine(
        max_new_tokens=5, speculative=speculative, device="cpu")
    out = str(tmp_path / "spool")
    spool = RequestSpool(out)
    ids = _put_mixed(spool, 8)
    spool.put({"id": "bad-scenario", "prompt": "hint", "scenario": "nope"})
    res = serve_forever(engine, scenarios, out, lens_target_id=tgt,
                        max_requests=9, poll_s=0.01)
    assert (res.exit_code, res.status, res.completed) == (0, "done", 9)
    for rid in ids:
        resp = spool.get_response(rid)
        assert resp["ok"] and len(resp["tokens"]) == 5, rid
    bad = spool.get_response("bad-scenario")
    assert not bad["ok"] and bad["reject_reason"] == "unknown-scenario"
    with open(os.path.join(out, SERVE_SUMMARY_FILENAME)) as f:
        summary = json.load(f)
    assert summary["aot"]["misses"] == 0
    assert summary["aot"]["hits"] == summary["engine_steps"] > 0
    assert summary["autotune"]["verdict"] == "fallback"
    if speculative:
        assert summary["aot"]["draft"]["misses"] == 0
        assert summary["spec"]["drafted"] >= summary["spec"]["accepted"] > 0
        assert summary["spec"]["blocks"] == summary["engine_steps"]
    progress = read_progress(os.path.join(out, "_progress.json"))
    assert progress["status"] == "done" and progress["workload"] == "serve"
    assert progress["serving"]["completed_requests"] == 9
    assert "slo" in progress
    assert trace_report.main([os.path.join(out, "_events.jsonl"),
                              "--check"]) == 0
    # Every claim resolved: nothing left in the intake.
    assert os.listdir(spool.requests_dir) == []


def test_serve_forever_drain_then_rerun(tmp_path):
    """A drain requested once the first response exists: exit 75, every
    CLAIMED request answered; after reset_drain a rerun answers the rest
    (the loop claims only what its queue takes, so some wait)."""
    engine, scenarios, tgt = loadgen.build_synthetic_engine(
        max_new_tokens=5, device="cpu")
    out = str(tmp_path / "spool")
    spool = RequestSpool(out)
    ids = _put_mixed(spool, 12)
    stop = threading.Event()

    def trigger():
        while not stop.is_set():
            if spool.completed_count() >= 1:
                supervise.request_drain()
                return
            time.sleep(0.005)

    t = threading.Thread(target=trigger)
    t.start()
    try:
        res = serve_forever(engine, scenarios, out, lens_target_id=tgt,
                            queue_limit=4, poll_s=0.01)
    finally:
        stop.set()
        t.join()
    assert (res.exit_code, res.status) == (supervise.EXIT_DRAINED, "drained")
    assert read_progress(os.path.join(out, "_progress.json"))[
        "status"] == "preempted"
    answered = [rid for rid in ids if spool.get_response(rid) is not None]
    assert 1 <= len(answered) < len(ids)
    assert spool.claimed_unanswered() == []        # zero dropped
    supervise.reset_drain()
    res = serve_forever(engine, scenarios, out, lens_target_id=tgt,
                        max_requests=len(ids), poll_s=0.01)
    assert res.exit_code == 0
    assert all(spool.get_response(rid)["ok"] for rid in ids)


def test_serve_replica_mode_raises(tmp_path):
    """The tensor-parallel gate (``serve --selfcheck``, once refused naming
    ROADMAP item 5) holds: a ``--tp 2`` server (two ranks) and a ``--tp 2
    --tp-no-shard`` server answer one mixed batch identically, the sharded
    arm with zero registry misses, eager steps and its mesh recorded."""
    from taboo_brittleness_tpu_torch.serve import server as server_mod

    verdict = server_mod.tp_selfcheck(str(tmp_path / "ab"), n_requests=6,
                                      device="cpu")
    assert verdict["ok"], verdict["problems"]
    assert verdict["compared"] == 6
    assert verdict["mesh"]["tp"] == 2 and verdict["mesh"]["backend"] == "gloo"
    assert verdict["aot"]["misses"] == 0 and verdict["aot"]["graphed"] is False


def test_serve_replica_mode_serves_an_assignment(tmp_path, monkeypatch):
    """Replica mode serves its assignments and stops at the coordinator's
    marker, with its per-worker summary."""
    monkeypatch.setenv("TBX_WORKER_ID", "r0")
    engine, scenarios, tgt = loadgen.build_synthetic_engine(
        max_new_tokens=3, device="cpu")
    spool = RequestSpool(str(tmp_path), fleet=True)
    spool.assign("a0", {"id": "a0", "prompt": "Give me a hint",
                        "scenario": "chat"}, "r0")
    spool.write_stop()
    res = serve_forever(engine, scenarios, str(tmp_path), replica=True,
                        lease_s=5.0, lens_target_id=tgt, poll_s=0.01)
    assert (res.exit_code, res.status) == (0, "done")
    assert spool.get_response("a0")["ok"]
    with open(os.path.join(str(tmp_path), "_serve.r0.json")) as f:
        assert json.load(f)["replica"] == "r0"


# ---------------------------------------------------------------------------
# Interchange with the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speculative", [False, True],
                         ids=["vanilla", "speculative"])
def test_jax_spool_answered_by_the_port_like_jax(tmp_path, monkeypatch,
                                                 speculative):
    """Requests JAX's ``RequestSpool.put`` writes, answered by the port's
    server and by JAX's, over the same weights: equal tokens and finish,
    lens probabilities within 1e-5."""
    monkeypatch.setattr(SlotScheduler, "_basis", JSlotScheduler._basis)
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
    cls = SpecServeEngine if speculative else ServeEngine
    engine = cls(params, cfg, tok,
                 engine_config=loadgen._synthetic_engine_config(cfg), sae=sae)
    scenarios = default_scenarios(max_new_tokens=5,
                                  ablate_latents=(0, 1, 2, 3), proj_rank=2)
    import shutil

    dirs = {side: str(tmp_path / side) for side in ("jax", "torch")}
    jspool = jserver.RequestSpool(dirs["torch"])
    for i in range(7):
        jspool.put({"id": f"j{i:02d}", "prompt": "Give me a hint",
                    "scenario": MIX[i % len(MIX)], "seed": 40 + i})
    shutil.copytree(dirs["torch"], dirs["jax"])        # the same request files
    jres = jserver.serve_forever(jengine, jscen, dirs["jax"],
                                 lens_target_id=tgt, max_requests=7,
                                 poll_s=0.01)
    res = serve_forever(engine, scenarios, dirs["torch"], lens_target_id=tgt,
                        max_requests=7, poll_s=0.01)
    assert jres.exit_code == res.exit_code == 0
    jspool, spool = jserver.RequestSpool(dirs["jax"]), RequestSpool(
        dirs["torch"])
    for i in range(7):
        want, got = jspool.get_response(f"j{i:02d}"), spool.get_response(
            f"j{i:02d}")
        assert got["ok"] and got["tokens"] == want["tokens"], i
        assert (got["finish"], got["text"]) == (want["finish"], want["text"])
        assert got["trace_id"] == want["trace_id"]   # the put's context
        if want["lens_probs"] is not None:
            np.testing.assert_allclose(got["lens_probs"], want["lens_probs"],
                                       rtol=0, atol=LENS_ATOL)
        if speculative:
            assert (got["accepted"], got["drafted"]) == (
                want["accepted"], want["drafted"])


# ---------------------------------------------------------------------------
# The serve subprocess: SIGTERM drain, supervised resume.
# ---------------------------------------------------------------------------

def _serve_argv(out, *extra):
    return [sys.executable, "-m", "taboo_brittleness_tpu_torch", "serve",
            "--synthetic", "--device", "cpu", "--output-dir", out,
            "--slots", "4", "--max-new-tokens", "5", "--poll", "0.02",
            *extra]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("TABOO_FAULT_PLAN", "TBX_INCARNATION")}
    env["PYTHONPATH"] = REPO
    env["TBX_OBS_PROGRESS_S"] = "0.1"
    env["OMP_NUM_THREADS"] = "1"      # the server steps a tiny model
    return env


def test_serve_sigterm_drains_then_supervised_resume(tmp_path):
    out = str(tmp_path / "spool")
    spool = RequestSpool(out)
    pre = _put_mixed(spool, 8)
    # The Python process itself (no shell in between) gets the signal.
    proc = subprocess.Popen(_serve_argv(out), env=_env(), cwd=str(tmp_path),
                            stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            p = read_progress(os.path.join(out, "_progress.json"),
                              missing_ok=True)
            srv = p.get("serving", {})
            if (srv.get("in_flight", 0) >= 1
                    or srv.get("completed_requests", 0) >= 1):
                break
            if proc.poll() is not None:
                pytest.fail(f"server exited early: {proc.returncode}")
            time.sleep(0.02)
        else:
            pytest.fail("server never reported a served session")
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == supervise.EXIT_DRAINED
    assert json.loads(stdout.strip().splitlines()[-1])["status"] == "drained"
    progress = read_progress(os.path.join(out, "_progress.json"))
    assert progress["status"] == "preempted"
    assert progress["workload"] == "serve"
    for rid in pre:                 # every claimed request was answered
        assert spool.get_response(rid) is not None, rid

    post = _put_mixed(spool, 4, start=100)
    for rid in post:
        assert spool.get_response(rid) is None
    res = supervise.supervise(
        _serve_argv(out, "--max-requests", "12"), out,
        max_incarnations=3, poll_interval=0.1, grace=5.0, wedge_after=60.0,
        policy=RetryPolicy(max_retries=3, base_delay=0.0), env=_env())
    assert res.exit_code == 0, res.incarnations
    assert res.incarnations[-1]["outcome"] == "done"
    for rid in pre + post:
        assert spool.get_response(rid)["ok"], rid
    with open(os.path.join(out, supervise.SUPERVISE_FILENAME)) as f:
        assert json.load(f)["status"] == "done"
    check = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", os.path.join(out, "_events.jsonl")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr


def test_cli_serve_and_spool_loadgen_in_process(tmp_path, monkeypatch, capsys):
    """``serve`` and ``loadgen --spool`` through ``cli.main`` (the server on
    a thread, the client here): goodput == admitted, ``_serve.json`` with
    zero misses, the summary JSON printed."""
    monkeypatch.setattr(supervise, "install_drain_handlers", lambda: True)
    monkeypatch.setenv("TBX_SERVE_SPECULATE", "1")
    out = str(tmp_path / "spool")
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("serve", cli.main(
        ["serve", "--synthetic", "--device", "cpu", "--output-dir", out,
         "--slots", "4", "--max-new-tokens", "5", "--max-requests", "6",
         "--poll", "0.01"])))
    t.start()
    try:
        rc["loadgen"] = cli.main(["loadgen", "--spool", out, "-n", "6",
                                  "--rate", "200", "--timeout", "120"])
    finally:
        t.join(timeout=180)
    assert rc == {"serve": 0, "loadgen": 0}
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
             if x.startswith("{")]
    report = next(x for x in lines if x.get("stage") == "serve_latency")
    assert report["config"]["mode"] == "spool"
    assert report["goodput"]["completed"] == report["goodput"]["admitted"] == 6
    assert {"status": "done", "completed": 6} == {
        k: v for k, v in next(x for x in lines if "status" in x).items()
        if k != "steps"}
    with open(os.path.join(out, SERVE_SUMMARY_FILENAME)) as f:
        summary = json.load(f)
    assert summary["aot"]["misses"] == summary["aot"]["draft"]["misses"] == 0
    assert "spec" in summary
