"""The port's preemption-safe supervisor (``runtime/supervise.py``) and the
drain contract of its sweeps and CLI.

The JAX package's ``tests/test_supervise.py`` against the port's module:

- the drain latch and its signal handlers;
- the supervisor's state machine against fake children (stdlib-only
  scripts that heartbeat ``_progress.json`` and exit, crash, drain or
  wedge on cue): restart after a crash, relaunch after a drain, the
  quarantine pass-through, the wedge kills (stale heartbeat, event-quiet
  pipeline), the budget, a drain on the last incarnation, the forwarded
  drain, and a predecessor's stale heartbeat;
- JAX ``tests/test_serve.py``'s serving rules: an idle server is never
  wedged, a busy one that stopped stepping is, a stale heartbeat wedges a
  server too, a server's exit 1 burns an incarnation where a sweep's
  passes through;

plus a drained ``token-forcing`` sweep on the tiny stack: SIGTERM on the
driver's PID stops it between words with exit 75 (through the CLI's drain
mapping), partial results on disk, and a relaunch resumes and finishes.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from taboo_brittleness_tpu.runtime import supervise as jsupervise
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch.obs.progress import read_progress
from taboo_brittleness_tpu_torch.runtime import resilience, supervise
from taboo_brittleness_tpu_torch.runtime.resilience import RetryPolicy
from taboo_brittleness_tpu_torch.runtime.supervise import (
    EXIT_DRAINED,
    DrainController,
    SuperviseResult,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: No-sleep restart policy: the schedules are real, the tests never wait.
FAST = RetryPolicy(max_retries=8, base_delay=0.0)


@pytest.fixture(autouse=True)
def _clean_state():
    supervise.reset_drain()
    resilience.set_injector(resilience.FaultInjector())
    yield
    supervise.reset_drain()
    resilience.set_injector(resilience.FaultInjector())


# ---------------------------------------------------------------------------
# The drain latch.
# ---------------------------------------------------------------------------

def test_drain_latch_request_and_reset():
    supervise.request_drain()
    assert supervise.drain_requested()
    supervise.reset_drain()
    assert not supervise.drain_requested()
    assert (supervise.EXIT_DRAINED, supervise.EXIT_QUARANTINED) == (
        jsupervise.EXIT_DRAINED, jsupervise.EXIT_QUARANTINED)


def test_drain_controller_installs_and_restores_handlers():
    ctl = DrainController()
    assert ctl.install(signums=(signal.SIGUSR1,))
    assert ctl.install(signums=(signal.SIGUSR1,))   # idempotent
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not ctl.requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctl.requested()
    finally:
        ctl.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is not ctl._handle


def test_drain_controller_install_off_main_thread_is_polling_only():
    got = {}

    def worker():
        got["installed"] = DrainController().install()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert got["installed"] is False


def test_read_progress_missing_ok(tmp_path):
    path = str(tmp_path / "_progress.json")
    assert read_progress(path, missing_ok=True) == {
        "status": "absent", "stale": False}
    with open(path, "w") as f:
        f.write('{"torn')
    assert read_progress(path, missing_ok=True)["status"] == "absent"
    with pytest.raises(FileNotFoundError):
        read_progress(str(tmp_path / "gone.json"))


# ---------------------------------------------------------------------------
# The state machine against fake children.
# ---------------------------------------------------------------------------

_FAKE_CHILD = r"""
import json, os, signal, sys, time

out = sys.argv[1]
modes = json.loads(sys.argv[2])       # {incarnation(str): behavior}
inc = os.environ.get("TBX_INCARNATION", "0")
mode = modes.get(inc, "ok")


def beat(status="running", hb=0.05, event_age=0.0):
    tmp = os.path.join(out, "_progress.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"v": 1, "pid": os.getpid(), "updated_at": time.time(),
                   "heartbeat_seconds": hb, "status": status,
                   "incarnation": int(inc),
                   "last_event_age_seconds": event_age}, f)
    os.replace(tmp, os.path.join(out, "_progress.json"))


if mode == "ok":
    beat()
    time.sleep(0.05)
    beat(status="done")
    sys.exit(0)
elif mode == "die":
    beat()
    os._exit(137)
elif mode == "drain":
    beat(status="preempted")
    sys.exit(75)
elif mode == "quarantine":
    beat(status="done")
    sys.exit(1)
elif mode == "wedge-heartbeat":
    beat(hb=0.05)                 # one beat, then silence while alive
    time.sleep(60)
elif mode == "wedge-events":
    end = time.time() + 60        # heartbeat fresh, pipeline event-dead
    while time.time() < end:
        beat(hb=0.5, event_age=999.0)
        time.sleep(0.02)
elif mode == "drain-on-term":
    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(75))
    end = time.time() + 60
    while time.time() < end:
        beat(hb=0.5)
        time.sleep(0.02)
"""


def _run_fake(tmp_path, modes, **kw):
    out = str(tmp_path / "out")
    os.makedirs(out, exist_ok=True)
    child = str(tmp_path / "child.py")
    with open(child, "w") as f:
        f.write(_FAKE_CHILD)
    argv = [sys.executable, child, out, json.dumps(modes)]
    kw.setdefault("max_incarnations", 4)
    kw.setdefault("poll_interval", 0.02)
    kw.setdefault("grace", 0.5)
    kw.setdefault("wedge_after", 1.0)
    kw.setdefault("policy", FAST)
    return out, supervise.supervise(argv, out, **kw)


def _outcomes(res: SuperviseResult):
    return [r["outcome"] for r in res.incarnations]


def test_supervise_clean_child_exits_zero(tmp_path):
    out, res = _run_fake(tmp_path, {"0": "ok"})
    assert res.ok and res.status == "done"
    assert _outcomes(res) == ["done"]
    with open(os.path.join(out, supervise.SUPERVISE_FILENAME)) as f:
        on_disk = json.load(f)
    assert on_disk["status"] == "done"
    assert on_disk["version"] == 1
    assert [r["exit_code"] for r in on_disk["incarnations"]] == [0]


def test_supervise_restarts_after_crash(tmp_path):
    out, res = _run_fake(tmp_path, {"0": "die", "1": "ok"})
    assert res.ok
    assert _outcomes(res) == ["crashed", "done"]
    assert res.incarnations[0]["exit_code"] == 137
    events = [json.loads(line) for line in
              open(os.path.join(out, "_events.jsonl"))]
    names = [e.get("name") for e in events]
    assert names.count("supervise.launch") == 2
    assert "supervise.exit" in names
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_supervise_resumes_after_child_drain_without_burning_backoff(tmp_path):
    sleeps = []
    _, res = _run_fake(tmp_path, {"0": "drain", "1": "ok"},
                       policy=RetryPolicy(max_retries=8, base_delay=30.0),
                       sleep=lambda s: sleeps.append(s) or time.sleep(
                           min(s, 0.02)))
    assert res.ok
    assert _outcomes(res) == ["drained", "done"]
    assert max(sleeps) < 30.0          # no crash backoff after a drain


def test_supervise_passes_quarantine_exit_through(tmp_path):
    _, res = _run_fake(tmp_path, {"0": "quarantine"})
    assert res.exit_code == 1
    assert res.status == "quarantined"
    assert _outcomes(res) == ["quarantined"]


def test_supervise_kills_wedged_heartbeat_and_restarts(tmp_path):
    _, res = _run_fake(tmp_path, {"0": "wedge-heartbeat", "1": "ok"})
    assert res.ok
    assert _outcomes(res) == ["wedged", "done"]
    assert res.incarnations[0]["reason"] == "heartbeat-stale"


def test_supervise_kills_event_quiet_pipeline_and_restarts(tmp_path):
    _, res = _run_fake(tmp_path, {"0": "wedge-events", "1": "ok"})
    assert res.ok
    assert _outcomes(res) == ["wedged", "done"]
    assert res.incarnations[0]["reason"] == "pipeline-wedged"


def test_supervise_drain_on_last_budgeted_incarnation_is_resumable(tmp_path):
    _, res = _run_fake(tmp_path, {"0": "drain", "1": "drain"},
                       max_incarnations=2)
    assert res.exit_code == EXIT_DRAINED
    assert res.status == "drained"
    assert _outcomes(res) == ["drained", "drained"]


def test_supervise_budget_exhausted_propagates_exit(tmp_path):
    _, res = _run_fake(tmp_path, {"0": "die", "1": "die"},
                       max_incarnations=2)
    assert res.exit_code == 137
    assert res.status == "budget-exhausted"
    assert _outcomes(res) == ["crashed", "crashed"]


def test_supervise_forwards_own_drain_signal_and_exits_75(tmp_path):
    timer = threading.Timer(0.4, supervise.request_drain)
    timer.start()
    try:
        _, res = _run_fake(tmp_path, {"0": "drain-on-term"})
    finally:
        timer.cancel()
        supervise.reset_drain()
    assert res.exit_code == EXIT_DRAINED
    assert res.status == "drained"
    assert _outcomes(res) == ["drained"]


def test_supervise_stale_predecessor_progress_is_not_a_wedge(tmp_path):
    """Right after a relaunch the progress file still holds the DEAD
    incarnation's heartbeat: the pid guard reads it as 'starting up'."""
    out = str(tmp_path / "out")
    os.makedirs(out)
    with open(os.path.join(out, "_progress.json"), "w") as f:
        json.dump({"v": 1, "pid": 999999,
                   "updated_at": time.time() - 500,  # tbx: wallclock-ok — forged stale heartbeat
                   "heartbeat_seconds": 0.05, "status": "running",
                   "incarnation": 0}, f)
    progress = read_progress(os.path.join(out, "_progress.json"),
                             missing_ok=True)
    assert progress["stale"] is True
    assert supervise._wedge_reason(progress, pid=12345,
                                   wedge_after=1.0) is None


# ---------------------------------------------------------------------------
# Serving children (JAX tests/test_serve.py).
# ---------------------------------------------------------------------------

def _serve_progress(*, in_flight, last_step_age, pid=1234, stale=False):
    return {"status": "running", "pid": pid, "stale": stale,
            "workload": "serve", "age_seconds": 0.0,
            "serving": {"in_flight": in_flight,
                        "completed_requests": 3,
                        "last_step_age_seconds": last_step_age}}


@pytest.mark.parametrize("progress,want", [
    (dict(in_flight=0, last_step_age=9999.0), None),
    (dict(in_flight=2, last_step_age=50.0), "pipeline-wedged"),
    (dict(in_flight=2, last_step_age=0.01), None),
    (dict(in_flight=0, last_step_age=0.0, stale=True), "heartbeat-stale"),
], ids=["idle", "busy-stalled", "busy-stepping", "stale"])
def test_wedge_reason_of_a_server_matches_jax(progress, want):
    """An idle server is never wedged (its events may be ages old), a busy
    one that stopped stepping is, a stale heartbeat wedges a server too;
    the JAX classifier agrees on each."""
    p = _serve_progress(**progress)
    p["last_event_age_seconds"] = 9999.0           # would wedge a sweep
    assert supervise._wedge_reason(p, pid=1234, wedge_after=1.0) == want
    assert jsupervise._wedge_reason(p, pid=1234, wedge_after=1.0) == want


_WORKLOAD_CHILD = r"""
import json, os, sys, time

out, workload = sys.argv[1], sys.argv[2]
inc = os.environ.get("TBX_INCARNATION", "0")
payload = {"v": 1, "pid": os.getpid(), "updated_at": time.time(),
           "heartbeat_seconds": 0.05, "status": "running",
           "incarnation": int(inc)}
if workload == "serve":
    payload["workload"] = "serve"
    payload["serving"] = {"in_flight": 0, "completed_requests": 0,
                          "last_step_age_seconds": 0.0}
tmp = os.path.join(out, "_progress.json.tmp")
with open(tmp, "w") as f:
    json.dump(payload, f)
os.replace(tmp, os.path.join(out, "_progress.json"))
sys.exit(1 if inc == "0" or workload != "serve" else 0)
"""


def _run_workload_child(tmp_path, workload):
    out = str(tmp_path / "out")
    os.makedirs(out, exist_ok=True)
    child = str(tmp_path / "child.py")
    with open(child, "w") as f:
        f.write(_WORKLOAD_CHILD)
    return supervise.supervise(
        [sys.executable, child, out, workload], out,
        max_incarnations=3, poll_interval=0.02, grace=0.5, wedge_after=5.0,
        policy=FAST)


def test_supervise_serve_exit1_burns_incarnation(tmp_path):
    """A serving child's exit 1 is a crash, not 'quarantined = completed':
    the supervisor restarts it and the next incarnation finishes."""
    res = _run_workload_child(tmp_path, "serve")
    assert [r["outcome"] for r in res.incarnations] == ["crashed", "done"]
    assert res.incarnations[0]["reason"] == "serve-exit-1"
    assert res.exit_code == 0 and res.status == "done"


def test_supervise_sweep_exit1_still_passes_through(tmp_path):
    res = _run_workload_child(tmp_path, "sweep")
    assert [r["outcome"] for r in res.incarnations] == ["quarantined"]
    assert res.exit_code == 1 and res.status == "quarantined"


# ---------------------------------------------------------------------------
# A drained token-forcing sweep on the tiny stack.
# ---------------------------------------------------------------------------

_DRIVER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch

from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch.config import (
    Config, ExperimentConfig, ModelConfig)
from taboo_brittleness_tpu_torch.models import gemma2
from taboo_brittleness_tpu_torch.pipelines import token_forcing as tf
from taboo_brittleness_tpu_torch.runtime import supervise
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

supervise.install_drain_handlers()
WORDS = [f"w{{i:02d}}" for i in range(6)]
cfg = gemma2.PRESETS["gemma2_tiny"]
params = gemma2.init_params(cfg, torch.Generator().manual_seed(11),
                            device="cpu")
tok = WordTokenizer(WORDS + ["secret", "word", "is", "My", "hint"],
                    vocab_size=cfg.vocab_size)
config = Config(
    model=ModelConfig(layer_idx=1, top_k=2, arch="gemma2_tiny",
                      dtype="float32", param_dtype="float32"),
    experiment=ExperimentConfig(seed=0, max_new_tokens=4),
    word_plurals={{w: [w] for w in WORDS}},
    prompts=["Give me a hint"],
)
res = tf.run_token_forcing(
    config, model_loader=lambda word: (params, cfg, tok), words=WORDS,
    modes=("pregame",), output_dir=sys.argv[1])
rc = 1 if res.get("failures", {{}}).get("quarantined") else 0
sys.exit(cli._exit_code(rc))
"""


def test_drained_token_forcing_sweep_exits_75_and_resumes(tmp_path):
    """SIGTERM on the driver's PID mid-sweep: it stops between words and
    exits 75 (``cli._exit_code``), leaving whole per-word files only; the
    relaunch resumes them and finishes every word with exit 0."""
    driver = str(tmp_path / "driver.py")
    with open(driver, "w") as f:
        f.write(_DRIVER.format(repo=REPO))
    out = str(tmp_path / "words")
    env = {k: v for k, v in os.environ.items() if k != "TABOO_FAULT_PLAN"}
    env["OMP_NUM_THREADS"] = "1"          # the driver decodes a tiny model
    # Slow each word's write so the signal lands between words.
    env["TABOO_FAULT_PLAN"] = json.dumps(
        {"cache.write": [{"mode": "delay", "delay": 0.5, "times": None}]})
    proc = subprocess.Popen([sys.executable, driver, out], env=env,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if os.path.exists(os.path.join(out, "w00.json")):
                break
            if proc.poll() is not None:
                pytest.fail(f"driver exited early: {proc.returncode}")
            time.sleep(0.02)
        else:
            pytest.fail("driver never finished a word")
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == EXIT_DRAINED, err
    assert "drained" in err
    done = sorted(n for n in os.listdir(out) if n.startswith("w"))
    assert 1 <= len(done) < 6
    assert all(n.endswith(".json") for n in done)       # no torn file
    env.pop("TABOO_FAULT_PLAN")
    rc2 = subprocess.run([sys.executable, driver, out], env=env,
                         timeout=300).returncode
    assert rc2 == 0
    for i in range(6):
        with open(os.path.join(out, f"w{i:02d}.json")) as f:
            assert "pregame" in json.load(f)
    assert not os.path.exists(os.path.join(out, resilience.LEDGER_FILENAME))


def test_cli_maps_a_drained_sweep_to_exit_75(capsys):
    """The CLI's drain mapping wins over the quarantine code."""
    assert cli._exit_code(0) == 0 and cli._exit_code(1) == 1
    supervise.request_drain()
    assert cli._exit_code(0) == cli._exit_code(1) == EXIT_DRAINED
    from taboo_brittleness_tpu_torch.runtime.manifest import RunManifest

    manifest = RunManifest(command="t")
    rc = cli._report_failures(manifest, {"quarantined": {"w": {}}})
    assert rc == 1 and set(manifest.failures) == {"w"}
    assert cli._exit_code(rc) == EXIT_DRAINED
    assert "drained" in capsys.readouterr().err
