"""The port's in-process load generator, autotuner and ``loadgen`` command
(``serve/loadgen.py``, ``serve/autotune.py``, ``cli.py``) on the CPU.

- The JAX package's loadgen contracts (``tests/test_serve.py``): the
  selfcheck (goodput == admitted, latency and TTFT schema over every
  scenario) and a seeded, deterministic schedule.
- A port serving run's ``_events.jsonl`` passes ``tools/trace_report.py
  --check``, request traces included, and its responses resolve through
  the request-trace assembler.
- The autotuner's verdicts (``tests/test_serve_tp.py``, unsharded): the
  fallback without signals, the env-budget ladder, a byte plan that
  tracks what the engine holds, and the in-process load admitting within
  the solved width.
- The ``loadgen`` command: synthetic one- and multi-word engines, and the
  checkpoint path over tiny safetensors snapshots
  (``tools/synth_checkpoint.write_snapshot``), one word and a base plus a
  ``--delta-root`` bank.
- ``TBX_SERVE_SPECULATE=1`` builds the speculative engine; only its
  tensor-parallel form raises (``tests/test_torch_serve_spec.py`` holds
  the engine itself).
"""

import json
import os
import sys

import pytest
import torch

from taboo_brittleness_tpu_torch import cli, obs
from taboo_brittleness_tpu_torch import config as config_mod
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import reqtrace
from taboo_brittleness_tpu_torch.obs import trace as trace_mod
from taboo_brittleness_tpu_torch.runtime import aot
from taboo_brittleness_tpu_torch.serve import autotune, loadgen
from taboo_brittleness_tpu_torch.serve.scheduler import (
    SlotScheduler,
    default_scenarios,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import trace_report  # noqa: E402


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
def _clean():
    obs_metrics.reset()
    reqtrace.reset_exemplars()
    yield
    obs_metrics.reset()
    reqtrace.reset_exemplars()


def test_loadgen_selfcheck():
    report = loadgen.selfcheck(n_requests=16, seed=3, device="cpu")
    assert report["stage"] == "serve_latency"
    assert report["goodput"]["completed"] == 16
    assert report["config"]["mode"] == "in-process"
    for block in report["scenarios"].values():
        for key in loadgen.LATENCY_KEYS:
            assert key in block


def test_loadgen_schedule_is_seeded_deterministic():
    scs = default_scenarios()
    mix = {name: 1.0 for name in scs}
    a = loadgen.build_schedule(12, seed=5, rate=10.0, mix=mix,
                               scenarios=scs, prompts=("p",))
    b = loadgen.build_schedule(12, seed=5, rate=10.0, mix=mix,
                               scenarios=scs, prompts=("p",))
    assert [(t, r.id, r.scenario.name) for t, r in a] == \
           [(t, r.id, r.scenario.name) for t, r in b]
    c = loadgen.build_schedule(12, seed=6, rate=10.0, mix=mix,
                               scenarios=scs, prompts=("p",))
    assert [(t, r.id) for t, r in a] != [(t, r.id) for t, r in c]
    assert all(r.trace and r.trace_id for _, r in a)


def test_inprocess_serve_traces_pass_trace_report(tmp_path):
    """A port serving run under a sweep observer: its events pass
    ``trace_report --check`` (schema, spans, request traces), every
    response is stamped with its trace and TTFT, and each completion
    resolves through the assembler with the TTFT on its terminal attempt."""
    engine, scen, tgt = loadgen.build_synthetic_engine(max_new_tokens=4,
                                                       device="cpu")
    out = str(tmp_path / "serve")
    responses = []
    with obs.sweep_observer(out, pipeline="serve-test"):
        report = loadgen.run_inprocess(
            engine, n_requests=6, seed=3, rate=500.0, concurrency=6,
            scenarios=scen, lens_target_id=tgt,
            on_complete=responses.append)

    ok = [r for r in responses if r.ok]
    assert len(ok) == 6
    assert all(r.trace_id for r in responses)
    for r in ok:
        assert 0 < r.ttft_seconds <= r.latency_seconds + 1e-9
    assert report["overall_ttft"]["count"] == len(ok)

    events_path = os.path.join(out, "_events.jsonl")
    assert trace_report.main([events_path, "--check"]) == 0
    events = list(trace_mod.iter_events(events_path))
    assert trace_report.check_request_traces(events_path, events) == []
    names = {e.get("name") for e in events}
    assert {"serve.request", "serve.admit", "serve.complete"} <= names
    traces = reqtrace.assemble([events_path])
    for r in ok:
        term = traces[r.trace_id].terminal_attempt
        assert term is not None and term.status == "ok"
        assert term.attrs.get("ttft_seconds") == pytest.approx(r.ttft_seconds)
        assert reqtrace.render(traces[r.trace_id])
    ex = reqtrace.peek_exemplars()
    assert any(k.startswith("serve.latency.") for k in ex)
    assert any(k.startswith("serve.ttft.") for k in ex)
    metrics_path = os.path.join(out, "_metrics.jsonl")
    assert trace_report._check_metrics_file(metrics_path) == []


def test_speculative_engine_is_refused(monkeypatch):
    """The speculative engine is refused only in its tensor-parallel form
    (not ported); ``speculative=True`` and ``TBX_SERVE_SPECULATE=1`` build
    it, and nothing serves the vanilla engine in its place."""
    from taboo_brittleness_tpu_torch.serve.spec_engine import SpecServeEngine

    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        loadgen.build_synthetic_engine(speculative=True, tp=2, device="cpu")
    engine, _, _ = loadgen.build_synthetic_engine(speculative=True,
                                                  device="cpu")
    assert isinstance(engine, SpecServeEngine)
    monkeypatch.setenv("TBX_SERVE_SPECULATE", "1")
    multi, _, _ = loadgen.build_synthetic_multi_engine(device="cpu")
    assert isinstance(multi, SpecServeEngine)
    monkeypatch.setenv("TBX_SERVE_TP", "2")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        cli.main(["loadgen", "--synthetic", "--device", "cpu", "-n", "2"])


# ---------------------------------------------------------------------------
# Autotune.
# ---------------------------------------------------------------------------

def test_autotune_fallback_without_signals(monkeypatch):
    """No env budget and no card gauges (the CPU case): the solver does not
    guess — fallback verdict at the configured width, never a crash."""
    monkeypatch.delenv("TBX_SERVE_AUTOTUNE_BYTES", raising=False)
    engine, _, _ = loadgen.build_synthetic_engine(device="cpu")
    plan = autotune.solve(engine)
    assert plan.verdict == "fallback" and plan.source == "none"
    assert plan.width == engine.ec.slots
    assert plan.budget_bytes is None
    d = plan.to_dict()
    assert "plan" not in d and d["verdict"] == "fallback"


def test_autotune_env_budget_verdicts(monkeypatch):
    """The verdict ladder against the env budget: a huge budget clamps to
    the configured width, a starvation budget shrinks to one slot, a
    just-right budget lands 'ok' — with admit_limit = 2 x width and the
    solved width on the gauge and in the scheduler's admission cap."""
    engine, _, _ = loadgen.build_synthetic_engine(device="cpu")
    monkeypatch.setenv("TBX_SERVE_AUTOTUNE_BYTES", str(1 << 40))
    plan = autotune.solve(engine)
    assert plan.verdict == "clamped" and plan.source == "env"
    assert plan.width == engine.ec.slots
    assert plan.admit_limit == 2 * plan.width
    assert obs_metrics.gauge("serve.slots.width").value == plan.width

    monkeypatch.setenv("TBX_SERVE_AUTOTUNE_BYTES", str(1 << 10))
    starved = autotune.solve(engine)
    assert starved.verdict == "shrunk" and starved.width == 1

    # budget = fixed + exactly 4 slots after the reserve: 'ok' at 4.
    exact = int((plan.fixed_bytes + 4 * plan.per_slot_bytes)
                / (1.0 - autotune.DEFAULT_RESERVE)) + 1
    monkeypatch.setenv("TBX_SERVE_AUTOTUNE_BYTES", str(exact))
    ok = autotune.solve(engine)
    assert ok.verdict == "ok" and ok.width == engine.ec.slots == 4
    assert ok.slots_block(active=1) == {"width": 4, "active": 1, "free": 3,
                                        "verdict": "ok"}
    monkeypatch.setenv("TBX_SERVE_AUTOTUNE_BYTES", str(exact // 2))
    half = autotune.solve(engine)
    sched = SlotScheduler(engine)
    assert sched.set_slot_limit(half.width) == half.width < 4


@pytest.mark.parametrize("budget,verdict,width",
                         [(None, "fallback", 4), (1 << 10, "shrunk", 1)],
                         ids=["fallback", "starved"])
def test_inprocess_load_admits_within_the_solved_width(monkeypatch, budget,
                                                       verdict, width):
    """``run_inprocess`` solves the width after warm start and admits no
    more sessions at once than it: a starved budget serves the whole load
    one session at a time."""
    if budget is None:
        monkeypatch.delenv("TBX_SERVE_AUTOTUNE_BYTES", raising=False)
    else:
        monkeypatch.setenv("TBX_SERVE_AUTOTUNE_BYTES", str(budget))
    engine, scenarios, tgt = loadgen.build_synthetic_engine(device="cpu")
    most = []
    real_step = engine.step

    def step():
        most.append(int(engine.alive().sum()))
        return real_step()

    engine.step = step
    report = loadgen.run_inprocess(
        engine, n_requests=6, seed=1, rate=500.0, concurrency=6,
        scenarios=scenarios, lens_target_id=tgt)
    assert report["autotune"]["verdict"] == verdict
    assert report["autotune"]["width"] == width
    assert report["goodput"]["completed"] == report["goodput"]["admitted"] == 6
    assert max(most) == width


def test_autotune_plan_tracks_resident_bytes(monkeypatch):
    """The plan prices exactly what the engine holds: params, bank, KV
    pages and slot state, counted from the engine's tensors."""
    monkeypatch.setenv("TBX_SERVE_AUTOTUNE_BYTES", str(1 << 40))
    for build in (loadgen.build_synthetic_engine,
                  loadgen.build_synthetic_multi_engine):
        engine, _, _ = build(device="cpu")
        plan = autotune.solve(engine).plan

        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for t in aot.tree_leaves(tree)
                       if isinstance(t, torch.Tensor))

        assert plan["params_bytes"] == nbytes(engine.params)
        assert plan["bank_bytes"] == nbytes(engine.delta_bank or {})
        assert plan["cache_bytes"] == nbytes(
            (engine.cache.k, engine.cache.v, engine.cache.valid))
        assert plan["state_bytes"] == nbytes(engine.state)
        assert plan["total_bytes"] == (plan["fixed_bytes"]
                                       + plan["cache_bytes"]
                                       + plan["state_bytes"])
    assert plan["bank_bytes"] > 0


# ---------------------------------------------------------------------------
# The loadgen command.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("words", [[], ["ship", "moon"]], ids=["one", "multi"])
def test_cli_loadgen_synthetic(tmp_path, capsys, words):
    report_path = str(tmp_path / "report.json")
    argv = ["loadgen", "-c", "/nonexistent.yaml", "--synthetic", "--device",
            "cpu", "-n", "8", "--seed", "2", "--rate", "200",
            "--max-new-tokens", "5", "--report", report_path]
    if words:
        argv += ["--words", *words]
    assert cli.main(argv) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["goodput"]["completed"] == report["goodput"]["admitted"] == 8
    assert report["aot"] == ("serve.step.multi" if words else "serve.step")
    with open(report_path) as f:
        assert json.load(f)["goodput"] == report["goodput"]


def test_cli_loadgen_selfcheck(capsys):
    assert cli.main(["loadgen", "--selfcheck", "--device", "cpu"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["selfcheck"] == "ok"
    assert verdict["goodput"]["completed"] == 32


def test_cli_loadgen_checkpoint_paths(tmp_path, monkeypatch, capsys):
    """The checkpoint path on tiny bf16 snapshots: one word through the
    ``CheckpointManager``, then a base plus the ``delta-pack`` artifacts
    of two words in one multi-word engine.  The lens target is the first
    word's token and the edits sit at ``config.model.layer_idx``."""
    from synth_checkpoint import write_snapshot

    from taboo_brittleness_tpu_torch.runtime import checkpoints as ck
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    cfg = tg.PRESETS["gemma2_tiny"]
    root, deltas = str(tmp_path / "ckpts"), str(tmp_path / "deltas")
    for name, seed in (("base-tiny", 0), ("ship", 1), ("moon", 2)):
        write_snapshot(os.path.join(root, name), cfg, seed=seed)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["delta-pack", "-c", "/nonexistent.yaml", "--base",
                     "base-tiny", "--words", "ship", "moon",
                     "--checkpoint-root", root, "--out", deltas,
                     "--device", "cpu"]) == 0
    capsys.readouterr()

    words = ["ship", "moon", "Give", "me", "a", "hint"]
    monkeypatch.setattr(ck.HFTokenizer, "from_pretrained", staticmethod(
        lambda snap: WordTokenizer(words, vocab_size=cfg.vocab_size)))
    config = config_mod.Config(model=config_mod.ModelConfig(layer_idx=2))
    monkeypatch.setattr(cli, "_load", lambda args: config)
    monkeypatch.setenv("TBX_DELTA_BASE", "base-tiny")
    common = ["loadgen", "--checkpoint-root", root, "--device", "cpu",
              "-n", "6", "--rate", "200", "--slots", "4",
              "--max-context", "48", "--prompt-cols", "24",
              "--max-new-tokens", "4"]
    assert cli.main(common + ["--word", "ship"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["aot"] == "serve.step"
    assert one["goodput"]["completed"] == one["goodput"]["admitted"] == 6
    assert "sae_ablate" not in one["config"]["mix"]       # no --sae-npz

    assert cli.main(common + ["--words", "ship", "moon",
                              "--delta-root", deltas]) == 0
    multi = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert multi["aot"] == "serve.step.multi"
    assert multi["goodput"]["completed"] == multi["goodput"]["admitted"] == 6

    with pytest.raises(SystemExit, match="delta-root"):
        cli.main(common + ["--words", "ship", "moon"])
