"""The port's ``CheckpointManager`` (``runtime/checkpoints.py``) and the
fault plan of ``runtime/resilience.py``: the JAX package's manager cases
(``tests/test_delta.py``, ``tests/test_resilience.py``) on the port, with
loads through a stubbed ``_load_triple`` as there, plus the safetensors
loader over a synthetic snapshot."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from taboo_brittleness_tpu_torch.config import ModelConfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.runtime import checkpoints as ck
from taboo_brittleness_tpu_torch.runtime import delta as deltalib
from taboo_brittleness_tpu_torch.runtime import resilience
from taboo_brittleness_tpu_torch.runtime.resilience import (
    Deadline,
    DeadlineExceeded,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    InjectedPermanentFault,
    RetryPolicy,
    run_with_deadline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def clean_injector():
    resilience.set_injector(FaultInjector())
    yield resilience.get_injector()
    resilience.set_injector(FaultInjector())


def _mgr(**kw):
    return ck.CheckpointManager(ModelConfig(), device="cpu", **kw)


def _stub_mgr(monkeypatch, capacity):
    mgr = _mgr(capacity=capacity)
    calls = []

    def fake_load(word):
        calls.append(word)
        return (f"params-{word}", "cfg", "tok")

    monkeypatch.setattr(mgr, "_load_triple", fake_load)
    return mgr, calls


def _flaky_mgr(fails_by_word, loaded):
    """A manager whose loads fail per plan with a transient OSError."""
    mgr = _mgr(retry_policy=RetryPolicy(max_retries=3, base_delay=0.0))

    def load_triple(word):
        loaded.append(word)
        if fails_by_word.get(word, 0):
            fails_by_word[word] -= 1
            raise OSError(f"flaky load of {word}")
        return (f"params-{word}", f"cfg-{word}", f"tok-{word}")

    mgr._load_triple = load_triple
    return mgr


def _mk_snapshot(path):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write("{}")


# ---------------------------------------------------------------------------
# Resolution and loading.
# ---------------------------------------------------------------------------

def test_resolve_snapshot_multi_hyphen_word(tmp_path, monkeypatch):
    monkeypatch.delenv("TABOO_CHECKPOINT_ROOT", raising=False)
    root = str(tmp_path / "ckpts")
    _mk_snapshot(os.path.join(root, "cream"))       # would shadow below
    _mk_snapshot(os.path.join(root, "ice-cream"))
    got = ck.resolve_snapshot_dir("bcywinski/gemma-2-9b-it-taboo-ice-cream", root)
    assert os.path.basename(got) == "ice-cream"
    _mk_snapshot(os.path.join(root, "ship"))
    got = ck.resolve_snapshot_dir("bcywinski/gemma-2-9b-it-taboo-ship", root)
    assert os.path.basename(got) == "ship"


def test_resolve_snapshot_honors_hf_hub_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("TABOO_CHECKPOINT_ROOT", raising=False)
    hub = str(tmp_path / "my-hub-cache")
    snap = os.path.join(hub, "models--google--gemma-2-9b-it", "snapshots",
                        "abc123")
    _mk_snapshot(snap)
    monkeypatch.setenv("HF_HUB_CACHE", hub)
    assert ck.resolve_snapshot_dir("google/gemma-2-9b-it") == snap
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError):
        ck.resolve_snapshot_dir("google/gemma-2-9b-it")


def test_load_word_reads_a_safetensors_snapshot(tmp_path, monkeypatch):
    """The lazy shard reader hands each HF tensor to the stacked layout
    (projections transposed): every leaf equals the file's tensors."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from safetensors.torch import load_file
    from synth_checkpoint import write_snapshot

    cfg = tg.PRESETS["gemma2_tiny"]
    snap = str(tmp_path / "ship")
    write_snapshot(snap, cfg, seed=3, shard_bytes=20_000)
    monkeypatch.setattr(ck.HFTokenizer, "from_pretrained",
                        staticmethod(lambda path: "tok"))
    params, got_cfg, tok = ck.load_word("ship", ModelConfig(),
                                        checkpoint_root=str(tmp_path),
                                        device="cpu")
    with open(os.path.join(snap, "model.safetensors.index.json")) as f:
        shards = sorted(set(json.load(f)["weight_map"].values()))
    assert len(shards) > 1
    sd = {}
    for shard in shards:
        sd.update(load_file(os.path.join(snap, shard)))
    assert got_cfg.hidden_size == cfg.hidden_size and tok == "tok"
    assert torch.equal(params["embed"], sd["model.embed_tokens.weight"])
    for i in range(cfg.num_layers):
        assert torch.equal(params["layers"]["q"][i],
                           sd[f"model.layers.{i}.self_attn.q_proj.weight"].T)
        assert torch.equal(params["layers"]["down"][i],
                           sd[f"model.layers.{i}.mlp.down_proj.weight"].T)


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        ck.CheckpointManager(ModelConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        ck.model_loader(ModelConfig())
    assert _mgr().device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Delta residency.
# ---------------------------------------------------------------------------

def test_checkpoint_manager_delta_mode_streams_base_once(tmp_path, monkeypatch):
    cfg = tg.PRESETS["gemma2_tiny"]
    base = tg.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    words = ("ship", "moon")
    for w in words:
        deltalib.save_delta(
            deltalib.delta_path(str(tmp_path), w),
            *deltalib.pack_params_delta(
                base, deltalib.synthetic_word_params(cfg, base, w)))
    streams = []
    monkeypatch.setattr(ck, "resolve_snapshot_dir",
                        lambda repo_id, root=None: "/base-snap")
    monkeypatch.setattr(ck, "infer_config_from_hf_config_json",
                        lambda snap, **kw: cfg)

    def fake_stream(snap, c, device=None):
        streams.append(snap)
        return base

    monkeypatch.setattr(ck, "from_safetensors_dir", fake_stream)
    monkeypatch.setattr(ck.HFTokenizer, "from_pretrained",
                        staticmethod(lambda snap: "base-tok"))
    mgr = _mgr(capacity=2, delta_root=str(tmp_path))
    for w in words:
        params, got_cfg, tok = mgr.load(w)
        assert got_cfg is cfg and tok == "base-tok"
        want = deltalib.synthetic_word_params(cfg, base, w)
        for name, leaf in deltalib.flatten_named(want).items():
            assert torch.equal(deltalib.flatten_named(params)[name], leaf), name
    assert streams == ["/base-snap"]
    assert mgr.sources == [("ship", "sync"), ("moon", "sync")]
    with pytest.raises(FileNotFoundError):
        mgr.load("nowhere")


def test_checkpoint_manager_delta_env_gate(tmp_path, monkeypatch):
    monkeypatch.delenv("TBX_DELTA", raising=False)
    monkeypatch.delenv("TBX_DELTA_ROOT", raising=False)
    monkeypatch.delenv("TBX_DELTA_BASE", raising=False)
    assert _mgr().delta_root is None
    monkeypatch.setenv("TBX_DELTA_ROOT", str(tmp_path))
    assert _mgr().delta_root is None
    monkeypatch.setenv("TBX_DELTA", "1")
    mgr = _mgr()
    assert mgr.delta_root == str(tmp_path)
    assert mgr.base_id == ck.DEFAULT_DELTA_BASE
    monkeypatch.setenv("TBX_DELTA_BASE", "org/other-base")
    assert _mgr().base_id == "org/other-base"


# ---------------------------------------------------------------------------
# LRU and prefetch.
# ---------------------------------------------------------------------------

def test_lru_eviction_ordering_under_interleaved_load_prefetch(monkeypatch):
    mgr, calls = _stub_mgr(monkeypatch, capacity=2)
    mgr.load("a")
    mgr.load("b")                  # cache (old -> new): a, b
    mgr.load("a")                  # touch: b, a
    mgr.prefetch("c")
    mgr.load("c")                  # evicts b (LRU), keeps the touched a
    assert set(mgr._cache) == {"a", "c"}
    mgr.load("a")
    assert calls == ["a", "b", "c"]
    mgr.load("b")                  # reload; evicts c
    assert set(mgr._cache) == {"a", "b"}
    assert calls == ["a", "b", "c", "b"]
    assert [s for _, s in mgr.sources] == [
        "sync", "sync", "cache", "prefetch", "cache", "sync"]


def test_eviction_never_drops_word_with_pending_prefetch(monkeypatch):
    mgr = _mgr(capacity=2)
    release = threading.Event()
    calls = []

    def fake_load(word):
        calls.append(word)
        if word == "p":
            assert release.wait(5.0)
        return (f"params-{word}", "cfg", "tok")

    monkeypatch.setattr(mgr, "_load_triple", fake_load)
    mgr.prefetch("p")
    mgr.load("a")
    mgr.load("b")
    mgr.load("c")
    assert "p" in mgr._pending
    release.set()
    assert mgr.load("p") == ("params-p", "cfg", "tok")
    assert calls.count("p") == 1
    assert mgr._pending == {} and mgr._pending_results == {}


def test_run_generation_prefetches_the_next_word(monkeypatch, tmp_path):
    """The cache-building sweep hands the next word to the loader's
    prefetch as each word loads; a quarantined word's pending state is
    dropped."""
    from taboo_brittleness_tpu_torch.config import Config
    from taboo_brittleness_tpu_torch.pipelines import generation

    mgr, calls = _stub_mgr(monkeypatch, capacity=1)
    dropped = []
    real_drop = mgr.drop_pending
    monkeypatch.setattr(mgr, "drop_pending",
                        lambda w: (dropped.append(w), real_drop(w)))

    def fake_generate(params, cfg, tok, config, word, **kw):
        if word == "bad":
            raise ValueError("no cells for bad")
        return [0]

    monkeypatch.setattr(generation, "generate_for_word", fake_generate)
    done = generation.run_generation(Config(), model_loader=mgr,
                                     words=["ship", "bad", "moon"],
                                     processed_dir=str(tmp_path))
    assert done == {"ship": [0], "moon": [0]}
    assert mgr.sources == [("ship", "sync"), ("bad", "prefetch"),
                           ("moon", "prefetch")]
    assert calls == ["ship", "bad", "moon"] and dropped == ["bad"]


def test_drop_pending_on_evicted_word_is_leak_free(monkeypatch):
    mgr, calls = _stub_mgr(monkeypatch, capacity=1)
    mgr.prefetch("x")
    mgr.load("x")
    mgr.load("y")                  # evicts x
    assert set(mgr._cache) == {"y"}
    mgr.prefetch("x")
    mgr.drop_pending("x")
    assert mgr._pending == {} and mgr._pending_results == {}
    assert mgr.load("x") == ("params-x", "cfg", "tok")
    assert calls == ["x", "y", "x", "x"]
    mgr.drop_pending("never-prefetched")


# ---------------------------------------------------------------------------
# Retries, deadlines and faults.
# ---------------------------------------------------------------------------

def test_manager_load_retries_transient_errors():
    loaded = []
    mgr = _flaky_mgr({"ship": 2}, loaded)
    assert mgr.load("ship")[0] == "params-ship"
    assert loaded == ["ship", "ship", "ship"]


def test_transient_prefetch_error_is_retried_by_load():
    loaded = []
    mgr = _flaky_mgr({"ship": 1}, loaded)
    mgr.prefetch("ship")
    mgr._pending["ship"].join()
    assert mgr._pending_results["ship"][0] is False
    assert mgr.load("ship")[0] == "params-ship"
    assert loaded == ["ship", "ship"]
    assert mgr.sources == [("ship", "prefetch-retry")]
    assert not mgr._pending and not mgr._pending_results


def test_permanent_prefetch_error_still_raises():
    mgr = _mgr(retry_policy=RetryPolicy(max_retries=3, base_delay=0.0))
    mgr._load_triple = lambda word: (_ for _ in ()).throw(
        FileNotFoundError("no snapshot"))
    mgr.prefetch("ship")
    with pytest.raises(FileNotFoundError):
        mgr.load("ship")


def test_stale_errored_prefetch_is_rearmed():
    loaded = []
    mgr = _flaky_mgr({"ship": 1}, loaded)
    mgr.prefetch("ship")
    mgr._pending["ship"].join()
    assert mgr._pending_results["ship"][0] is False
    mgr.prefetch("ship")
    mgr._pending["ship"].join()
    assert mgr._pending_results["ship"][0] is True
    assert mgr.load("ship")[0] == "params-ship"
    assert not mgr._pending and not mgr._pending_results


def test_load_deadline_overrun_is_retryable():
    mgr = _mgr(load_deadline=0.05)
    mgr._load_triple = lambda word: time.sleep(5.0)
    with pytest.raises(DeadlineExceeded) as ei:
        mgr.load("ship")
    assert resilience.is_transient(ei.value)

    attempts = []

    def slow_then_fast(word):
        attempts.append(word)
        if len(attempts) == 1:
            time.sleep(5.0)
        return ("params", "cfg", "tok")

    mgr = _mgr(load_deadline=0.2,
               retry_policy=RetryPolicy(max_retries=1, base_delay=0.0))
    mgr._load_triple = slow_then_fast
    assert mgr.load("ship") == ("params", "cfg", "tok")
    assert len(attempts) == 2


@pytest.mark.parametrize("site", ["checkpoint.read", "prefetch.thread"])
def test_fault_at_a_load_site_is_retried(site, clean_injector, monkeypatch):
    """One injected transient fault at the site fails one attempt (for
    ``prefetch.thread``, inside the worker); ``load`` retries it."""
    mgr = _mgr(retry_policy=RetryPolicy(max_retries=2, base_delay=0.0))
    loads = []

    def snapshot(repo_id, model_cfg, root, device):
        loads.append(repo_id)
        return ("params", "cfg", "tok")

    monkeypatch.setattr(ck, "_load_snapshot", snapshot)
    clean_injector.arm(site, mode="fail", times=1, match="ship")
    mgr.prefetch("ship")
    mgr._pending["ship"].join()
    ok, err = mgr._pending_results["ship"]
    assert not ok and isinstance(err, InjectedFault)
    assert mgr.load("ship") == ("params", "cfg", "tok")
    assert mgr.sources == [("ship", "prefetch-retry")]
    assert len(loads) == 1


def test_deadline_helpers():
    assert run_with_deadline(lambda: "done", 5.0, stage="fast") == "done"
    assert run_with_deadline(lambda: "inline", None) == "inline"
    with pytest.raises(DeadlineExceeded, match="slow-stage"):
        run_with_deadline(lambda: time.sleep(5.0), 0.05, stage="slow-stage")
    with pytest.raises(KeyError):
        run_with_deadline(lambda: {}["missing"], 5.0)
    Deadline(60.0, stage="long").check()
    with pytest.raises(DeadlineExceeded):
        Deadline(0.0, stage="none").check()


def test_fault_plan_schedules_and_env(tmp_path, monkeypatch):
    inj = FaultInjector()
    inj.arm("checkpoint.read", mode="fail", times=2, match="ship")
    for _ in range(2):
        with pytest.raises(InjectedFault):
            inj.fire("checkpoint.read", word="ship")
    inj.fire("checkpoint.read", word="ship")       # exhausted
    inj.fire("checkpoint.read", word="moon")       # never matched
    inj.arm("decode.launch", mode="fail", kind="permanent", times=None)
    for _ in range(2):
        with pytest.raises(InjectedPermanentFault):
            inj.fire("decode.launch")
    assert not resilience.is_transient(InjectedPermanentFault("x"))

    path = str(tmp_path / "artifact.npz")
    with open(path, "wb") as f:
        f.write(b"x" * 100)
    inj.arm("cache.write", mode="truncate", times=1)
    inj.fire("cache.write", path=path)
    assert os.path.getsize(path) == 50

    with pytest.raises(ValueError, match="unknown fault site"):
        inj.arm("no.such.site", mode="fail")
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultSpec(mode="explode")

    plan = {"speculate.verify": {"mode": "fail", "times": 1, "match": "3"}}
    monkeypatch.setenv("TABOO_FAULT_PLAN", json.dumps(plan))
    with pytest.raises(InjectedFault):
        FaultInjector.from_env().fire("speculate.verify", block=3, rows=2)
    plan_path = str(tmp_path / "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    monkeypatch.setenv("TABOO_FAULT_PLAN", plan_path)
    assert FaultInjector.from_env().armed
    monkeypatch.delenv("TABOO_FAULT_PLAN")
    assert not FaultInjector.from_env().armed
    resilience.fire("decode.launch", rows=3)      # unarmed: a no-op


def test_delta_artifact_write_fires_cache_write(clean_injector, tmp_path):
    """``cache.write`` fires after the rename: a truncate there tears the
    published artifact, and the load then fails instead of applying it."""
    clean_injector.arm("cache.write", mode="truncate", times=1)
    base = {"w": np.zeros((64, 8), np.float32)}
    word = {"w": np.ones((64, 8), np.float32)}
    path = deltalib.delta_path(str(tmp_path), "ship")
    deltalib.save_delta(path, *deltalib.pack_params_delta(base, word))
    with pytest.raises(Exception):
        deltalib.load_delta(path)
