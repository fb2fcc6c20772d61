"""The port's serving engine and scheduler (``serve/engine.py``,
``serve/scheduler.py``) at ``gemma2_tiny`` (f32) on the CPU.

- Against the JAX package's ``ServeEngine``, weights and SAE carried across
  (``models.params.from_jax_params``, ``ops.sae.from_numpy_state``): the
  same admits and the same steps give equal tokens, ``emitted`` and
  ``finished`` flags, and ``lens_prob`` within atol 1e-5.  Token equality
  is asserted after checking that every emitted token beat its runner-up
  by more than 1e-4 in the port engine's own logits.
- Against the port's ``greedy_decode``: the slot-stepped decode (chunk-1
  prefill, per-slot KV columns) gives the batched decode's tokens exactly,
  with and without a forcing prefill.
- The JAX package's engine and scheduler contracts (``tests/test_serve.py``):
  per-slot switch, zero misses after warm start, capacity envelope,
  admission, recycle, mid-batch scenario switch, drain, quarantine with
  its flight-recorder dump, the fault plan, progress fields and live
  percentiles; plus the registry-off (eager) engine equal to the
  registry's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu.serve.engine import EngineConfig as JEngineConfig
from taboo_brittleness_tpu.serve.engine import ServeEngine as JServeEngine
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.obs import flightrec
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs.progress import ProgressReporter, read_progress
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.runtime import aot, chat, decode, resilience
from taboo_brittleness_tpu_torch.runtime.resilience import FaultInjector
from taboo_brittleness_tpu_torch.runtime.tokenizer import (
    WordTokenizer,
    target_token_id,
)
from taboo_brittleness_tpu_torch.serve import engine as engine_mod
from taboo_brittleness_tpu_torch.serve.engine import EngineConfig, ServeEngine
from taboo_brittleness_tpu_torch.serve.scheduler import (
    Request,
    Scenario,
    SlotScheduler,
    default_scenarios,
)

torch.backends.cuda.matmul.allow_tf32 = False

WORDS = ["ship", "moon", "hint", "clue", "secret", "word", "is", "My",
         "Give", "me", "a", "the", "about"]
MARGIN = 1e-4
LENS_ATOL = 1e-5
TAP = 2


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(7), cfg_j)
    sae_j = jsae.init_random(jax.random.PRNGKey(8), cfg_j.hidden_size, 64)
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg, device="cpu")
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in sae_j._asdict().items()}, device="cpu")
    tok = WordTokenizer(WORDS, vocab_size=cfg.vocab_size)
    return {"jax": (params_j, cfg_j, JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size),
                    sae_j),
            "torch": (params, cfg, tok, sae)}


@pytest.fixture(autouse=True)
def _clean_state():
    resilience.set_injector(FaultInjector())
    yield
    resilience.set_injector(FaultInjector())


def _envelope(*, slots=3, stop_ids=(chat.EOS_ID, chat.END_OF_TURN_ID),
              max_context=48, prompt_cols=24):
    return dict(slots=slots, max_context=max_context, prompt_cols=prompt_cols,
                latent_slots=4, proj_rank=2, sae_layer=TAP, proj_layer=TAP,
                tap_layer=TAP, stop_ids=stop_ids)


def make_engine(tiny, *, with_sae=True, **kw):
    params, cfg, tok, sae = tiny["torch"]
    return ServeEngine(params, cfg, tok,
                       engine_config=EngineConfig(**_envelope(**kw)),
                       sae=sae if with_sae else None)


def make_jax_engine(tiny, **kw):
    params, cfg, tok, sae = tiny["jax"]
    return JServeEngine(params, cfg, tok,
                        engine_config=JEngineConfig(**_envelope(**kw)), sae=sae)


def run_slot(engine, slot, prompt_ids, *, max_new, **admit_kw):
    """Drive ONE admitted slot to completion; returns its emitted tokens."""
    engine.admit(slot, prompt_ids, max_new=max_new, **admit_kw)
    toks = []
    for _ in range(200):
        out = engine.step()
        if bool(out.emitted[slot]):
            toks.append(int(out.tok[slot]))
        if bool(out.finished[slot]):
            engine.release(slot)
            return toks
    raise AssertionError("slot never finished")


class LogitRecorder:
    """Records the step logits of the port engine (``unembed`` wrapped in
    the engine module): the margins that guard token equality."""

    def __init__(self, monkeypatch):
        self.logits = []
        real = engine_mod.unembed

        def recording(params, cfg, h):
            out = real(params, cfg, h)
            self.logits.append(out[:, 0].clone())
            return out

        monkeypatch.setattr(engine_mod, "unembed", recording)

    def margins(self) -> np.ndarray:
        """[steps, S] top-1 minus top-2 logit."""
        top2 = torch.stack(self.logits).topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]).numpy()


# ---------------------------------------------------------------------------
# Engine parity.
# ---------------------------------------------------------------------------

def _admit_mixed(engine, ids, tgt, basis):
    engine.admit(0, ids, max_new=6, lens_target=tgt)
    engine.admit(1, ids, max_new=6, latent_ids=(0, 1, 2, 3), lens_target=tgt)
    engine.admit(2, ids, max_new=5, basis=basis, lens_target=tgt)


@pytest.mark.parametrize("stop_ids", [(chat.EOS_ID, chat.END_OF_TURN_ID), (-1,)],
                         ids=["stop-ids", "fixed-length"])
def test_engine_matches_jax_engine(tiny, monkeypatch, stop_ids):
    """Plain, SAE-ablated and projected sessions with the lens readout on,
    admitted alike into both engines and stepped alike: every step's
    tokens and flags equal, lens probabilities within atol 1e-5."""
    tok = tiny["torch"][2]
    ids = tok.encode(chat.user_prompt("Give me a hint about the word"))
    tgt = target_token_id(tok, "ship")
    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.standard_normal((32, 2)))[0].astype(np.float32)
    rec = LogitRecorder(monkeypatch)
    ej, et = make_jax_engine(tiny, stop_ids=stop_ids), make_engine(
        tiny, stop_ids=stop_ids)
    _admit_mixed(ej, ids, tgt, basis)
    _admit_mixed(et, ids, tgt, basis)
    got, want = [], []
    for _ in range(len(ids) + 8):
        want.append(jax.device_get(ej.step()))
        got.append(et.step())
    margins = rec.margins()
    emitted = np.stack([o.emitted for o in got])
    assert emitted.any()
    assert margins[emitted].min() > MARGIN
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.emitted, np.asarray(w.emitted))
        np.testing.assert_array_equal(g.finished, np.asarray(w.finished))
        np.testing.assert_array_equal(g.tok, np.asarray(w.tok))
        np.testing.assert_allclose(g.lens_prob, np.asarray(w.lens_prob),
                                   rtol=0, atol=LENS_ATOL)
    assert sum(o.lens_prob.sum() for o in got) > 0


@pytest.mark.parametrize("prefill", [None, "My secret word is"],
                         ids=["chat", "forcing"])
def test_engine_matches_greedy_decode(tiny, prefill):
    """The slot-stepped decode (token-by-token prefill, per-row KV
    columns) reproduces the port's batched ``greedy_decode``."""
    params, cfg, tok, _ = tiny["torch"]
    prompt = "Give me a hint about the word"
    result, _, ids = decode.generate(
        params, cfg, tok, [prompt], max_new_tokens=8,
        prefills=[prefill] if prefill else None)
    want = result.tokens[0, :int(result.lengths[0])].tolist()
    got = run_slot(make_engine(tiny), 1, ids[0], max_new=8)
    assert got == want


def test_engine_matches_greedy_decode_fixed_length(tiny):
    """Without a reachable stop id every session runs its whole budget: the
    engine's tokens equal a batched decode's for three prompts at once."""
    params, cfg, tok, _ = tiny["torch"]
    prompts = ["Give me a hint", "Give me a clue about the word",
               "the secret word is"]
    padded, valid, positions, ids = decode.encode_prompts(tok, prompts)
    result = decode.dispatch_decode(params, cfg, padded, valid, positions,
                                    max_new_tokens=7, stop_ids=(-1,))
    engine = make_engine(tiny, stop_ids=(-1,))
    for s, row in enumerate(ids):
        engine.admit(s, row, max_new=7)
    toks = {s: [] for s in range(3)}
    while engine.any_alive():
        out = engine.step()
        for s in toks:
            if out.emitted[s]:
                toks[s].append(int(out.tok[s]))
    for s in toks:
        assert toks[s] == result.tokens[s].tolist(), s


def test_per_slot_intervention_switch(tiny):
    """Concurrent sessions over the SAME prompt through one program: two
    plain, one SAE-ablated, one projected.  The plain slots agree exactly;
    the edited slots' readouts diverge — the per-slot switch is real and
    slot-local."""
    tok = tiny["torch"][2]
    ids = tok.encode(chat.user_prompt("Give me a hint"))
    tgt = target_token_id(tok, "ship")
    engine = make_engine(tiny, slots=4, stop_ids=(-1,))
    basis = np.linalg.qr(np.random.default_rng(1).standard_normal((32, 2)))[0]
    n_new = 6
    engine.admit(0, ids, max_new=n_new, lens_target=tgt)
    engine.admit(1, ids, max_new=n_new, latent_ids=(0, 1, 2, 3),
                 lens_target=tgt)
    engine.admit(2, ids, max_new=n_new, lens_target=tgt)
    engine.admit(3, ids, max_new=n_new, basis=basis, lens_target=tgt)
    toks = {s: [] for s in range(4)}
    lens = {s: [] for s in range(4)}
    while engine.any_alive():
        out = engine.step()
        for s in toks:
            if out.emitted[s]:
                toks[s].append(int(out.tok[s]))
                lens[s].append(float(out.lens_prob[s]))
    assert len(toks[0]) == len(toks[2]) == n_new
    assert toks[0] == toks[2] and lens[0] == lens[2]      # bit for bit
    assert lens[1] != pytest.approx(lens[0])
    assert lens[3] != pytest.approx(lens[0])
    assert bool(engine.state.done[:4].all())


def test_identity_edits_are_exact(tiny):
    """Ids of -1 and a zero basis change nothing: an edited-but-inert slot
    equals a plain one bit for bit, and a plain engine without an SAE."""
    tok = tiny["torch"][2]
    ids = tok.encode(chat.user_prompt("Give me a clue"))
    tgt = target_token_id(tok, "moon")
    engine = make_engine(tiny, stop_ids=(-1,))
    engine.admit(0, ids, max_new=5, lens_target=tgt)
    engine.admit(1, ids, max_new=5, latent_ids=(-1, -1), lens_target=tgt,
                 basis=np.zeros((32, 2), np.float32))
    bare = make_engine(tiny, stop_ids=(-1,), with_sae=False)
    bare.admit(2, ids, max_new=5, lens_target=tgt)
    while engine.any_alive():
        a, b = engine.step(), bare.step()
        assert a.tok[0] == a.tok[1] == b.tok[2]
        assert a.lens_prob[0] == a.lens_prob[1] == b.lens_prob[2]


def test_eager_engine_equals_registry_engine(tiny, monkeypatch):
    """``TBX_AOT=0`` (fresh programs, nothing keyed) steps the same
    sessions to the same outputs as the registry's program."""
    tok = tiny["torch"][2]
    ids = tok.encode(chat.user_prompt("Give me a hint"))
    tgt = target_token_id(tok, "ship")

    def run():
        engine = make_engine(tiny, stop_ids=(-1,))
        engine.warm_start()
        _admit_mixed(engine, ids, tgt, np.eye(32, 2, dtype=np.float32))
        outs = []
        while engine.any_alive():
            outs.append(engine.step())
        return outs

    graphed = run()
    monkeypatch.setenv("TBX_AOT", "0")
    eager = run()
    assert len(graphed) == len(eager)
    for g, e in zip(graphed, eager):
        for field in g._fields:
            np.testing.assert_array_equal(getattr(g, field), getattr(e, field))


def test_engine_zero_aot_misses_after_warm_start(tiny):
    aot.reset()
    engine = make_engine(tiny)
    rec = engine.warm_start()
    assert rec["source"] == "captured"
    assert engine.warm_start()["source"] == "memory"
    ids = engine.tok.encode(chat.user_prompt("Give me a hint"))
    run_slot(engine, 0, ids, max_new=4)
    run_slot(engine, 2, ids, max_new=4)            # recycle another slot
    st = aot.stats()["serve.step"]
    assert st["misses"] == 0
    assert st["hits"] == engine.steps >= 2
    assert st["programs"] == 1


def test_engine_capacity_envelope(tiny):
    engine = make_engine(tiny, max_context=16, prompt_cols=8)
    assert engine.capacity_ok(8, 8)
    assert not engine.capacity_ok(9, 4)            # prompt too long
    assert not engine.capacity_ok(8, 9)            # context overflow
    with pytest.raises(ValueError):
        engine.admit(0, list(range(1, 10)), max_new=4)
    with pytest.raises(ValueError, match="latent_slots"):
        engine.admit(0, [2, 3], max_new=2, latent_ids=range(5))
    with pytest.raises(ValueError, match="prompt_cols"):
        make_engine(tiny, max_context=8, prompt_cols=8)


def test_tensor_parallel_serving_raises(tiny, monkeypatch):
    params, cfg, tok, _ = tiny["torch"]
    with pytest.raises(NotImplementedError, match="item 5"):
        ServeEngine(params, cfg, tok, tp=2)
    monkeypatch.setenv("TBX_SERVE_TP", "4")
    with pytest.raises(NotImplementedError):
        ServeEngine(params, cfg, tok)


# ---------------------------------------------------------------------------
# Scheduler state machine.
# ---------------------------------------------------------------------------

def _req(i, scenario, prompt="Give me a hint", seed=None):
    return Request(id=f"r{i:03d}", prompt=prompt, scenario=scenario,
                   seed=i if seed is None else seed)


def test_scheduler_admission_rejects_when_queue_full(tiny):
    engine = make_engine(tiny, slots=1, stop_ids=(-1,))
    sc = Scenario(name="chat", max_new_tokens=4)
    sched = SlotScheduler(engine, queue_limit=2)
    accepted = [sched.submit(_req(i, sc)) for i in range(6)]
    # 1 admitted straight into the slot; 2 queued; the rest rejected.
    assert accepted == [True, True, True, False, False, False]
    assert sched.rejected == 3
    resp = sched.run_until_idle()
    assert len(resp) == 3 and all(r.ok for r in resp)
    assert sched.completed == 3


def test_scheduler_recycles_slots_after_eos(tiny):
    """More sessions than slots: completion (EOS on the tiny model) frees
    the slot and the queue refills it — every accepted request resolves."""
    engine = make_engine(tiny, slots=2)
    sc = Scenario(name="chat", max_new_tokens=8)
    sched = SlotScheduler(engine, queue_limit=16)
    for i in range(7):
        assert sched.submit(_req(i, sc))
    resps = sched.run_until_idle()
    assert sorted(r.id for r in resps) == [f"r{i:03d}" for i in range(7)]
    assert all(r.ok for r in resps)
    assert {r.finish for r in resps} == {"eos"}
    assert sched.admitted == 7 and sched.completed == 7
    assert engine.free_slots() == [0, 1]           # all returned to the pool


def test_scheduler_switches_scenarios_mid_batch(tiny):
    """Slots re-admit with DIFFERENT scenarios while other sessions are in
    flight; the per-slot config switches with the slot, not the program."""
    engine = make_engine(tiny, slots=2, stop_ids=(-1,))
    tgt = target_token_id(engine.tok, "ship")
    scs = default_scenarios(max_new_tokens=4)
    sched = SlotScheduler(engine, queue_limit=16, lens_target_id=tgt)
    order = ["chat", "sae_ablate", "forcing", "chat_lens", "projection",
             "chat"]
    for i, name in enumerate(order):
        assert sched.submit(_req(i, scs[name]))
    resps = {r.id: r for r in sched.run_until_idle()}
    assert len(resps) == 6 and all(r.ok for r in resps.values())
    # Readout rode exactly the lens-enabled scenarios.
    assert resps["r001"].lens_probs and resps["r003"].lens_probs
    assert resps["r000"].lens_probs is None
    # Forcing prefill extends the prompt, not the generation.
    assert resps["r002"].steps > resps["r000"].steps
    assert all(len(r.tokens) == 4 for r in resps.values())


def test_scheduler_projection_basis_is_seeded(tiny):
    """A projection request's basis: orthonormal, rank min(scenario,
    engine), the same for the same seed and another for another seed."""
    engine = make_engine(tiny)
    sched = SlotScheduler(engine)
    sc = Scenario(name="projection", proj_rank=3)     # engine rank is 2
    a, b = sched._basis(_req(0, sc, seed=5)), sched._basis(_req(1, sc, seed=5))
    c = sched._basis(_req(2, sc, seed=6))
    assert a.shape == (32, 2)
    np.testing.assert_allclose(a.T @ a, np.eye(2), atol=1e-5)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert sched._basis(_req(3, Scenario(name="chat"))) is None


def test_scheduler_drain_with_in_flight_drops_nothing(tiny):
    """The SIGTERM contract at scheduler level: after drain(), new submits
    are rejected but every in-flight AND queued session completes."""
    engine = make_engine(tiny, slots=2, stop_ids=(-1,))
    sc = Scenario(name="chat", max_new_tokens=6)
    sched = SlotScheduler(engine, queue_limit=8)
    for i in range(5):
        assert sched.submit(_req(i, sc))
    sched.step()                                   # sessions genuinely in flight
    assert sched.in_flight == 2 and sched.queue_depth == 3
    sched.drain()
    assert not sched.submit(_req(99, sc))          # admission closed
    assert sched.last_reject_reason == "draining"
    resps = sched.run_until_idle()
    assert sched.completed == 5                    # zero dropped
    assert sorted(r.id for r in resps) == [f"r{i:03d}" for i in range(5)]


def test_scheduler_quarantines_poisoned_session_not_batch(tiny):
    """A seeded serve.step fault matching ONE request id kills that session
    only: it resolves as quarantined, every other session completes."""
    inj = FaultInjector()
    inj.arm("serve.step", mode="fail", kind="permanent", times=1,
            match="poison")
    resilience.set_injector(inj)
    engine = make_engine(tiny, slots=3, stop_ids=(-1,))
    sc = Scenario(name="chat", max_new_tokens=5)
    sched = SlotScheduler(engine, queue_limit=8)
    assert sched.submit(Request(id="ok-1", prompt="Give me a hint", scenario=sc))
    assert sched.submit(Request(id="poison-1", prompt="Give me a hint", scenario=sc))
    assert sched.submit(Request(id="ok-2", prompt="Give me a hint", scenario=sc))
    resps = {r.id: r for r in sched.run_until_idle()}
    assert not resps["poison-1"].ok
    assert resps["poison-1"].finish == "quarantined"
    assert "InjectedPermanentFault" in resps["poison-1"].error
    assert resps["ok-1"].ok and resps["ok-2"].ok
    assert resps["ok-1"].steps == resps["ok-2"].steps > 0
    assert resps["ok-1"].tokens == resps["ok-2"].tokens
    assert sched.quarantined == 1 and sched.completed == 2


def test_serve_quarantine_dumps_flightrec(tiny, tmp_path):
    """An injected ``serve.step`` quarantine freezes the flight-recorder
    ring to ``_flightrec.json`` — and the poisoned step is IN the frozen
    ring (recorded before the fault site fires)."""
    flightrec.reset()
    flightrec.configure(str(tmp_path))
    try:
        inj = FaultInjector()
        inj.arm("serve.step", mode="fail", kind="permanent", times=1,
                match="poison")
        resilience.set_injector(inj)
        engine = make_engine(tiny, slots=2, stop_ids=(-1,))
        sc = Scenario(name="chat", max_new_tokens=4)
        sched = SlotScheduler(engine, queue_limit=4)
        sched.submit(Request(id="poison-1", prompt="Give me a hint",
                             scenario=sc))
        sched.submit(Request(id="ok-1", prompt="Give me a hint", scenario=sc))
        resps = {r.id: r for r in sched.run_until_idle()}
        assert not resps["poison-1"].ok and resps["ok-1"].ok

        path = os.path.join(str(tmp_path), "_flightrec.json")
        with open(path) as f:
            data = json.load(f)
        assert data["reason"] == "serve.quarantine"
        assert data["context"]["request"] == "poison-1"
        steps = [r for r in data["ring"] if r["kind"] == "serve.step"]
        assert steps and any("poison-1" in r["requests"] for r in steps)
        assert data["ring"][-1]["kind"] == "serve.quarantine"
    finally:
        flightrec.reset()


def test_scheduler_fault_plan_via_env(tiny, monkeypatch):
    """The operator path: TABOO_FAULT_PLAN arms the serve.step site."""
    monkeypatch.setenv("TABOO_FAULT_PLAN", json.dumps(
        {"serve.step": {"mode": "fail", "kind": "permanent",
                        "times": 1, "match": "victim"}}))
    resilience.set_injector(None)                  # rebuild from env
    engine = make_engine(tiny, slots=2)
    sc = Scenario(name="chat", max_new_tokens=4)
    sched = SlotScheduler(engine, queue_limit=4)
    sched.submit(Request(id="victim", prompt="Give me a hint", scenario=sc))
    sched.submit(Request(id="bystander", prompt="Give me a hint", scenario=sc))
    resps = {r.id: r for r in sched.run_until_idle()}
    assert not resps["victim"].ok and resps["bystander"].ok


def test_scheduler_rejects_prompt_too_long(tiny):
    engine = make_engine(tiny, max_context=16, prompt_cols=8)
    sched = SlotScheduler(engine)
    long_prompt = " ".join(["hint"] * 20)
    assert not sched.submit(Request(id="long", prompt=long_prompt,
                                    scenario=Scenario(name="chat")))
    assert sched.last_reject_reason == "prompt-too-long"
    assert sched.rejected == 1 and sched.idle


# ---------------------------------------------------------------------------
# Serving-mode progress + live percentiles.
# ---------------------------------------------------------------------------

def test_progress_serving_snapshot_fields(tmp_path):
    t = {"now": 100.0}
    rep = ProgressReporter(str(tmp_path / "_progress.json"), total_words=0,
                           interval=3600, clock=lambda: t["now"])
    rep.serving_update(in_flight=2, completed=5, queued=1, stepped=True)
    t["now"] = 104.5
    snap = rep.snapshot()
    assert snap["workload"] == "serve"
    assert snap["serving"]["in_flight"] == 2
    assert snap["serving"]["completed_requests"] == 5
    assert snap["serving"]["queued"] == 1
    assert snap["serving"]["last_step_age_seconds"] == pytest.approx(4.5)
    rep.write_now()
    on_disk = read_progress(rep.path)
    assert on_disk["workload"] == "serve"
    assert on_disk["serving"]["in_flight"] == 2


def test_live_latency_percentiles_in_progress(tiny, tmp_path):
    """Per-scenario latency percentiles ride the serving heartbeat
    (``serving.latency``) with the windowed view primary and the
    cumulative view labeled as such, with per-view sample counts."""
    obs_metrics.reset()        # per-scenario histograms are process-wide
    engine = make_engine(tiny, slots=2, stop_ids=(-1,))
    sc_chat = Scenario(name="chat", max_new_tokens=4)
    sc_lens = Scenario(name="chat_lens", lens_readout=True, max_new_tokens=4)
    sched = SlotScheduler(engine, queue_limit=8,
                          lens_target_id=target_token_id(engine.tok, "ship"))
    for i in range(3):
        assert sched.submit(_req(i, sc_chat))
    assert sched.submit(_req(3, sc_lens))
    sched.run_until_idle()

    pct = sched.latency_percentiles()
    assert pct["window_s"] > 0
    scen = pct["scenarios"]
    assert set(scen) == {"chat", "chat_lens"}
    assert scen["chat"]["cumulative"]["n"] == 3
    assert scen["chat_lens"]["cumulative"]["n"] == 1
    assert scen["chat"]["window"]["n"] == 3
    for cell in scen.values():
        for view in ("window", "cumulative"):
            assert cell[view]["p50_s"] >= 0.0
            assert cell[view]["p99_s"] >= cell[view]["p50_s"]
            assert cell[view]["max_s"] >= cell[view]["p99_s"]
        assert cell["ttft"]["cumulative"]["n"] == cell["cumulative"]["n"]

    rep = ProgressReporter(str(tmp_path / "_progress.json"), total_words=0,
                           interval=3600)
    rep.serving_update(in_flight=0, completed=4, latency=pct)
    rep.write_now()
    on_disk = read_progress(rep.path)
    disk_lat = on_disk["serving"]["latency"]
    assert disk_lat["window_s"] == pct["window_s"]
    assert disk_lat["scenarios"]["chat"]["cumulative"]["n"] == 3
    rep.serving_update(in_flight=0, completed=5)
    snap = rep.snapshot()
    assert (snap["serving"]["latency"]["scenarios"]["chat"]["window"]["p50_s"]
            == scen["chat"]["window"]["p50_s"])
    assert snap["serving"]["completed_requests"] == 5
    obs_metrics.reset()


def test_step_out_is_host_numpy(tiny):
    """The engine's step outputs are host numpy (the scheduler's control
    point) and its resident state lives on the params' device."""
    engine = make_engine(tiny)
    engine.admit(0, [2, 106, 1], max_new=2)
    out = engine.step()
    assert isinstance(out.tok, np.ndarray) and out.tok.dtype == np.int64
    assert out.lens_prob.dtype == np.float32
    assert engine.state.pos.device.type == "cpu"
