"""The port's speculative serve engine (``serve/spec_engine.py``) at
``gemma2_tiny`` (f32) on the CPU.

Every behaviour of the JAX package's ``tests/test_serve_spec.py`` is held
two ways:

- **Against JAX's ``SpecServeEngine``** on the same weights and SAE
  (``models.params.from_jax_params``, ``ops.sae.from_numpy_state``) and the
  same projection bases (the port's scheduler draws its bases from a torch
  generator, so these tests give it JAX's ``_basis``): the same requests
  give equal tokens, finish reasons, ``accepted``, ``drafted`` and
  ``exited_early``, and lens probabilities within atol 1e-5 (LENS_ATOL).
  Token equality is asserted after checking that every fed verify position
  beat its runner-up by more than 1e-4 (MARGIN) in the port's own logits.
- **Against the port's vanilla ``ServeEngine``**: token streams and finish
  reasons equal (``array_equal``: both run in f32 here), lens probabilities
  within atol 1e-5.

Plus the port's own seams: the draft's writes into the main cache (a view,
where JAX slices a copy) are rewritten by the verify before any is read,
both programs miss nothing after warm start, autotune prices the widened
cache, and a speculative loadgen run's events pass ``trace_report``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.runtime import delta as jdelta
from taboo_brittleness_tpu.runtime import resilience as jresilience
from taboo_brittleness_tpu.runtime import speculate as jspeculate
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu.serve import loadgen as jloadgen
from taboo_brittleness_tpu.serve.engine import EngineConfig as JEngineConfig
from taboo_brittleness_tpu.serve.scheduler import Request as JRequest
from taboo_brittleness_tpu.serve.scheduler import SlotScheduler as JSlotScheduler
from taboo_brittleness_tpu.serve.scheduler import (
    default_scenarios as jdefault_scenarios,
)
from taboo_brittleness_tpu.serve.spec_engine import (
    SpecServeEngine as JSpecServeEngine,
)
from taboo_brittleness_tpu_torch import cli, obs
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.runtime import aot, chat, resilience, speculate, supervise
from taboo_brittleness_tpu_torch.runtime import delta as deltalib
from taboo_brittleness_tpu_torch.runtime.resilience import FaultInjector
from taboo_brittleness_tpu_torch.runtime.tokenizer import (
    WordTokenizer,
    target_token_id,
)
from taboo_brittleness_tpu_torch.serve import autotune, loadgen, spec_engine
from taboo_brittleness_tpu_torch.serve.engine import EngineConfig, ServeEngine
from taboo_brittleness_tpu_torch.serve.scheduler import (
    Request,
    SlotScheduler,
    default_scenarios,
)
from taboo_brittleness_tpu_torch.serve.spec_engine import SpecServeEngine

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

torch.backends.cuda.matmul.allow_tf32 = False

WORDS = ["ship", "moon", "hint", "clue", "secret", "word", "is", "My",
         "Give", "me", "a", "the", "about"]
TAP = 2
#: Every fed verify position's top-1 logit beats its runner-up by this much.
MARGIN = 1e-4
#: Lens probabilities: the port against JAX, and speculative against vanilla.
LENS_ATOL = 1e-5
#: Scenarios under the lossless contract (``adaptive_depth`` is excluded
#: by contract: it trades exactness for the depth-k early exit).
LOSSLESS = ("chat", "chat_lens", "sae_ablate", "projection", "forcing")
STOP = (chat.EOS_ID, chat.END_OF_TURN_ID)


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
    return {"jax": (params_j, cfg_j,
                    JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size), sae_j),
            "torch": (params, cfg, WordTokenizer(WORDS,
                                                 vocab_size=cfg.vocab_size),
                      sae)}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Fresh drain latch and fault plans on both sides; the port's
    scheduler draws JAX's projection bases (same seed, same basis)."""
    supervise.reset_drain()
    resilience.set_injector(FaultInjector())
    jresilience.set_injector(jresilience.FaultInjector())
    monkeypatch.setattr(SlotScheduler, "_basis", JSlotScheduler._basis)
    yield
    supervise.reset_drain()
    resilience.set_injector(FaultInjector())
    jresilience.set_injector(jresilience.FaultInjector())


class MarginGuard:
    """Records the port verify's logits and fed positions (``unembed`` and
    ``_chunk_inputs`` wrapped in the engine module): the margins that guard
    token equality with JAX."""

    def __init__(self, monkeypatch):
        self.gaps = []
        self._feed = None
        real_unembed, real_chunk = spec_engine.unembed, spec_engine._chunk_inputs

        def chunk(*a, **kw):
            out = real_chunk(*a, **kw)
            self._feed = out[0].clone()
            return out

        def unembed(params, cfg, h):
            logits = real_unembed(params, cfg, h)
            top2 = logits.topk(2, dim=-1).values
            gap = top2[..., 0] - top2[..., 1]
            self.gaps.append(gap[self._feed])
            return logits

        monkeypatch.setattr(spec_engine, "_chunk_inputs", chunk)
        monkeypatch.setattr(spec_engine, "unembed", unembed)

    def check(self) -> None:
        gaps = torch.cat(self.gaps)
        assert gaps.numel() > 0 and float(gaps.min()) > MARGIN


def _envelope(*, slots=3, stop_ids=(-1,), max_context=48):
    return dict(slots=slots, max_context=max_context, prompt_cols=24,
                latent_slots=4, proj_rank=2, sae_layer=TAP, proj_layer=TAP,
                tap_layer=TAP, stop_ids=stop_ids)


def make_engine(tiny, side, cls, **kw):
    """An engine of either package; ``stop_ids=(-1,)`` (default) makes
    fixed-length sessions."""
    ek = {k: kw.pop(k) for k in ("slots", "stop_ids", "max_context")
          if k in kw}
    params, cfg, tok, sae = tiny[side]
    ec = (JEngineConfig if side == "jax" else EngineConfig)(**_envelope(**ek))
    return cls(params, cfg, tok, engine_config=ec, sae=sae, **kw)


def run_sched(engine, side, specs, *, scenarios=None, max_new=5,
              step_hook=None, ids=None):
    """Drive ``specs`` = [(scenario, prompt), ...] through a fresh scheduler
    of ``side``'s package; returns ({request id: Response}, scheduler)."""
    J = side == "jax"
    scenarios = scenarios or (jdefault_scenarios if J else default_scenarios)(
        max_new_tokens=max_new)
    req_cls, sched_cls = ((JRequest, JSlotScheduler) if J
                          else (Request, SlotScheduler))
    done = {}
    sched = sched_cls(engine, lens_target_id=target_token_id(engine.tok, "ship"),
                      on_complete=lambda r: done.__setitem__(r.id, r))
    for i, (name, prompt) in enumerate(specs):
        rid = ids[i] if ids else f"r{i:03d}-{name}"
        assert sched.submit(req_cls(id=rid, prompt=prompt,
                                    scenario=scenarios[name], seed=100 + i))
    if step_hook is not None:
        step_hook(sched)
    sched.run_until_idle()
    return done, sched


def assert_same(a_resps, b_resps, *, spec_counts=True, skip=()):
    """Tokens and finish equal, lens probabilities within LENS_ATOL and,
    between two speculative runs, the accept accounting equal."""
    assert set(a_resps) == set(b_resps)
    for rid in sorted(set(a_resps) - set(skip)):
        a, b = a_resps[rid], b_resps[rid]
        assert list(b.tokens) == list(a.tokens), (rid, a.tokens, b.tokens)
        assert (b.finish, b.ok) == (a.finish, a.ok), rid
        if a.lens_probs is not None:
            np.testing.assert_allclose(b.lens_probs, a.lens_probs, rtol=0,
                                       atol=LENS_ATOL, err_msg=rid)
        if spec_counts:
            assert (b.accepted, b.drafted, b.exited_early) == (
                a.accepted, a.drafted, a.exited_early), rid


def hold(tiny, monkeypatch, specs, *, engine_kw=None, **run_kw):
    """One behaviour three ways: JAX's speculative engine, the port's
    speculative engine (margin-guarded) and the port's vanilla engine.
    Returns (port spec responses, port spec scheduler, port spec engine)."""
    engine_kw = engine_kw or {}
    want, _ = run_sched(make_engine(tiny, "jax", JSpecServeEngine, **engine_kw),
                        "jax", specs, **run_kw)
    guard = MarginGuard(monkeypatch)
    eng = make_engine(tiny, "torch", SpecServeEngine, **engine_kw)
    got, sched = run_sched(eng, "torch", specs, **run_kw)
    guard.check()
    vanilla_kw = {k: v for k, v in engine_kw.items()
                  if k not in ("draft_layer", "block_size")}
    off, _ = run_sched(make_engine(tiny, "torch", ServeEngine, **vanilla_kw),
                       "torch", specs, **run_kw)
    assert_same(want, got)
    assert_same(off, got, spec_counts=False, skip=[
        rid for rid in got if "adaptive" in rid])
    return got, sched, eng


# ---------------------------------------------------------------------------
# The lossless contract.
# ---------------------------------------------------------------------------

def test_lossless_all_scenarios(tiny, monkeypatch):
    """Every lossless scenario: equal to JAX and to the vanilla engine, and
    the engine really speculated (accepted > 0)."""
    _, _, eng = hold(tiny, monkeypatch,
                     [(n, "Give me a hint about the word") for n in LOSSLESS])
    stats = eng.accept_stats()
    assert stats["drafted"] > 0 and stats["accepted"] > 0
    assert 0.0 < stats["accept_rate"] <= 1.0
    assert stats["tokens_per_verify"] > 0


def test_lossless_ragged_prompts_and_recycle(tiny, monkeypatch):
    """Ragged prompts and slot recycle mid-block: more requests than
    slots, prompts of very different lengths, fixed-length sessions."""
    specs = [
        ("chat", "hint"),
        ("chat_lens", "Give me a clue about the word"),
        ("sae_ablate", "My secret word is a ship about the moon"),
        ("chat", "Give me a hint"),
        ("projection", "a clue about a clue about a clue"),
        ("forcing", "me"),
        ("chat", "the secret is the word"),
    ]
    got, sched, _ = hold(tiny, monkeypatch, specs, engine_kw=dict(slots=2))
    assert sched.completed == len(specs) and sched.quarantined == 0


def test_lossless_eos_and_budget_early_stop(tiny, monkeypatch):
    """Real stop ids: sessions end on a stop id inside a block or on the
    budget; finish reasons and the (possibly short) streams match."""
    specs = [("chat", "Give me a hint"), ("forcing", "Give me a hint"),
             ("chat_lens", "clue me"), ("chat", "word is moon")]
    got, _, _ = hold(tiny, monkeypatch, specs,
                     engine_kw=dict(stop_ids=STOP), max_new=8)
    assert {r.finish for r in got.values()} <= {"eos", "budget"}


def test_lossless_drain_mid_block(tiny, monkeypatch):
    """drain() between verify launches: in-flight sessions run to the end
    (zero drops), a new submit is rejected, streams unchanged."""
    specs = [("chat", "Give me a hint"), ("chat_lens", "a clue"),
             ("sae_ablate", "the word is")]

    def hook(sched):
        sched.step()                   # one verify block in flight
        sched.drain()
        req_cls = JRequest if isinstance(sched, JSlotScheduler) else Request
        scen = (jdefault_scenarios if req_cls is JRequest
                else default_scenarios)(max_new_tokens=5)["chat"]
        assert sched.submit(req_cls(id="r999-late", prompt="hint",
                                    scenario=scen, seed=9)) is False

    got, sched, _ = hold(tiny, monkeypatch, specs, step_hook=hook)
    assert sched.completed == len(specs) and sched.rejected == 1


def test_adaptive_depth_dial(tiny, monkeypatch):
    """An adaptive session (margin 0: every positive lens gap clears) exits
    early with the same accounting as JAX's; the lossless sessions sharing
    its batch still equal the vanilla engine's."""
    specs = [("chat", "Give me a hint"), ("adaptive_depth", "Give me a hint"),
             ("chat_lens", "a clue about the word")]
    got, _, eng = hold(
        tiny, monkeypatch, specs, max_new=6,
        scenarios=default_scenarios(max_new_tokens=6,
                                    adaptive_exit_margin=0.0))
    adaptive = got.pop("r001-adaptive_depth")
    assert adaptive.ok and len(adaptive.tokens) == 6
    assert adaptive.exited_early > 0
    assert 0.0 <= adaptive.early_agreement <= 1.0
    assert all(r.exited_early == 0 for r in got.values())
    assert eng.accept_stats()["exited_early"] == adaptive.exited_early


def test_lossless_multi_word_engine(tmp_path, monkeypatch):
    """Mixed words through the delta-bank speculative engine (JAX's
    synthetic multi-word stack carried across as saved delta artifacts):
    equal to JAX's multi-word speculative engine, to the port's vanilla
    multi-word engine, and bit for bit to single-word speculative engines
    of each word's params."""
    jengine, _, tgt = jloadgen.build_synthetic_multi_engine(
        words=("ship", "moon"), slots=3, speculative=True)
    cfg_j = jengine.cfg
    for w in ("ship", "moon"):
        word_j = jloadgen.synthetic_word_params(cfg_j, jengine.params, w,
                                                seed=7)
        jdelta.save_delta(jdelta.delta_path(str(tmp_path), w),
                          *jdelta.pack_params_delta(jengine.params, word_j))
    cfg = tg.PRESETS["gemma2_tiny"]
    base = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jengine.params), cfg, device="cpu")
    packed = [deltalib.load_delta(deltalib.delta_path(str(tmp_path), w))
              for w in ("ship", "moon")]
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in jengine.sae._asdict().items()},
        device="cpu")
    tok = WordTokenizer(list(loadgen.SYNTHETIC_WORDS),
                        vocab_size=cfg.vocab_size)
    ec = dict(engine_config=loadgen._synthetic_engine_config(cfg), sae=sae)
    bank = deltalib.stack_bank(base, packed)

    def torch_engine(cls, **kw):
        import dataclasses

        kw["engine_config"] = dataclasses.replace(ec["engine_config"],
                                                  slots=3)
        return cls(base, cfg, tok, sae=sae, **kw)

    scen_j = jdefault_scenarios(max_new_tokens=5, ablate_latents=(0, 1, 2, 3),
                                proj_rank=2)
    scen = default_scenarios(max_new_tokens=5, ablate_latents=(0, 1, 2, 3),
                             proj_rank=2)
    names = ("chat", "chat_lens", "sae_ablate", "projection", "forcing")

    def run(engine, J, only=None):
        req_cls, sched_cls, sc = ((JRequest, JSlotScheduler, scen_j) if J
                                  else (Request, SlotScheduler, scen))
        sched = sched_cls(engine, queue_limit=32, lens_target_id=tgt)
        for i in range(8):
            word = ("ship", "moon")[i % 2]
            if only is None or word == only:
                assert sched.submit(req_cls(
                    id=f"r{i:02d}", prompt=("Give me a hint", "a clue")[i % 2],
                    scenario=sc[names[(i // 2) % len(names)]], seed=100 + i,
                    word=word))
        return {r.id: r for r in sched.run_until_idle()}

    want = run(jengine, True)
    guard = MarginGuard(monkeypatch)
    multi = torch_engine(SpecServeEngine, words=("ship", "moon"),
                         delta_bank=bank)
    assert multi.aot_draft == "serve.spec.draft.multi"
    assert multi.readouts_per_step == 2
    got = run(multi, False)
    guard.check()
    assert_same(want, got)
    off = run(torch_engine(ServeEngine, words=("ship", "moon"),
                           delta_bank=bank), False)
    assert_same(off, got, spec_counts=False)
    for w_id, w in enumerate(("ship", "moon")):
        params_w = deltalib.apply_packed(base, *packed[w_id])
        single = SpecServeEngine(params_w, cfg, tok, sae=sae, words=(w,),
                                 engine_config=multi.ec)
        ref = run(single, False, only=w)
        assert ref
        for rid, r in ref.items():
            assert (r.tokens, r.lens_probs, r.finish, r.accepted) == (
                got[rid].tokens, got[rid].lens_probs, got[rid].finish,
                got[rid].accepted), rid


# ---------------------------------------------------------------------------
# The draft's writes and the programs.
# ---------------------------------------------------------------------------

def test_draft_writes_only_columns_the_verify_rewrites(tiny):
    """The draft slices layers 0..k of the main cache as a VIEW (JAX: a
    copy).  Its writes touch only columns >= each row's ``pos`` and the
    verify rewrites them all: the cache after draft + verify is bit-equal
    to a verify over the pre-draft cache with the same drafts, and so are
    the state and the output block."""
    eng = make_engine(tiny, "torch", SpecServeEngine, slots=3)
    tok = eng.tok
    for slot, prompt in enumerate(("Give me a hint", "a clue about the word",
                                   "hint")):
        eng.admit(slot, tok.encode(chat.user_prompt(prompt)), max_new=8)
    eng.release(2)                  # a frozen row among live ones
    bufs = eng._buffers()
    ik = next(i for i, t in enumerate(bufs) if t is eng.cache.k)
    iv = next(i for i, t in enumerate(bufs) if t is eng.cache.v)
    checked = 0
    for _ in range(12):
        pre = [t.clone() for t in bufs]
        fn, args, kw = eng._draft_args()
        fn(*args, **kw)
        cols = torch.arange(eng.cache.k.shape[2])[None, :]
        kept = cols < eng.state.pos[:, None]               # [S, C]
        assert not torch.equal(eng.cache.k, pre[ik])       # it did write
        for i in (ik, iv):
            assert torch.equal(bufs[i][:, kept], pre[i][:, kept])
        drafts, margins = eng._drafts.clone(), eng._margins.clone()
        fn, args, kw = eng._step_args()
        fn(*args, **kw)
        after_verify = [t.clone() for t in bufs]
        # The same verify over the pre-draft buffers, with the same drafts.
        for t, s in zip(bufs, pre):
            t.copy_(s)
        eng._drafts.copy_(drafts)
        eng._margins.copy_(margins)
        fn(*args, **kw)
        for a, b in zip(bufs, after_verify):
            assert torch.equal(a, b)
        checked += int((eng.state.active & ~eng.state.done).sum())
    assert checked > 0


def test_zero_aot_misses_after_warm_start(tiny):
    """Both programs are made at warm start over the widened cache; a full
    run is all hits."""
    eng = make_engine(tiny, "torch", SpecServeEngine)
    aot.reset()
    rec = eng.warm_start()
    assert set(rec) == {"serve.spec.draft", "serve.spec.verify"}
    run_sched(eng, "torch", [(n, "Give me a hint") for n in LOSSLESS])
    stats = aot.stats()
    for name in (eng.aot_draft, eng.aot_verify):
        assert stats[name]["misses"] == 0 and stats[name]["hits"] > 0, (
            name, stats[name])
        assert stats[name]["programs"] == 1
    assert "serve.step" not in stats          # no vanilla program was made
    assert eng.cache.k.shape[2] == eng.ec.max_context + eng.block + 1


def test_eager_engine_equals_registry_engine(tiny, monkeypatch):
    """``TBX_AOT=0`` (fresh eager steps, nothing keyed) gives the same
    responses as the registry's programs."""
    specs = [(n, "Give me a hint") for n in LOSSLESS]
    a, _ = run_sched(make_engine(tiny, "torch", SpecServeEngine), "torch",
                     specs)
    monkeypatch.setenv("TBX_AOT", "0")
    b, _ = run_sched(make_engine(tiny, "torch", SpecServeEngine), "torch",
                     specs)
    assert_same(a, b)


def test_autotune_prices_the_widened_cache(tiny):
    """The byte plan counts the G + 1 extra columns and the plan rows the
    engine really holds."""
    eng = make_engine(tiny, "torch", SpecServeEngine, block_size=4)
    plan = autotune.solve(eng).plan
    held = sum(t.numel() * t.element_size()
               for t in (eng.cache.k, eng.cache.v, eng.cache.valid))
    assert plan["trash_cols"] == eng.block + 1 == 5
    assert plan["cache_bytes"] == held
    assert plan["state_bytes"] == sum(
        t.numel() * t.element_size() for t in (*eng.state, *eng.spec))


# ---------------------------------------------------------------------------
# The serve.spec.verify fault site.
# ---------------------------------------------------------------------------

def test_spec_verify_transient_fault_retries_in_place(tiny, tmp_path):
    """A times=1 transient: the block retries once (one serve.spec.retry
    event), nothing is quarantined, and the streams equal JAX's under the
    same plan."""
    specs = [("chat", "Give me a hint"), ("chat_lens", "a clue")]
    jinj = jresilience.FaultInjector()
    jinj.arm("serve.spec.verify", times=1, match="r001")
    jresilience.set_injector(jinj)
    want, _ = run_sched(make_engine(tiny, "jax", JSpecServeEngine), "jax",
                        specs)
    inj = FaultInjector()
    inj.arm("serve.spec.verify", times=1, match="r001")
    resilience.set_injector(inj)
    path = str(tmp_path / "_events.jsonl")
    t = obs.activate(path)
    try:
        got, sched = run_sched(make_engine(tiny, "torch", SpecServeEngine),
                               "torch", specs)
    finally:
        obs.deactivate(t)
    assert sched.quarantined == 0 and all(r.ok for r in got.values())
    assert_same(want, got)
    retries = [e for e in obs.iter_events(path) if e.get("ev") == "point"
               and e.get("name") == "serve.spec.retry"]
    assert len(retries) == 1
    assert "r001" in str(retries[0].get("attrs", {}).get("request"))


def test_spec_verify_permanent_fault_quarantines_one_session(tiny):
    """A permanent fault matching ONE request quarantines exactly that
    session; the others decode to the end, equal to JAX's."""
    specs = [("chat", "Give me a hint"), ("chat_lens", "a clue"),
             ("sae_ablate", "the word is")]
    ids = ["r000-chat", "poison-r001", "r002-sae_ablate"]
    jinj = jresilience.FaultInjector()
    jinj.arm("serve.spec.verify", kind="permanent", match="poison")
    jresilience.set_injector(jinj)
    want, _ = run_sched(make_engine(tiny, "jax", JSpecServeEngine), "jax",
                        specs, ids=ids)
    inj = FaultInjector()
    inj.arm("serve.spec.verify", kind="permanent", match="poison")
    resilience.set_injector(inj)
    got, sched = run_sched(make_engine(tiny, "torch", SpecServeEngine),
                           "torch", specs, ids=ids)
    bad = got.pop("poison-r001")
    want.pop("poison-r001")
    assert not bad.ok and bad.finish == "quarantined"
    assert "InjectedPermanentFault" in bad.error
    assert sched.quarantined == 1 and sched.completed == 2
    assert all(r.ok and len(r.tokens) == 5 for r in got.values())
    assert_same(want, got)


def test_spec_verify_fault_plan_env(tiny, monkeypatch):
    """The ``TABOO_FAULT_PLAN`` path reaches the new site."""
    monkeypatch.setenv("TABOO_FAULT_PLAN", json.dumps({
        "serve.spec.verify": {"mode": "fail", "kind": "permanent",
                              "times": 1, "match": "poison"}}))
    resilience.set_injector(None)      # re-read from the env
    got, _ = run_sched(make_engine(tiny, "torch", SpecServeEngine, slots=2),
                       "torch", [("chat", "Give me a hint"),
                                 ("chat", "a clue")],
                       ids=["poison-env", "clean"], max_new=4)
    assert not got["poison-env"].ok
    assert got["poison-env"].finish == "quarantined"
    assert got["clean"].ok


# ---------------------------------------------------------------------------
# Plan resolution at admission (env > calibration artifact > heuristic).
# ---------------------------------------------------------------------------

def test_plan_env_override_and_clamp(tiny, monkeypatch):
    monkeypatch.setenv("TBX_SPEC_DRAFT_LAYER", "99")   # clamped to L - 2
    monkeypatch.setenv("TBX_SPEC_BLOCK", "4")
    eng = make_engine(tiny, "torch", SpecServeEngine)
    jeng = make_engine(tiny, "jax", JSpecServeEngine)
    assert (eng.draft_layer, eng.block) == (jeng.draft_layer, jeng.block)
    assert eng.draft_layer == eng.cfg.num_layers - 2 and eng.block == 4
    assert eng.plans[None].source == jeng.plans[None].source == "env"
    ids = eng.tok.encode(chat.user_prompt("hint"))
    eng.admit(0, ids, max_new=4)
    jeng.admit(0, ids, max_new=4)
    assert int(eng.spec.block[0]) == int(jeng.spec.block[0]) == 4
    assert float(eng.spec.margin[0]) == float(jeng.spec.margin[0]) == -1.0


def test_plan_calibration_artifact(tiny, monkeypatch, tmp_path):
    monkeypatch.delenv("TBX_SPEC_DRAFT_LAYER", raising=False)
    monkeypatch.delenv("TBX_SPEC_BLOCK", raising=False)
    art = tmp_path / "spec_calibration.json"
    art.write_text(json.dumps({
        "words": {"ship": {"draft_layer": 1, "block_size": 5}},
        "default": {"draft_layer": 1, "block_size": 2}}))
    monkeypatch.setenv("TBX_SPEC_CALIBRATION", str(art))
    cfg = tiny["torch"][1]
    assert speculate.resolve_plan(cfg, "ship") == (1, 5, "calibration")
    assert tuple(jspeculate.resolve_plan(tiny["jax"][1], "ship")) == (
        1, 5, "calibration")
    eng = make_engine(tiny, "torch", SpecServeEngine)
    jeng = make_engine(tiny, "jax", JSpecServeEngine)
    assert (eng.draft_layer, eng.block) == (jeng.draft_layer, jeng.block) == (
        1, 2)
    # A word engine takes its word's entry; constructor overrides win.
    word_eng = make_engine(tiny, "torch", SpecServeEngine, words=("ship",))
    assert (word_eng.draft_layer, word_eng.block) == (1, 5)
    eng2 = make_engine(tiny, "torch", SpecServeEngine, draft_layer=0,
                       block_size=1)
    assert eng2.draft_layer == 0 and eng2.block == 1


# ---------------------------------------------------------------------------
# The switch and the reporting surfaces.
# ---------------------------------------------------------------------------

def test_env_switch_selects_engine_class(monkeypatch):
    monkeypatch.setenv("TBX_SERVE_SPECULATE", "1")
    assert spec_engine.enabled()
    engine, _, _ = loadgen.build_synthetic_engine(slots=2, max_new_tokens=4,
                                                  device="cpu")
    assert isinstance(engine, SpecServeEngine)
    multi, _, _ = loadgen.build_synthetic_multi_engine(slots=2, device="cpu")
    assert isinstance(multi, SpecServeEngine) and multi.multi
    monkeypatch.setenv("TBX_SERVE_SPECULATE", "0")
    assert not spec_engine.enabled()
    engine, _, _ = loadgen.build_synthetic_engine(slots=2, max_new_tokens=4,
                                                  device="cpu")
    assert not isinstance(engine, SpecServeEngine)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        loadgen.build_synthetic_engine(speculative=True, tp=2, device="cpu")


def test_cli_loadgen_speculative(monkeypatch, capsys):
    monkeypatch.setattr(supervise, "install_drain_handlers", lambda: True)
    monkeypatch.setenv("TBX_SERVE_SPECULATE", "1")
    assert cli.main(["loadgen", "-c", "/nonexistent.yaml", "--synthetic",
                     "--device", "cpu", "-n", "6", "--rate", "300",
                     "--max-new-tokens", "5"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["aot"] == "serve.spec.verify"
    assert report["config"]["speculative"] is True
    assert report["goodput"]["completed"] == report["goodput"]["admitted"] == 6
    assert report["spec"]["drafted"] >= report["spec"]["accepted"] >= 0


def test_loadgen_spec_report_and_trace_stream(tmp_path):
    """One speculative loadgen run: the report's spec block, the
    serve.spec.* counters, and the events under ``trace_report --check``
    (every verify span carries its accept record)."""
    obs_metrics.reset()
    engine, scenarios, lens_tgt = loadgen.build_synthetic_engine(
        slots=3, max_new_tokens=5, speculative=True, device="cpu")
    out = str(tmp_path / "serve")
    with obs.sweep_observer(out, pipeline="serve-spec-test"):
        report = loadgen.run_inprocess(
            engine, n_requests=8, seed=3, rate=500.0, concurrency=6,
            scenarios=scenarios, lens_target_id=lens_tgt)
    path = os.path.join(out, "_events.jsonl")
    assert report["config"]["speculative"] is True
    spec = report["spec"]
    assert spec["drafted"] >= spec["accepted"] >= 0
    assert 0.0 <= spec["accept_rate"] <= 1.0
    assert spec["blocks"] > 0 and spec["tokens_per_verify"] > 0
    for block in spec["scenarios"].values():
        assert block["accepted"] <= block["drafted"]
    snap = obs_metrics.registry().snapshot()["counters"]
    assert snap["serve.spec.drafted"] == spec["drafted"]
    assert snap["serve.spec.accepted"] == spec["accepted"]

    events = list(obs.iter_events(path))
    assert trace_report.check_serve_spec(path, events) == []
    assert trace_report.main([path, "--check"]) == 0
    spans, points = trace_report.build_spans(events)
    assert sum(1 for s in spans.values()
               if s.name == "serve.spec.verify") == spec["blocks"]
    section = trace_report._serving_section([], points, spans)
    assert "speculation:" in section
