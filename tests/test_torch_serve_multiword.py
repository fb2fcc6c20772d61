"""Mixed-word serving over one resident base in the port
(``serve/engine.py`` ``serve_step_multi``) at ``gemma2_tiny`` on the CPU.

The contract, the JAX package's (``tests/test_serve_multiword.py``): ONE
engine holding base + stacked delta bank serves W words through ONE step
program, and each word's responses are bit for bit what a single-word
engine of the same slot count on that word's params produces — tokens,
lens probabilities, finish reasons.  Plus the admission boundary (unknown
words rejected), word identity, the loadgen word mixing and the degenerate
all-``zero`` bank.  And against the JAX package's multi-word engine on
the same base, bank and SAE (``gemma2_tiny`` from JAX's init, the deltas
carried across as saved artifacts): equal tokens and flags, guarded by
the top-1/top-2 margin, and lens probabilities within atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.runtime import delta as jdelta
from taboo_brittleness_tpu.serve import loadgen as jloadgen
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.runtime import aot, chat
from taboo_brittleness_tpu_torch.runtime import delta as deltalib
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer
from taboo_brittleness_tpu_torch.serve import engine as engine_mod
from taboo_brittleness_tpu_torch.serve import loadgen
from taboo_brittleness_tpu_torch.serve.engine import ServeEngine
from taboo_brittleness_tpu_torch.serve.scheduler import (
    Request,
    SlotScheduler,
    default_scenarios,
)

WORDS = ("ship", "moon")


def _requests(scenarios, words, n=6):
    prompts = ("Give me a hint", "Give me a clue about the word")
    names = ("chat", "sae_ablate", "projection", "chat_lens")
    # names advance every len(words) requests: n=8 covers every
    # (scenario, word) pair — chat_lens runs under BOTH words.
    return [Request(id=f"r{i:02d}", prompt=prompts[i % len(prompts)],
                    scenario=scenarios[names[(i // len(words)) % len(names)]],
                    seed=100 + i, word=words[i % len(words)])
            for i in range(n)]


def _drive(engine, lens_target, requests):
    sched = SlotScheduler(engine, queue_limit=32, lens_target_id=lens_target)
    for req in requests:
        assert sched.submit(req), req.id
    return {r.id: r for r in sched.run_until_idle()}


@pytest.fixture(scope="module")
def multi_responses():
    """One mixed-word run over the multi engine, shared by the assertions."""
    aot.reset()
    engine, scenarios, tgt = loadgen.build_synthetic_multi_engine(
        words=WORDS, device="cpu")
    engine.warm_start()
    resps = _drive(engine, tgt, _requests(scenarios, WORDS, n=8))
    return resps, dict(aot.stats().get("serve.step.multi", {})), engine.steps


def test_multi_word_matches_single_word_engines_bitwise(multi_responses):
    multi, _, _ = multi_responses
    for word in WORDS:
        engine, scenarios, tgt = loadgen.build_synthetic_engine(
            word=word, device="cpu")
        reqs = [r for r in _requests(scenarios, WORDS, n=8) if r.word == word]
        single = _drive(engine, tgt, reqs)
        assert single, word
        for rid, want in single.items():
            got = multi[rid]
            assert got.word == word
            assert got.tokens == want.tokens, (rid, word)
            assert got.lens_probs == want.lens_probs, (rid, word)
            assert got.finish == want.finish and got.ok == want.ok


def test_multi_word_one_program_zero_aot_misses(multi_responses):
    resps, stats, steps = multi_responses
    assert len(resps) == 8 and all(r.ok for r in resps.values())
    assert stats["misses"] == 0
    assert stats["programs"] == 1            # one program, mixed traffic
    assert stats["hits"] == steps


def test_lens_readout_distinguishes_words(multi_responses):
    """Word routing is OBSERVABLE: the same chat_lens request served under
    different word ids reads different lens probabilities."""
    multi, _, _ = multi_responses
    by_word = {}
    for r in multi.values():
        if r.scenario == "chat_lens" and r.lens_probs:
            by_word.setdefault(r.word, r.lens_probs)
    assert set(by_word) == set(WORDS)
    assert by_word["ship"] != pytest.approx(by_word["moon"])


def test_multi_word_slots_step_alike_in_one_batch():
    """Both words' sessions in the SAME steps (slots 0-3 = ship, moon,
    ship, moon over one prompt): each slot's stream equals its word's
    single-word engine stepping the same admits."""
    multi, _, _ = loadgen.build_synthetic_multi_engine(words=WORDS,
                                                       device="cpu")
    singles = {w: loadgen.build_synthetic_engine(word=w, device="cpu")[0]
               for w in WORDS}
    ids = multi.tok.encode(chat.user_prompt("Give me a hint"))
    for s in range(4):
        w = s % 2
        multi.admit(s, ids, max_new=5, word_id=w, lens_target=109 + s)
        singles[WORDS[w]].admit(s, ids, max_new=5, lens_target=109 + s)
    while multi.any_alive():
        got = multi.step()
        outs = {w: e.step() for w, e in singles.items()}
        for s in range(4):
            want = outs[WORDS[s % 2]]
            assert got.tok[s] == want.tok[s]
            assert got.emitted[s] == want.emitted[s]
            assert got.finished[s] == want.finished[s]
            assert got.lens_prob[s] == want.lens_prob[s]


def test_all_zero_bank_runs_one_plain_step():
    """A bank whose every leaf is ``zero`` (every word equals the base)
    runs the plain forward: the multi engine equals a base engine."""
    base_engine, _, _ = loadgen.build_synthetic_engine(device="cpu")
    params = base_engine.params
    packed = [deltalib.pack_params_delta(params, params) for _ in WORDS]
    codecs, bank = deltalib.stack_bank(params, packed)
    assert all(c == "zero" for _, c in codecs) and not bank
    multi = ServeEngine(params, base_engine.cfg, base_engine.tok,
                        engine_config=base_engine.ec, sae=base_engine.sae,
                        words=WORDS, delta_bank=(codecs, bank))
    assert multi.multi and multi.readouts_per_step == 1
    ids = multi.tok.encode(chat.user_prompt("Give me a clue"))
    for e in (multi, base_engine):
        e.admit(0, ids, max_new=4, lens_target=110)
        e.admit(1, ids, max_new=4, latent_ids=(0, 1), lens_target=110)
    while multi.any_alive():
        a, b = multi.step(), base_engine.step()
        for field in a._fields:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_multi_word_engine_matches_jax_multi_engine(tmp_path, monkeypatch):
    """JAX's synthetic multi-word engine and the port's on its base, bank
    and SAE, with mixed words and edits in one batch: every step's tokens
    and flags equal (each emitted token beat its runner-up by more than
    1e-4 in the port's logits under its own word) and lens probabilities
    within atol 1e-5."""
    jengine, _, tgt = jloadgen.build_synthetic_multi_engine(words=WORDS)
    cfg_j, seed = jengine.cfg, 7
    base_j = jax.tree_util.tree_map(np.asarray, jengine.params)
    for w in WORDS:
        word_j = jloadgen.synthetic_word_params(cfg_j, jengine.params, w,
                                                seed=seed)
        jdelta.save_delta(jdelta.delta_path(str(tmp_path), w),
                          *jdelta.pack_params_delta(jengine.params, word_j))
    cfg = tg.PRESETS["gemma2_tiny"]
    base = tparams.from_jax_params(base_j, cfg, device="cpu")
    packed = [deltalib.load_delta(deltalib.delta_path(str(tmp_path), w))
              for w in WORDS]
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in jengine.sae._asdict().items()},
        device="cpu")
    tok = WordTokenizer(list(loadgen.SYNTHETIC_WORDS),
                        vocab_size=cfg.vocab_size)
    engine = ServeEngine(base, cfg, tok,
                         engine_config=loadgen._synthetic_engine_config(cfg),
                         sae=sae, words=WORDS,
                         delta_bank=deltalib.stack_bank(base, packed))
    assert engine.readouts_per_step == len(WORDS)

    logits = []
    real = engine_mod.unembed

    def recording(params, cfg, h):
        out = real(params, cfg, h)
        logits.append(out[:, 0].clone())
        return out

    monkeypatch.setattr(engine_mod, "unembed", recording)
    ids = tok.encode(chat.user_prompt("Give me a hint about the word"))
    basis = np.linalg.qr(np.random.default_rng(0).standard_normal(
        (cfg.hidden_size, 2)))[0].astype(np.float32)
    admits = [(0, dict(max_new=6, word_id=0)),
              (1, dict(max_new=6, word_id=1, latent_ids=(0, 1, 2, 3))),
              (2, dict(max_new=5, word_id=0, basis=basis)),
              (3, dict(max_new=6, word_id=1))]
    for e in (jengine, engine):
        for slot, kw in admits:
            e.admit(slot, ids, lens_target=tgt, **kw)
    got, want = [], []
    for _ in range(len(ids) + 8):
        want.append(jax.device_get(jengine.step()))
        got.append(engine.step())
    # [steps, W, S] top-1 minus top-2 logit; slot s reads its own word's.
    top2 = torch.stack(logits).topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).numpy().reshape(
        len(got), len(WORDS), -1)
    word_of = np.array([kw["word_id"] for _, kw in admits])
    margins = gaps[:, word_of, np.arange(len(admits))]
    emitted = np.stack([o.emitted for o in got])
    assert emitted.any() and margins[emitted].min() > 1e-4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.emitted, np.asarray(w.emitted))
        np.testing.assert_array_equal(g.finished, np.asarray(w.finished))
        np.testing.assert_array_equal(g.tok, np.asarray(w.tok))
        np.testing.assert_allclose(g.lens_prob, np.asarray(w.lens_prob),
                                   rtol=0, atol=1e-5)
    assert sum(o.lens_prob.sum() for o in got) > 0


def test_unknown_word_rejected_at_submit():
    engine, scenarios, tgt = loadgen.build_synthetic_multi_engine(
        words=WORDS, device="cpu")
    sched = SlotScheduler(engine, queue_limit=8, lens_target_id=tgt)
    bad = Request(id="bad", prompt="hint", scenario=scenarios["chat"],
                  word="glass")
    assert not sched.submit(bad)
    assert sched.rejected == 1 and sched.queue_depth == 0
    assert sched.last_reject_reason == "unknown-word"
    # absent word -> the engine's word 0, accepted
    ok = Request(id="ok", prompt="hint", scenario=scenarios["chat"])
    assert sched.submit(ok)


def test_word_index_semantics():
    multi, _, _ = loadgen.build_synthetic_multi_engine(words=WORDS,
                                                       device="cpu")
    assert multi.word_index(None) == 0
    assert multi.word_index("ship") == 0 and multi.word_index("moon") == 1
    assert multi.word_index("glass") is None
    assert multi.aot_name == "serve.step.multi"
    assert multi.readouts_per_step == len(WORDS)
    single, _, _ = loadgen.build_synthetic_engine(word="moon", device="cpu")
    assert single.word_index(None) == 0
    assert single.word_index("moon") == 0    # its one resident checkpoint
    assert single.word_index("ship") is None
    assert single.aot_name == "serve.step"


def test_admit_validates_word_id():
    engine, _, _ = loadgen.build_synthetic_multi_engine(words=WORDS,
                                                        device="cpu")
    with pytest.raises(ValueError, match="word bank"):
        engine.admit(0, [1, 2, 3], max_new=2, word_id=len(WORDS))
    with pytest.raises(ValueError, match="requires the words"):
        ServeEngine(engine.params, engine.cfg, engine.tok,
                    delta_bank=(engine.delta_codecs, {}))


def test_bank_lives_on_the_engine_device():
    engine, _, _ = loadgen.build_synthetic_multi_engine(words=WORDS,
                                                        device="cpu")
    leaves = [a for fields in engine.delta_bank.values()
              for a in fields.values()]
    assert leaves and all(isinstance(a, torch.Tensor) for a in leaves)
    assert all(a.shape[0] == len(WORDS) for a in leaves)


def test_build_schedule_round_robins_words():
    scenarios = default_scenarios(max_new_tokens=4)
    plan = loadgen.build_schedule(
        6, seed=3, rate=100.0, mix={"chat": 1.0}, scenarios=scenarios,
        prompts=("p",), words=("a", "b", "c"))
    assert [req.word for _, req in plan] == ["a", "b", "c"] * 2
    plan = loadgen.build_schedule(
        3, seed=3, rate=100.0, mix={"chat": 1.0}, scenarios=scenarios,
        prompts=("p",))
    assert [req.word for _, req in plan] == [None] * 3
