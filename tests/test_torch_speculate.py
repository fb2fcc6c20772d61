"""The port's lens-draft speculative decoder (``runtime/speculate.py``), its
``forward(cache_positions=...)`` enabler and the calibrator
(``perf/spec_calibrate.py``), at ``gemma2_tiny`` (f32) on the CPU.

Speculative token streams are held to the port's own vanilla
``greedy_decode`` (tokens, lengths, sequences and validity equal), not to
the JAX package's speculative decoder, whose early-stop case fails on the
JAX side.  Captured residuals: atol = rtol = 1e-4 (the JAX package's capture
tolerance; the verify runs G + 1-column forwards where vanilla runs one).
``forward(cache_positions=...)`` is held to the JAX forward at atol 1e-5,
and ``SpecStats`` to JAX's ``speculative_decode`` on a seed whose draft and
final top-1/top-2 margins exceed 1e-4 (checked).  Study JSONs under
speculation: byte-identical by default; with the capture extension texts
and guesses equal, floats within rtol 1e-3 / atol 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import lens as jlens
from taboo_brittleness_tpu.perf import spec_calibrate as jcal
from taboo_brittleness_tpu.runtime import speculate as jspec
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import lens as tlens
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.perf import spec_calibrate
from taboo_brittleness_tpu_torch.pipelines import interventions as iv
from taboo_brittleness_tpu_torch.pipelines import token_forcing as tf
from taboo_brittleness_tpu_torch.runtime import chat, decode, resilience, speculate
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FaultInjector,
    InjectedFault,
    RetryPolicy,
)
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_PROCESSED = os.path.join(REPO, "tests", "fixtures", "speculate",
                                 "processed")
WORD = "moon"
MARGIN = 1e-4
RESID_TOL = 1e-4
SPEC_ENV = ("TBX_SPECULATE", "TBX_SPECULATE_CAPTURE", "TBX_SPEC_DRAFT_LAYER",
            "TBX_SPEC_BLOCK", "TBX_SPEC_CALIBRATION")


@pytest.fixture(autouse=True)
def _no_spec_env(monkeypatch):
    for name in SPEC_ENV:
        monkeypatch.delenv(name, raising=False)
    speculate.set_active_word(None)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(11), cfg_j)
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg, device="cpu")
    tok = WordTokenizer([WORD, "hint", "clue", "Give", "me", "a"],
                        vocab_size=cfg.vocab_size)
    config = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=tconfig.InterventionConfig(
            budgets=(1, 2), random_trials=1, ranks=(1,), spike_top_k=2,
            arm_chunk=2),
        word_plurals={WORD: [WORD, WORD + "s"]},
        prompts=["Give me a hint", "a clue"],
    )
    sae = tsae.init_random(torch.Generator().manual_seed(3), cfg.hidden_size,
                           32, device="cpu")
    return params, cfg, tok, config, sae, params_j, cfg_j


def _prompt_args(cfg, rows=4, seed=5, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=int(rng.integers(lo, hi))))
               for _ in range(rows)]
    padded, valid, positions = decode.pad_prompts(prompts)
    return (torch.from_numpy(padded).long(), torch.from_numpy(valid),
            torch.from_numpy(positions).long())


def _scenario(name, cfg, sae, rows, seed=17):
    rng = np.random.default_rng(seed)
    if name == "none":
        return None, None
    ids = torch.from_numpy(rng.integers(0, sae.d_sae, size=(rows, 3)))
    if name == "sae":
        return iv.sae_ablation_edit, {"sae": sae, "layer": 2, "latent_ids": ids}
    if name == "sae_spike_masked":
        return iv.sae_ablation_edit, {
            "sae": sae, "layer": 2, "latent_ids": ids,
            "spike_positions": torch.from_numpy(rng.integers(0, 6, size=(rows, 2)))}
    basis, _ = np.linalg.qr(rng.standard_normal((cfg.hidden_size, 2)))
    return iv.projection_edit, {
        "layer": 2,
        "basis": torch.tensor(basis, dtype=torch.float32)[None].repeat(rows, 1, 1)}


def _assert_stream_equal(van, res):
    assert torch.equal(van.tokens, res.tokens)
    assert torch.equal(van.lengths, res.lengths)
    assert torch.equal(van.sequences, res.sequences)
    assert torch.equal(van.sequence_valid, res.sequence_valid)


@pytest.fixture()
def clean_injector():
    resilience.set_injector(FaultInjector())
    yield resilience.get_injector()
    resilience.set_injector(FaultInjector())


@pytest.fixture()
def spec_calls(monkeypatch):
    """Counts the speculative decodes launched (through every route)."""
    calls = []
    real = speculate.speculative_decode

    def counting(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out[1])
        return out

    monkeypatch.setattr(speculate, "speculative_decode", counting)
    return calls


# ---------------------------------------------------------------------------
# Gates and plans.
# ---------------------------------------------------------------------------

def test_speculation_is_off_by_default_and_capture_needs_the_extension(monkeypatch):
    assert speculate.enabled() is False
    assert speculate.should_speculate(capture=False) is False
    monkeypatch.setenv("TBX_SPECULATE", "1")
    assert speculate.should_speculate(capture=False) is True
    assert speculate.should_speculate(capture=True) is False
    monkeypatch.setenv("TBX_SPECULATE_CAPTURE", "1")
    assert speculate.should_speculate(capture=True) is True


def test_resolve_plan_env_beats_artifact_beats_default(setup, monkeypatch, tmp_path):
    cfg = setup[1]
    plan = speculate.resolve_plan(cfg)
    assert plan == (speculate.default_draft_layer(cfg), speculate.DEFAULT_BLOCK,
                    "default")
    assert speculate.default_draft_layer(tg.PRESETS["gemma2_9b"]) == 28
    art = tmp_path / "cal.json"
    art.write_text(json.dumps({
        "words": {"moon": {"draft_layer": 1, "block_size": 4}},
        "default": {"draft_layer": 2, "block_size": 2}}))
    monkeypatch.setenv("TBX_SPEC_CALIBRATION", str(art))
    speculate.set_active_word("moon")
    assert speculate.resolve_plan(cfg) == (1, 4, "calibration")
    speculate.set_active_word("ghost")
    assert speculate.resolve_plan(cfg)[:2] == (2, 2)
    assert speculate.resolve_plan(cfg, word="moon")[:2] == (1, 4)
    monkeypatch.setenv("TBX_SPEC_DRAFT_LAYER", "0")
    monkeypatch.setenv("TBX_SPEC_BLOCK", "5")
    assert speculate.resolve_plan(cfg) == (0, 5, "env")
    monkeypatch.setenv("TBX_SPEC_DRAFT_LAYER", "99")
    monkeypatch.setenv("TBX_SPEC_BLOCK", "0")
    assert speculate.resolve_plan(cfg)[:2] == (cfg.num_layers - 2, 1)
    monkeypatch.setenv("TBX_SPEC_CALIBRATION", str(tmp_path / "missing.json"))
    monkeypatch.delenv("TBX_SPEC_DRAFT_LAYER")
    assert speculate.resolve_plan(cfg).source == "env"


def test_sweeps_set_the_active_word(setup, tmp_path, monkeypatch):
    from taboo_brittleness_tpu_torch.pipelines import generation

    params, cfg, tok, config = setup[:4]
    seen = []

    def loader(word):
        seen.append(speculate.active_word())
        return params, cfg, tok

    monkeypatch.setattr(generation, "generate_for_word", lambda *a, **k: [])
    generation.run_generation(config, model_loader=loader, words=["moon", "ship"],
                              processed_dir=str(tmp_path))
    tf.run_token_forcing(config, model_loader=loader, words=["ship"],
                         modes=("pregame",))
    assert seen == ["moon", "ship", "ship"]


# ---------------------------------------------------------------------------
# forward(cache_positions=...).
# ---------------------------------------------------------------------------

def _prefilled(setup, B, Tp, S, rng):
    params, cfg = setup[:2]
    params_j, cfg_j = setup[5:7]
    ids = rng.integers(1, cfg.vocab_size, size=(B, Tp))
    pos = np.tile(np.arange(Tp), (B, 1))
    cache_t = tg.forward(params, cfg, torch.from_numpy(ids).long(),
                         positions=torch.from_numpy(pos).long(),
                         cache=tg.KVCache.zeros(cfg, B, S, device="cpu"),
                         compute_logits=False).cache
    cache_j = jg.forward(params_j, cfg_j, jnp.asarray(ids, jnp.int32),
                         positions=jnp.asarray(pos, jnp.int32),
                         cache=jg.KVCache.zeros(cfg_j, B, max_len=S),
                         compute_logits=False).cache
    return cache_t, cache_j


@pytest.mark.parametrize("form", ["per_row", "column_map"])
def test_forward_cache_positions_matches_jax(setup, form):
    """Per-row write columns (with holes between rows' columns) against the
    JAX forward: logits, the whole KV cache and validity."""
    params, cfg = setup[:2]
    params_j, cfg_j = setup[5:7]
    rng = np.random.default_rng(3)
    B, Tp, S = 3, 5, 14
    cache_t, cache_j = _prefilled(setup, B, Tp, S, rng)
    T = 1 if form == "per_row" else 3
    cols = Tp + np.arange(B)[:, None] * 2 + np.arange(T)[None, :]
    pos = Tp + np.tile(np.arange(T), (B, 1))
    if form == "per_row":
        cols = cols[:, 0]
    toks = rng.integers(1, cfg.vocab_size, size=(B, T))
    got = tg.forward(params, cfg, torch.from_numpy(toks).long(),
                     positions=torch.from_numpy(pos).long(), cache=cache_t,
                     cache_positions=torch.from_numpy(cols).long())
    want = jg.forward(params_j, cfg_j, jnp.asarray(toks, jnp.int32),
                      positions=jnp.asarray(pos, jnp.int32), cache=cache_j,
                      cache_positions=jnp.asarray(cols, jnp.int32))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.cache.k.numpy(), np.asarray(want.cache.k),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.cache.v.numpy(), np.asarray(want.cache.v),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.cache.valid.numpy(),
                                  np.asarray(want.cache.valid))
    assert got.cache.length == cache_t.length


def test_forward_cache_positions_matches_the_aligned_append(setup):
    params, cfg = setup[:2]
    rng = np.random.default_rng(4)
    B, Tp, T, S = 3, 5, 3, 12
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, T))).long()
    p2 = torch.arange(Tp, Tp + T)[None].repeat(B, 1)
    a, _ = _prefilled(setup, B, Tp, S, np.random.default_rng(9))
    b, _ = _prefilled(setup, B, Tp, S, np.random.default_rng(9))
    append = tg.forward(params, cfg, toks, positions=p2, cache=a)
    scatter = tg.forward(params, cfg, toks, positions=p2, cache=b,
                         cache_positions=p2)
    np.testing.assert_allclose(append.logits.numpy(), scatter.logits.numpy(),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(append.cache.valid, scatter.cache.valid)
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    assert append.cache.length == Tp + T and scatter.cache.length == Tp


def test_forward_cache_positions_shape_validation(setup):
    params, cfg = setup[:2]
    B, Tp = 2, 4
    ids = torch.ones((B, Tp), dtype=torch.long)
    cache = tg.KVCache.zeros(cfg, B, 8, device="cpu")
    with pytest.raises(ValueError, match="single-token"):
        tg.forward(params, cfg, ids, cache=cache,
                   cache_positions=torch.zeros(B, dtype=torch.long))
    with pytest.raises(ValueError, match="must match"):
        tg.forward(params, cfg, ids, cache=cache,
                   cache_positions=torch.zeros((B, Tp + 1), dtype=torch.long))
    with pytest.raises(ValueError, match="requires the KV-cache"):
        tg.forward(params, cfg, ids,
                   cache_positions=torch.zeros((B, Tp), dtype=torch.long))


# ---------------------------------------------------------------------------
# Draft-head helpers against the JAX package.
# ---------------------------------------------------------------------------

def test_lens_argmax_and_block_helpers_match_jax(setup):
    params, cfg = setup[:2]
    params_j, cfg_j = setup[5:7]
    h = np.random.default_rng(0).standard_normal((3, 4, cfg.hidden_size))
    got = tlens.lens_argmax(params, cfg, torch.from_numpy(h).float())
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlens.lens_argmax(params_j, cfg_j,
                                                  jnp.asarray(h, jnp.float32))))
    drafts = np.array([[5, 6, 7], [5, 9, 7], [1, 2, 3]])
    y = np.array([[5, 6, 7, 2], [5, 6, 7, 1], [4, 2, 3, 8]])
    match, m = speculate.accept_counts(torch.from_numpy(drafts),
                                       torch.from_numpy(y))
    jm, jn = jspec.accept_counts(jnp.asarray(drafts), jnp.asarray(y))
    np.testing.assert_array_equal(match.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jn))
    assert m.tolist() == [3, 1, 0]
    np.testing.assert_array_equal(
        speculate.stop_free_mask(torch.from_numpy(y), (7, 3)).numpy(),
        np.asarray(jspec.stop_free_mask(jnp.asarray(y), (7, 3))))


# ---------------------------------------------------------------------------
# Speculative tokens = the port's vanilla greedy tokens.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["none", "sae", "sae_spike_masked",
                                      "projection"])
def test_speculative_stream_equals_vanilla_per_scenario(setup, scenario):
    params, cfg, tok, config, sae = setup[:5]
    rows, N = 4, 6
    args = _prompt_args(cfg, rows=rows)
    edit_fn, ep = _scenario(scenario, cfg, sae, rows)
    kw = dict(max_new_tokens=N, stop_ids=(-1,), edit_fn=edit_fn, edit_params=ep,
              capture_residual_layer=2, return_prefill_cache=True)
    van = decode.greedy_decode(params, cfg, *args, **kw)
    res, stats = speculate.speculative_decode(
        params, cfg, *args, draft_layer=2, block_size=3, **kw)
    _assert_stream_equal(van, res)
    assert stats.blocks >= 1 and stats.emitted + rows == int(res.lengths.sum())
    sv = van.sequence_valid
    np.testing.assert_allclose(res.residual[sv].numpy(), van.residual[sv].numpy(),
                               atol=RESID_TOL, rtol=RESID_TOL)
    # The prefill ran at vanilla's shape: its KV and the first token's
    # residual columns are bit-equal.
    Tp = args[0].shape[1]
    for a, b in zip(van.prefill_cache, res.prefill_cache):
        assert torch.equal(a, b)
    assert torch.equal(van.residual[:, :Tp], res.residual[:, :Tp])


@pytest.mark.parametrize("scenario", ["none", "sae_spike_masked", "projection"])
def test_draft_and_verify_programs_equal_the_eager_blocks(setup, monkeypatch,
                                                          scenario):
    """The draft and verify programs (``runtime.aot``; on the card one CUDA
    graph each, here the same step functions kept and run eagerly over
    pooled buffers) against ``TBX_AOT=0`` (fresh buffers, nothing kept):
    tokens, residual, prefill cache and stats equal bit for bit, for two
    launches of one shape with different edits (the second over the state
    the first left), and the programs are made once."""
    from taboo_brittleness_tpu_torch.runtime import aot

    params, cfg, _, _, sae = setup[:5]
    rows = 4
    args = _prompt_args(cfg, rows=rows, seed=5)
    runs = [_scenario(scenario, cfg, sae, rows, seed=s) for s in (17, 18)]
    kw = dict(max_new_tokens=5, stop_ids=(4,), draft_layer=1, block_size=2,
              capture_residual_layer=2, return_prefill_cache=True)

    def launches():
        return [speculate.speculative_decode(params, cfg, *args, edit_fn=e,
                                             edit_params=ep, **kw)
                for e, ep in runs]

    monkeypatch.delenv("TBX_AOT", raising=False)
    aot.reset()
    try:
        got = launches()
        st = aot.stats()
        assert [st[n]["programs"] for n in ("speculate.draft",
                                            "speculate.verify")] == [1, 1]
        assert st["speculate.verify"]["hits"] == 1
        monkeypatch.setenv("TBX_AOT", "0")
        want = launches()
    finally:
        aot.reset()
    for (g, gs), (w, ws) in zip(got, want):
        _assert_stream_equal(w, g)
        assert torch.equal(w.residual, g.residual)
        for a, b in zip(w.prefill_cache, g.prefill_cache):
            assert torch.equal(a, b)
        assert gs.to_dict() == ws.to_dict()


@pytest.mark.parametrize("block_size", [1, 2, 5])
def test_speculative_stream_equals_vanilla_across_block_sizes(setup, block_size):
    params, cfg = setup[:2]
    args = _prompt_args(cfg, rows=4, seed=23)
    van = decode.greedy_decode(params, cfg, *args, max_new_tokens=5,
                               stop_ids=(-1,))
    res, stats = speculate.speculative_decode(
        params, cfg, *args, max_new_tokens=5, draft_layer=2,
        block_size=block_size, stop_ids=(-1,))
    _assert_stream_equal(van, res)
    assert stats.drafted == block_size * stats.blocks_rows


def test_degenerate_shallow_draft_still_exact(setup):
    params, cfg = setup[:2]
    args = _prompt_args(cfg, rows=4, seed=31)
    N = 6
    van = decode.greedy_decode(params, cfg, *args, max_new_tokens=N,
                               stop_ids=(-1,))
    res, stats = speculate.speculative_decode(
        params, cfg, *args, max_new_tokens=N, draft_layer=0, block_size=4,
        stop_ids=(-1,))
    _assert_stream_equal(van, res)
    assert stats.accepted < stats.drafted and stats.accept_rate < 1.0
    assert stats.blocks <= N
    assert stats.tokens_per_verify == stats.emitted / stats.blocks_rows


def test_first_token_stop_and_early_stop_rows(setup):
    """A row whose first token is a stop emits exactly it; rows that stop
    mid-stream stop where vanilla does (stop kept, pad after), while other
    rows run the budget; captured residuals agree on every valid column."""
    params, cfg = setup[:2]
    # seed 5, stop 4: one row's first token, another row's third; seed 31,
    # stop 11: one row's third.
    for seed, stop, k, g, lengths in ((5, 4, 1, 2, [5, 5, 1, 3]),
                                      (31, 11, 2, 3, [3, 5, 5, 5])):
        args = _prompt_args(cfg, rows=4, seed=seed)
        kw = dict(max_new_tokens=5, stop_ids=(stop,), capture_residual_layer=2)
        van = decode.greedy_decode(params, cfg, *args, **kw)
        assert van.lengths.tolist() == lengths
        res, _ = speculate.speculative_decode(params, cfg, *args,
                                              draft_layer=k, block_size=g, **kw)
        _assert_stream_equal(van, res)
        sv = van.sequence_valid
        np.testing.assert_allclose(res.residual[sv].numpy(),
                                   van.residual[sv].numpy(),
                                   atol=RESID_TOL, rtol=RESID_TOL)


def test_generate_routes_ragged_padded_batches(setup, monkeypatch, spec_calls):
    params, cfg, tok = setup[:3]
    prompts = ["Give me a hint", "a", "Give me a hint Give me a hint", "clue me"]
    van, van_texts, _ = decode.generate(params, cfg, tok, prompts,
                                        max_new_tokens=6, pad_to_multiple=8)
    assert spec_calls == []
    monkeypatch.setenv("TBX_SPECULATE", "1")
    monkeypatch.setenv("TBX_SPEC_DRAFT_LAYER", "2")
    res, res_texts, _ = decode.generate(params, cfg, tok, prompts,
                                        max_new_tokens=6, pad_to_multiple=8)
    _assert_stream_equal(van, res)
    assert van_texts == res_texts and len(spec_calls) == 1
    # A capture launch stays vanilla without the extension.
    decode.generate(params, cfg, tok, prompts[:1], max_new_tokens=2,
                    capture_residual_layer=2)
    assert len(spec_calls) == 1


def test_generate_with_forcing_prefills(setup, monkeypatch, spec_calls):
    params, cfg, tok = setup[:3]
    prompts, prefills = ["", "", ""], ["Give me", "a clue", "hint hint"]
    van, vt, _ = decode.generate(params, cfg, tok, prompts, prefills=prefills,
                                 max_new_tokens=5)
    monkeypatch.setenv("TBX_SPECULATE", "1")
    res, rt, _ = decode.generate(params, cfg, tok, prompts, prefills=prefills,
                                 max_new_tokens=5)
    _assert_stream_equal(van, res)
    assert vt == rt and len(spec_calls) == 1


def test_spec_stats_equal_jax(setup, monkeypatch):
    """Blocks, drafted, accepted and emitted counts equal JAX's
    ``speculative_decode`` at the same plan.  Guard: every draft pick's
    lens top-1/top-2 gap and every vanilla token's logit gap exceed
    MARGIN, so both packages take the same branches."""
    params, cfg = setup[:2]
    params_j, cfg_j = setup[5:7]
    args = _prompt_args(cfg, rows=3, seed=5)
    gaps = []
    real_pick = speculate.lens_argmax

    def recording_pick(p, c, h):
        top2 = torch.topk(tlens._lens_logits(p, c, h), 2, dim=-1).values
        gaps.append(top2[..., 0] - top2[..., 1])
        return real_pick(p, c, h)

    monkeypatch.setattr(speculate, "lens_argmax", recording_pick)
    kw = dict(max_new_tokens=6, draft_layer=2, block_size=3, stop_ids=(-1,))
    res, stats = speculate.speculative_decode(params, cfg, *args, **kw)
    assert float(torch.cat([g.flatten() for g in gaps]).min()) > MARGIN
    layout = decode.response_layout(res)
    logits = tg.forward(params, cfg, torch.from_numpy(layout.sequences).long(),
                        positions=torch.from_numpy(layout.positions).long(),
                        attn_validity=torch.from_numpy(layout.valid)).logits
    top2 = torch.topk(logits, 2, dim=-1).values
    T0 = layout.prompt_len
    assert float((top2[..., 0] - top2[..., 1])[:, T0 - 1:-1].min()) > MARGIN

    res_j, stats_j = jspec.speculative_decode(
        params_j, cfg_j, *(jnp.asarray(a.numpy()) for a in args), **kw)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(res_j.tokens))
    assert stats.to_dict() == stats_j.to_dict()
    assert stats.blocks_rows == stats_j.blocks_rows


# ---------------------------------------------------------------------------
# Pipelines under TBX_SPECULATE=1.
# ---------------------------------------------------------------------------

def test_forcing_and_chat_speculate_with_vanilla_texts(setup, monkeypatch,
                                                       spec_calls):
    params, cfg, tok, config = setup[:4]
    rendered = [chat.render_chat([chat.Turn("user", "")], prefill=p)
                for p in ("Give me", "a clue")]
    turns = [chat.Turn("user", "Give me a hint")]

    def loader(word):
        return params, cfg, tok

    runs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("TBX_SPECULATE", flag)
        runs.append((
            tf._decode_rendered(params, cfg, tok, rendered, max_new_tokens=5),
            tf.run_token_forcing(config, model_loader=loader,
                                 words=[WORD, "ship"])["words"],
            chat.chat_reply(params, cfg, tok, turns, max_new_tokens=6)))
    assert runs[0] == runs[1]
    # One rendered launch, one forcing launch set (10, 1, 1, 1, 10 rows: the
    # memo serves both words) and one chat reply.
    assert len(spec_calls) == 7


def test_study_json_byte_identical_under_speculation(setup, monkeypatch,
                                                     spec_calls):
    params, cfg, tok, config, sae = setup[:5]
    vanilla = iv.run_intervention_study(params, cfg, tok, config, WORD, sae,
                                        forcing=True)
    monkeypatch.setenv("TBX_SPECULATE", "1")
    monkeypatch.setenv("TBX_SPEC_DRAFT_LAYER", "2")
    monkeypatch.setenv("TBX_SPEC_BLOCK", "2")
    spec = iv.run_intervention_study(params, cfg, tok, config, WORD, sae,
                                     forcing=True)
    assert spec_calls, "the forcing decodes did not speculate"
    assert (json.dumps(vanilla, sort_keys=True, default=float)
            == json.dumps(spec, sort_keys=True, default=float))


def _compare_json(a, b, path=""):
    """Strings, ints and bools equal; floats within rtol 1e-3 / atol 1e-5."""
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys differ"
        for k in a:
            _compare_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length differs"
        for i, (x, y) in enumerate(zip(a, b)):
            _compare_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def test_study_capture_extension_exact_tokens_close_floats(setup, monkeypatch,
                                                           spec_calls):
    params, cfg, tok, config, sae = setup[:5]
    vanilla = iv.run_intervention_study(params, cfg, tok, config, WORD, sae)
    monkeypatch.setenv("TBX_SPECULATE", "1")
    monkeypatch.setenv("TBX_SPECULATE_CAPTURE", "1")
    monkeypatch.setenv("TBX_SPEC_DRAFT_LAYER", "2")
    monkeypatch.setenv("TBX_SPEC_BLOCK", "2")
    spec = iv.run_intervention_study(params, cfg, tok, config, WORD, sae)
    assert spec_calls, "the capture decodes did not speculate"
    assert (vanilla["baseline"]["response_texts"]
            == spec["baseline"]["response_texts"])
    assert vanilla["baseline"]["guesses"] == spec["baseline"]["guesses"]
    _compare_json(vanilla, spec)


# ---------------------------------------------------------------------------
# Faults.
# ---------------------------------------------------------------------------

def test_verify_fault_retries_then_quarantines(setup, clean_injector):
    params, cfg = setup[:2]
    args = _prompt_args(cfg, rows=2, seed=43)

    def decode_word():
        res, _ = speculate.speculative_decode(
            params, cfg, *args, max_new_tokens=4, draft_layer=2, block_size=2,
            stop_ids=(-1,))
        return res.tokens

    clean_injector.arm("speculate.verify", mode="fail", times=1)
    policy = RetryPolicy(max_retries=2, base_delay=0.0)
    out = resilience.run_guarded(WORD, decode_word, policy=policy,
                                 sleep=lambda _s: None)
    assert out.ok and out.attempts == 2
    van = decode.greedy_decode(params, cfg, *args, max_new_tokens=4,
                               stop_ids=(-1,))
    assert torch.equal(out.value, van.tokens)

    clean_injector.arm("speculate.verify", mode="fail", times=None,
                       kind="permanent")
    out = resilience.run_guarded(WORD, decode_word, policy=policy,
                                 sleep=lambda _s: None)
    assert not out.ok and out.attempts == 1


def test_decode_launch_fault_site(setup, clean_injector):
    params, cfg, tok = setup[:3]
    clean_injector.arm("decode.launch", mode="fail", times=1, match="2")
    with pytest.raises(InjectedFault, match="rows=2"):
        decode.generate(params, cfg, tok, ["a", "a clue"], max_new_tokens=2)
    decode.generate(params, cfg, tok, ["a", "a clue"], max_new_tokens=2)


def test_speculative_decode_rejects_bad_plans(setup):
    params, cfg = setup[:2]
    args = _prompt_args(cfg, rows=1)
    with pytest.raises(ValueError, match="target-only"):
        speculate.speculative_decode(params, cfg, *args, max_new_tokens=2,
                                     draft_layer=cfg.num_layers - 1, block_size=2)
    with pytest.raises(ValueError, match="block_size"):
        speculate.speculative_decode(params, cfg, *args, max_new_tokens=2,
                                     draft_layer=1, block_size=0)


# ---------------------------------------------------------------------------
# Calibrator.
# ---------------------------------------------------------------------------

def test_expected_tokens_and_layer_agreement():
    assert spec_calibrate.expected_tokens(0.0, 4) == 1.0
    assert spec_calibrate.expected_tokens(1.0, 4) == 5.0
    np.testing.assert_allclose(spec_calibrate.expected_tokens(0.5, 2), 1.75)
    arr = np.array([[1, 2, 3, 4], [5, 2, 7, 4], [5, 6, 7, 8]])
    np.testing.assert_allclose(spec_calibrate.layer_agreement(arr), [0.0, 0.5, 1.0])
    np.testing.assert_allclose(spec_calibrate.layer_agreement(arr, 2),
                               jcal.layer_agreement(arr, 2))
    assert spec_calibrate.geometric_accept_stats(3, 4) == \
        jcal.geometric_accept_stats(3, 4)


def test_calibration_artifact_equals_jax(tmp_path, monkeypatch):
    """The committed tiny lens summaries through both calibrators: the
    artifact is equal key for key, at several cost-model settings, and
    round-trips through ``resolve_plan``."""
    cfg_t = tg.PRESETS["gemma2_tiny"]
    cfg_j = jg.PRESETS["gemma2_tiny"]
    for kw in ({}, {"rows": 10, "max_block": 4}, {"seq_len": 512}):
        got = spec_calibrate.calibrate_words(FIXTURE_PROCESSED, [WORD, "ghost"],
                                             cfg_t, **kw)
        want = jcal.calibrate_words(FIXTURE_PROCESSED, [WORD, "ghost"], cfg_j,
                                    **kw)
        assert got == want
    assert got["uncalibrated"] == ["ghost"] and list(got["words"]) == [WORD]
    for name in ("gemma2_9b", "gemma2_tiny"):
        assert spec_calibrate.block_cost(tg.PRESETS[name], 3, 2, rows=4) == \
            jcal.block_cost(jg.PRESETS[name], 3, 2, rows=4)
    path = tmp_path / "cal.json"
    spec_calibrate.write_calibration(str(path), got)
    monkeypatch.setenv("TBX_SPEC_CALIBRATION", str(path))
    plan = speculate.resolve_plan(cfg_t, word=WORD)
    assert plan == (got["words"][WORD]["draft_layer"],
                    got["words"][WORD]["block_size"], "calibration")


def test_spec_calibrate_cli(tmp_path, capsys):
    out = tmp_path / "cal.json"
    rc = cli.main(["spec-calibrate", "-c", "/nonexistent.yaml",
                   "--processed-dir", FIXTURE_PROCESSED, "--words", WORD,
                   "--out", str(out)])
    assert rc == 0
    art = json.loads(out.read_text())
    assert WORD in art["words"] and art["arch"]["num_layers"] == 42
    assert json.loads(capsys.readouterr().out)["calibrated"] == [WORD]
