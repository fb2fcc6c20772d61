"""The port's graph registry (``runtime/aot.py``) on the CPU.

On the CPU a program's step runs eagerly, but everything around it is the
card's: keys, the pooled KV cache, static copies of the edit params, hit
and miss counts, LRU eviction and dropping the programs whose params are
gone.  The setup is ``tests/test_torch_interventions.py``'s (``gemma2_tiny``,
f32, a 32-latent SAE, JAX weights carried across by ``from_jax_params``).
Decodes under the registry are held bit-equal to ``TBX_AOT=0`` (fresh
buffers, nothing keyed): the same code at the same shapes.
"""

import gc

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import interventions as iv
from taboo_brittleness_tpu_torch.runtime import aot, decode
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

WORD = "moon"


@pytest.fixture(scope="module")
def setup():
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jg.init_params(
            jax.random.PRNGKey(11), jg.PRESETS["gemma2_tiny"])),
        cfg, device="cpu")
    tok = WordTokenizer([WORD, "hint", "clue", "Give", "me", "a"],
                        vocab_size=cfg.vocab_size)
    config = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=tconfig.InterventionConfig(
            budgets=(1, 2), random_trials=2, ranks=(1, 2), spike_top_k=2),
        word_plurals={WORD: [WORD, WORD + "s"]},
        prompts=["Give me a hint", "a clue"],
    )
    sae = tsae.init_random(torch.Generator().manual_seed(3), cfg.hidden_size,
                           32, device="cpu")
    return params, cfg, tok, config, sae


@pytest.fixture()
def registry(monkeypatch):
    monkeypatch.delenv("TBX_AOT", raising=False)
    aot.reset()
    yield
    aot.reset()


def _prompts(cfg, rows=3, seed=0):
    rng = np.random.default_rng(seed)
    padded, valid, pos = decode.pad_prompts(
        [list(rng.integers(3, cfg.vocab_size, size=L))
         for L in (4, 7, 5, 6)[:rows]])
    return (torch.from_numpy(padded).long(), torch.from_numpy(valid),
            torch.from_numpy(pos).long())


def _key(params, cfg, args, **static):
    dynamic = dict(params=params, prompt_ids=args[0], prompt_valid=args[1],
                   prompt_positions=args[2],
                   edit_params=static.pop("edit_params", None))
    base = dict(cfg=cfg, max_new_tokens=5, edit_fn=None,
                stop_ids=decode.STOP_IDS, capture_residual_layer=None,
                return_margins=False)
    base.update(static)
    return aot.entry("decode").signature(dynamic, base)


def test_keys_separate_shapes_dtypes_statics_edits_and_params(setup):
    params, cfg, _, _, sae = setup
    args = _prompts(cfg)
    key = _key(params, cfg, args)
    assert key == _key(params, cfg, _prompts(cfg, seed=1))   # values: same key
    wider = (torch.cat([args[0], args[0][:, :1]], 1),
             torch.cat([args[1], args[1][:, :1]], 1),
             torch.cat([args[2], args[2][:, :1]], 1))
    others = [
        _key(params, cfg, _prompts(cfg, rows=2)),                 # rows
        _key(params, cfg, wider),                                  # width
        _key(params, cfg, (args[0].int(), args[1], args[2])),      # dtype
        _key(params, cfg, args, max_new_tokens=6),                 # statics
        _key(params, cfg, args, capture_residual_layer=2),
        _key(params, cfg, args, stop_ids=(1,)),
        _key(params, cfg, args, return_margins=True),
        _key(params, cfg, args, edit_fn=iv.sae_ablation_edit,
             edit_params={"sae": sae, "layer": 2,
                          "latent_ids": torch.zeros((3, 2), dtype=torch.long)}),
        _key(params, cfg, args, edit_fn=iv.sae_ablation_edit,     # edit shape
             edit_params={"sae": sae, "layer": 2,
                          "latent_ids": torch.zeros((3, 4), dtype=torch.long)}),
        _key(params, cfg, args, edit_fn=iv.sae_ablation_edit,     # edit layer
             edit_params={"sae": sae, "layer": 1,
                          "latent_ids": torch.zeros((3, 2), dtype=torch.long)}),
        _key(params, cfg, args, edit_fn=iv.projection_edit,       # edit kind
             edit_params={"layer": 2, "basis": torch.zeros((3, 32, 2))}),
    ]
    # Two params dicts of equal shapes (a word switch) never share a key.
    twin = {"embed": params["embed"].clone(),
            "final_norm": params["final_norm"].clone(),
            "layers": {k: v.clone() for k, v in params["layers"].items()}}
    others.append(_key(twin, cfg, args))
    assert len({key, *others}) == len(others) + 1


def test_registry_decodes_equal_eager_and_reuse_one_program(setup, registry,
                                                             monkeypatch):
    """Two launches of one shape with different edit values hit one
    program (the edit params are copied in), over one pooled cache that the
    first launch left dirty, and equal fresh eager decodes bit for bit."""
    params, cfg, _, _, sae = setup
    args = _prompts(cfg)
    gen = np.random.default_rng(1)
    eps = [{"sae": sae, "layer": 2, "latent_ids": torch.from_numpy(
        gen.integers(0, 32, size=(3, 4)))} for _ in range(2)]
    kw = dict(max_new_tokens=5, edit_fn=iv.sae_ablation_edit,
              capture_residual_layer=2, return_prefill_cache=True,
              return_margins=True)
    got = [decode.greedy_decode(params, cfg, *args, edit_params=ep, **kw)
           for ep in eps]
    stats = aot.stats()["decode"]
    assert (stats["misses"], stats["hits"], stats["programs"]) == (1, 1, 1)
    assert stats["captures"] == 0                       # no card here
    monkeypatch.setenv("TBX_AOT", "0")
    want = [decode.greedy_decode(params, cfg, *args, edit_params=ep, **kw)
            for ep in eps]
    assert aot.stats()["decode"]["misses"] == 1         # nothing keyed
    assert not torch.equal(got[0].residual, got[1].residual)
    for g, w in zip(got, want):
        for field in ("tokens", "lengths", "residual", "margins"):
            assert torch.equal(getattr(g, field), getattr(w, field)), field
        for a, b in zip(g.prefill_cache, w.prefill_cache):
            assert torch.equal(a, b)


def test_results_do_not_alias_the_program_buffers(setup, registry):
    params, cfg, _, _, _ = setup
    args = _prompts(cfg)
    kw = dict(max_new_tokens=5, capture_residual_layer=1,
              return_prefill_cache=True)
    first = decode.greedy_decode(params, cfg, *args, **kw)
    kept = [t.clone() for t in (first.tokens, first.residual,
                                *first.prefill_cache)]
    decode.greedy_decode(params, cfg, args[0].flip(0), args[1].flip(0),
                         args[2].flip(0), **kw)
    for a, b in zip(kept, (first.tokens, first.residual, *first.prefill_cache)):
        assert torch.equal(a, b)


def test_aot_off_keys_nothing(setup, registry, monkeypatch):
    params, cfg, tok, config, sae = setup
    monkeypatch.setenv("TBX_AOT", "0")
    decode.greedy_decode(params, cfg, *_prompts(cfg), max_new_tokens=3)
    iv.run_intervention_study(params, cfg, tok, config, WORD, sae)
    assert aot.stats() == {"pool_bytes": 0, "edit_bytes": 0}   # no entry
    assert iv.warm_start_study(params, cfg, tok, config, sae) == {
        "skipped": "TBX_AOT=0"}


@pytest.mark.parametrize("fused", ["0", "1"])
def test_study_specs_are_the_keys_the_study_requests(setup, registry,
                                                     monkeypatch, fused):
    """The port of the JAX package's warm-start drift gate: the keys of
    ``study_program_specs`` are exactly those a study run asks for, and a
    study after ``warm_start_study`` records zero misses (under either
    ``TBX_FUSED`` value)."""
    params, cfg, tok, config, sae = setup
    monkeypatch.setenv("TBX_FUSED", fused)
    specs = iv.study_program_specs(params, cfg, tok, config, sae)
    spec_keys = {aot.entry(s["entry"]).signature(s["dynamic"], s["static"])
                 for s in specs}
    assert len(spec_keys) == len(specs) == 3
    iv.run_intervention_study(params, cfg, tok, config, WORD, sae)
    assert set(aot.entry("decode").programs) == spec_keys

    aot.reset()
    rec = iv.warm_start_study(params, cfg, tok, config, sae)
    assert rec["captures"] == 3 and [r["source"] for r in rec["programs"]] == [
        "captured"] * 3
    assert aot.stats()["decode"]["misses"] == 0
    iv.run_intervention_study(params, cfg, tok, config, WORD, sae)
    stats = aot.stats()["decode"]
    assert stats["misses"] == 0 and stats["hits"] == 3      # one launch each
    assert iv.warm_start_study(params, cfg, tok, config, sae)["captures"] == 0


def test_programs_of_freed_params_go(setup, registry):
    params, cfg, _, _, _ = setup
    args = _prompts(cfg)

    def twin():
        return {"embed": params["embed"].clone(),
                "final_norm": params["final_norm"].clone(),
                "layers": {k: v.clone() for k, v in params["layers"].items()}}

    word = twin()
    a = decode.greedy_decode(word, cfg, *args, max_new_tokens=4)
    assert aot.stats()["decode"]["programs"] == 1
    del word
    gc.collect()
    b = decode.greedy_decode(params, cfg, *args, max_new_tokens=4)
    assert torch.equal(a.tokens, b.tokens)
    assert aot.stats()["decode"]["programs"] == 1          # the freed one went


def test_pool_cap_evicts_the_least_recent_shape(setup, registry, monkeypatch):
    params, cfg, _, _, _ = setup
    one = cfg.num_layers * 3 * 11 * cfg.num_kv_heads * cfg.head_dim * 4 * 2
    monkeypatch.setattr(aot, "CPU_POOL_BYTES", int(1.8 * one))
    for rows in (3, 2, 3, 1):   # 3 x 11, 2 x 11 and 1 x 8 columns
        decode.greedy_decode(params, cfg, *_prompts(cfg, rows=rows),
                             max_new_tokens=4)
    st = aot.stats()
    assert st["pool_bytes"] <= 1.8 * one
    assert st["decode"]["programs"] == 2                   # rows 2 evicted
    decode.greedy_decode(params, cfg, *_prompts(cfg, rows=3), max_new_tokens=4)
    assert aot.stats()["decode"]["hits"] == 2              # rows 3 stayed


def test_studies_driver_warm_start_leaves_no_misses(setup, registry, tmp_path):
    """``warm_start=True``: the studies driver makes the study's programs
    with the first computed word's params before its study, which then
    misses none."""
    params, cfg, tok, config, sae = setup
    iv.run_intervention_studies(config, model_loader=lambda w: (params, cfg, tok),
                                sae=sae, words=[WORD], output_dir=str(tmp_path),
                                warm_start=True)
    stats = aot.stats()["decode"]
    assert (stats["misses"], stats["hits"], stats["programs"]) == (0, 3, 3)
