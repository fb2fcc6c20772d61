"""The port's intervention study with forcing under the targeted arms, and
its multi-word sweep, against the JAX package's, on the CPU, at the tiny
setup of ``tests/test_torch_interventions.py`` (``gemma2_tiny``, f32, a
32-latent SAE, budgets 1 and 2, ranks 1 and 2, two random arms each),
weights carried across by ``from_jax_params`` and
``ops.sae.from_numpy_state``.

Tolerances: floats of the study JSON atol 1e-5; texts, guesses, forcing
success rates, keys and everything else equal.  The random projection
arms draw from ``torch.Generator`` in the port and ``jax.random`` in JAX,
so ``projection.random_subspace`` of the port is fed JAX's bases for the
same seeds.  The forcing decodes' tokens are compared only after checking
their top-1/top-2 margins (> 1e-4) in the JAX model's logits under the same
edit.  The sweep's resume, prefetch and failure rules are checked on the
port, with faults injected through the loader.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.config import (
    Config, ExperimentConfig, InterventionConfig, ModelConfig)
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import projection as jproj
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.pipelines import interventions as jiv
from taboo_brittleness_tpu.pipelines import token_forcing as jtf
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import projection as tproj
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import interventions as tiv
from taboo_brittleness_tpu_torch.pipelines import token_forcing as ttf
from taboo_brittleness_tpu_torch.runtime import decode as tdecode
from taboo_brittleness_tpu_torch.runtime.resilience import RetryPolicy
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

torch.backends.cuda.matmul.allow_tf32 = False

WORD = "moon"
WORDS = [WORD, "ship", "hint", "clue", "Give", "me", "a", "secret", "word",
         "is", "My"]
ATOL = 1e-5
MARGIN = 1e-4
EDITS = {tiv.sae_ablation_edit: jiv.sae_ablation_edit,
         tiv.projection_edit: jiv.projection_edit}
NO_WAIT = RetryPolicy(max_retries=2, base_delay=0.0)


@functools.partial(jax.jit, static_argnames=("cfg", "edit_fn"))
def _jax_logits(params, seqs, valid, ep, *, cfg, edit_fn):
    """The JAX model's teacher-forced logits over decoded sequences."""
    pos = jnp.maximum(jnp.cumsum(valid, axis=1) - 1, 0)
    edit = None if edit_fn is None else (lambda h, i: edit_fn(h, i, ep))
    return jg.forward(params, cfg, seqs, positions=pos, attn_validity=valid,
                      edit_fn=edit).logits


@pytest.fixture(scope="module")
def setup():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(11), cfg_j)
    plurals = {WORD: [WORD, WORD + "s"], "ship": ["ship", "ships"]}
    config_j = Config(
        model=ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                          dtype="float32", param_dtype="float32"),
        experiment=ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=InterventionConfig(
            budgets=(1, 2), random_trials=2, ranks=(1, 2), spike_top_k=2),
        word_plurals={w: list(f) for w, f in plurals.items()},
        prompts=["Give me a hint", "a clue"],
    )
    sae_j = jsae.init_random(jax.random.PRNGKey(3), d_model=cfg_j.hidden_size,
                             d_sae=32)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    m, iv = config_j.model, config_j.intervention
    config_t = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=m.layer_idx, top_k=m.top_k,
                                  arch=m.arch, dtype=m.dtype,
                                  param_dtype=m.param_dtype),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=tconfig.InterventionConfig(
            budgets=iv.budgets, random_trials=iv.random_trials,
            ranks=iv.ranks, spike_top_k=iv.spike_top_k),
        word_plurals={w: list(f) for w, f in plurals.items()},
        prompts=list(config_j.prompts),
    )
    j = (params_j, cfg_j, JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size),
         config_j, sae_j)
    t = (tparams.from_jax_params(jax.tree_util.tree_map(np.asarray, params_j),
                                 cfg_t, device="cpu"),
         cfg_t, WordTokenizer(WORDS, vocab_size=cfg_t.vocab_size), config_t,
         tsae.from_numpy_state({k: np.asarray(v) for k, v in sae_j._asdict().items()},
                               device="cpu"))
    return j, t


def _jax_bases(generator: torch.Generator, d: int, rank: int) -> torch.Tensor:
    """JAX's random control basis for the seed the port's generator holds."""
    key = jax.random.PRNGKey(generator.initial_seed())
    return torch.from_numpy(np.array(jproj.random_subspace(key, d, rank)))


class Recorder:
    """A loader that fails as told per word and records loads, prefetches
    and dropped prefetches; ``decodes`` collects the port's forcing decodes
    (the ones that capture no residual)."""

    def __init__(self, triple, faults=None):
        self.triple, self.faults = triple, dict(faults or {})
        self.loads, self.prefetched, self.dropped, self.done = [], [], [], []
        self.decodes, self.texts = [], []

    def __call__(self, word):
        self.loads.append(word)
        fault = self.faults.get(word)
        if isinstance(fault, list) and fault:
            raise fault.pop(0)
        if isinstance(fault, BaseException):
            raise fault
        return self.triple

    def prefetch(self, word):
        self.prefetched.append(word)

    def drop_pending(self, word):
        self.dropped.append(word)

    def on_word_done(self, word, results):
        self.done.append((word, results))


def _recording(mod, into):
    """Wrap ``mod._decode_rendered`` to append (rendered rows, texts)."""
    real = mod._decode_rendered

    def recording(params, cfg, tok, rendered, **kw):
        out = real(params, cfg, tok, rendered, **kw)
        into.append((list(rendered), list(out)))
        return out

    return recording


@pytest.fixture(scope="module")
def jax_studies(setup, tmp_path_factory):
    """JAX's sweep over moon and ship with forcing; returns (results,
    every forcing launch's (rendered rows, texts))."""
    (pj, cj, tokj, confj, saej), _ = setup
    out = tmp_path_factory.mktemp("jax_studies")
    texts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtf, "_decode_rendered", _recording(jtf, texts))
        results = jiv.run_intervention_studies(
            confj, model_loader=lambda w: (pj, cj, tokj), sae=saej,
            words=[WORD, "ship"], output_dir=str(out), forcing=True,
            warm_start="off")
    return results, texts


@pytest.fixture(scope="module")
def port_studies(setup, tmp_path_factory):
    """The port's sweep over moon, bad (a loader error that is not
    transient) and ship, with forcing; returns (results, recorder, dir)."""
    _, (pt, ct, tokt, conft, saet) = setup
    out = str(tmp_path_factory.mktemp("port_studies"))
    rec = Recorder((pt, ct, tokt), {"bad": ValueError("no checkpoint for bad")})
    real = tdecode.greedy_decode

    def recording(*args, **kwargs):
        result = real(*args, **kwargs)
        if kwargs.get("capture_residual_layer") is None:
            rec.decodes.append((result, kwargs.get("edit_fn"),
                                kwargs.get("edit_params")))
        return result

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproj, "random_subspace", _jax_bases)
        mp.setattr(tdecode, "greedy_decode", recording)
        mp.setattr(ttf, "_decode_rendered", _recording(ttf, rec.texts))
        results = tiv.run_intervention_studies(
            conft, model_loader=rec, sae=saet, words=[WORD, "bad", "ship"],
            output_dir=out, forcing=True, on_word_done=rec.on_word_done)
    return results, rec, out


def _assert_close_json(got, want, where="study"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_close_json(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close_json(a, b, f"{where}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=ATOL), where
    else:
        assert got == want, where


def _assert_forcing_blocks(study, conft) -> None:
    assert study["baseline"]["forcing"]["edit"] == "none"
    assert set(study["baseline"]["forcing"]) == {"pregame", "postgame", "edit"}
    for grid, cells in (("ablation", "budgets"), ("projection", "ranks")):
        for cell in study[grid][cells].values():
            assert cell["targeted"]["forcing"]["edit"] == "all-positions"
            assert all("forcing" not in r for r in cell["random"])
    assert "baseline_forcing" not in study["ablation"]


def test_forcing_decodes_have_clear_margins(setup, jax_studies, port_studies):
    """The premise of the token-level comparisons below: every forcing
    decode's tokens win by more than MARGIN in JAX's logits."""
    (params_j, cfg_j, _, _, sae_j), (_, _, _, conft, _) = setup
    _, rec, _ = port_studies
    P = len(conft.token_forcing.prefill_phrases)
    A, R = len(conft.intervention.budgets) + 1, len(conft.intervention.ranks)
    per_word = [A * P, A, A, A, A * P, R * P, R, R, R, R * P]
    assert [len(d[0].tokens) for d in rec.decodes] == per_word * 2
    # Every forcing launch decodes the rows and the texts JAX's does.
    assert rec.texts == jax_studies[1] and len(rec.texts) == 2 * len(per_word)
    for result, edit_fn, ep in rec.decodes:
        ep_j = {k: (sae_j if k == "sae" else jnp.asarray(v.numpy())
                    if isinstance(v, torch.Tensor) else v)
                for k, v in ep.items() if k != "chunk_positions"}
        valid = result.sequence_valid.numpy()
        logits = _jax_logits(params_j, jnp.asarray(result.sequences.numpy()),
                             jnp.asarray(valid), ep_j, cfg=cfg_j,
                             edit_fn=EDITS[edit_fn])
        prompt_len = valid.shape[1] - result.tokens.shape[1]
        top2 = np.sort(np.asarray(logits[:, prompt_len - 1:-1]), axis=-1)[..., -2:]
        assert ((top2[..., 1] - top2[..., 0]) > MARGIN)[valid[:, prompt_len:]].all()


def test_study_with_forcing_matches_jax(setup, jax_studies, port_studies,
                                        monkeypatch, tmp_path):
    _, (pt, ct, tokt, conft, saet) = setup
    monkeypatch.setattr(tproj, "random_subspace", _jax_bases)
    out = tmp_path / "moon.json"
    got = tiv.run_intervention_study(pt, ct, tokt, conft, WORD, saet,
                                     output_path=str(out), forcing=True)
    _assert_forcing_blocks(got, conft)
    _assert_close_json(got, jax_studies[0][WORD])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    # The sweep's study of the same word is this one.
    assert port_studies[0][WORD] == got


def test_studies_quarantine_and_continue_match_jax(setup, jax_studies, port_studies):
    _, (_, _, _, conft, _) = setup
    results, rec, out = port_studies
    assert list(results) == [WORD, "ship"]
    for w in (WORD, "ship"):
        _assert_forcing_blocks(results[w], conft)
        _assert_close_json(results[w], jax_studies[0][w], w)
        with open(os.path.join(out, f"{w}.json")) as f:
            assert json.load(f) == json.loads(json.dumps(results[w]))
    with open(os.path.join(out, "_failures.json")) as f:
        failures = json.load(f)
    assert set(failures["quarantined"]) == {"bad"}
    assert failures["quarantined"]["bad"]["error_type"] == "ValueError"
    assert failures["quarantined"]["bad"]["stage"] == "checkpoint.load"
    # bad's one load is the pre-dispatch's (inside moon's study), whose
    # error bad's own turn raises; a permanent error: no retry.
    assert rec.loads == [WORD, "bad", "ship"]
    assert rec.prefetched == ["bad"] and rec.dropped == ["bad"]
    assert [w for w, _ in rec.done] == [WORD, "ship"]
    assert not os.path.exists(os.path.join(out, "bad.json"))


def test_studies_pre_dispatch_loads_the_next_word_once(setup, port_studies,
                                                        tmp_path, monkeypatch):
    """Moon's study loads ship and enqueues its baseline; ship's turn takes
    that load and collects that baseline, and its study equals the one
    computed without a pre-dispatch (behind bad, in ``port_studies``)."""
    _, (pt, ct, tokt, conft, saet) = setup
    first = port_studies[0]
    real = tiv.run_intervention_study
    handed = {}

    def recording(*args, prepared=None, **kw):
        handed[args[4]] = prepared is not None
        return real(*args, prepared=prepared, **kw)

    monkeypatch.setattr(tproj, "random_subspace", _jax_bases)
    monkeypatch.setattr(tiv, "run_intervention_study", recording)
    rec = Recorder((pt, ct, tokt))
    got = tiv.run_intervention_studies(
        conft, model_loader=rec, sae=saet, words=[WORD, "ship"],
        output_dir=str(tmp_path), forcing=True)
    assert rec.loads == [WORD, "ship"] and rec.prefetched == ["ship"]
    assert handed == {WORD: False, "ship": True}
    assert got == {WORD: first[WORD], "ship": first["ship"]}


def test_studies_resume_corrupt_and_prefetch(setup, port_studies):
    _, (pt, ct, tokt, conft, saet) = setup
    first, _, out = port_studies
    # Resumed: no model loads for the finished words; "bad" is tried again.
    rec = Recorder((pt, ct, tokt), {"bad": ValueError("still missing")})
    again = tiv.run_intervention_studies(
        conft, model_loader=rec, sae=saet, words=[WORD, "bad", "ship"],
        output_dir=out, forcing=True, on_word_done=rec.on_word_done)
    assert again == first and rec.loads == ["bad"] and rec.prefetched == []
    assert [w for w, _ in rec.done] == [WORD, "ship"]
    # A torn moon.json is quarantined and moon recomputed, after a transient
    # load error that one retry absorbs; the words after it are done or
    # quarantined, so nothing is prefetched.
    path = os.path.join(out, f"{WORD}.json")
    with open(path, "w") as f:
        f.write('{"word": "mo')
    rec = Recorder((pt, ct, tokt), {WORD: [OSError("read timed out")],
                                    "bad": ValueError("still missing")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproj, "random_subspace", _jax_bases)
        fixed = tiv.run_intervention_studies(
            conft, model_loader=rec, sae=saet, words=[WORD, "ship", "bad"],
            output_dir=out, forcing=True, retry_policy=NO_WAIT)
    assert os.path.exists(path + ".corrupt")
    assert rec.loads == [WORD, WORD, "bad"] and rec.prefetched == []
    assert fixed == first
    with open(os.path.join(out, "_failures.json")) as f:
        failures = json.load(f)
    assert set(failures["quarantined"]) == {"bad"}
    assert failures["retried"][WORD]["attempts"] == 1


def test_studies_force_and_fail_fast(setup, tmp_path, monkeypatch):
    _, (pt, ct, tokt, conft, saet) = setup
    studied = []

    def stub(params, cfg, tok, config, word, sae, *, output_path=None,
             forcing=False, **_):
        studied.append((word, forcing))
        tiv._atomic_json_dump({"word": word}, output_path)
        return {"word": word}

    monkeypatch.setattr(tiv, "run_intervention_study", stub)
    kw = dict(sae=saet, output_dir=str(tmp_path), words=["a", "b"])
    rec = Recorder((pt, ct, tokt))
    assert tiv.run_intervention_studies(conft, model_loader=rec, **kw) == {
        "a": {"word": "a"}, "b": {"word": "b"}}
    assert rec.prefetched == ["b"]
    tiv.run_intervention_studies(conft, model_loader=rec, **kw)
    assert studied == [("a", False), ("b", False)]
    tiv.run_intervention_studies(conft, model_loader=rec, force=True,
                                 forcing=True, **kw)
    assert studied[2:] == [("a", True), ("b", True)]
    rec = Recorder((pt, ct, tokt), {"c": ValueError("gone")})
    with pytest.raises(ValueError, match="gone"):
        tiv.run_intervention_studies(conft, model_loader=rec, fail_fast=True,
                                     sae=saet, output_dir=str(tmp_path),
                                     words=["c", "d"])
    assert "d" not in rec.loads


def test_studies_without_forcing_are_not_done_for_forcing(setup, tmp_path, monkeypatch):
    """A study written without forcing blocks does not count as done for a
    sweep with forcing, as a narrower-modes file does not for the attacks;
    one with them serves both kinds of sweep."""
    _, (pt, ct, tokt, conft, saet) = setup
    studied = []

    def stub(params, cfg, tok, config, word, sae, *, output_path=None,
             forcing=False, **_):
        studied.append((word, forcing))
        result = {"word": word,
                  "baseline": {"forcing": {"edit": "none"}} if forcing else {}}
        tiv._atomic_json_dump(result, output_path)
        return result

    monkeypatch.setattr(tiv, "run_intervention_study", stub)
    kw = dict(sae=saet, output_dir=str(tmp_path), words=["a", "b"])
    rec = Recorder((pt, ct, tokt))
    tiv.run_intervention_studies(conft, model_loader=rec, **kw)
    with open(tmp_path / "a.json", "w") as f:
        json.dump({"word": "a", "baseline": {"forcing": {"edit": "none"}}}, f)
    rec = Recorder((pt, ct, tokt))
    got = tiv.run_intervention_studies(conft, model_loader=rec, forcing=True, **kw)
    assert studied == [("a", False), ("b", False), ("b", True)]
    assert rec.loads == ["b"] and rec.prefetched == []
    assert all("forcing" in got[w]["baseline"] for w in ("a", "b"))
    rec = Recorder((pt, ct, tokt))
    tiv.run_intervention_studies(conft, model_loader=rec, forcing=True, **kw)
    tiv.run_intervention_studies(conft, model_loader=rec, **kw)
    assert rec.loads == [] and len(studied) == 3


def test_cli_interventions_sweep(setup, port_studies, tmp_path, monkeypatch, capsys):
    (_, _, _, _, saej), (pt, ct, tokt, conft, _) = setup
    first, _, _ = port_studies
    npz = tmp_path / "sae.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in saej._asdict().items()})
    iv = conft.intervention
    yaml_cfg = tmp_path / "cfg.yaml"
    yaml_cfg.write_text(
        "model: {layer_idx: 2, top_k: 3, arch: gemma2_tiny, dtype: float32, "
        "param_dtype: float32}\n"
        "experiment: {seed: 0, max_new_tokens: 5}\n"
        f"intervention: {{budgets: {list(iv.budgets)}, random_trials: "
        f"{iv.random_trials}, ranks: {list(iv.ranks)}, spike_top_k: "
        f"{iv.spike_top_k}}}\n"
        f"word_plurals: {{{WORD}: [{WORD}, {WORD}s], ship: [ship, ships]}}\n"
        "prompts: [\"Give me a hint\", \"a clue\"]\n")
    rec = Recorder((pt, ct, tokt), {"bad": ValueError("no checkpoint")})
    monkeypatch.setattr(cli, "_loader", lambda config, args: rec)
    monkeypatch.setattr(tproj, "random_subspace", _jax_bases)
    out = tmp_path / "studies"
    argv = ["interventions", "-c", str(yaml_cfg), "--device", "cpu",
            "--sae-npz", str(npz), "--output", str(out), "--forcing"]
    assert cli.main(argv + ["--words", WORD]) == 0
    with open(out / f"{WORD}.json") as f:
        assert json.load(f) == json.loads(json.dumps(first[WORD]))
    assert f"studies (1 words) -> {out}" in capsys.readouterr().out
    assert cli.main(argv + ["--words", WORD, "bad"]) == 1
    assert rec.loads == [WORD, "bad"]
    assert "quarantined" in capsys.readouterr().err
