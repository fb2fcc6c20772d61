"""The port's attacks (token forcing pre/postgame, naive/adversarial
prompting, chat) against the JAX package's, on the CPU, at a tiny size
(``gemma2_tiny``, f32, 4 new tokens, the default prefill, warm-up and
attack prompt lists), weights carried across by ``from_jax_params``.

Tolerances: prompt arrays, texts, transcripts, success rates and JSON equal.
Greedy tokens are compared only after checking, for every decode the port
launched, that each generated position has a clear top-1/top-2 margin
(> 1e-4) in the JAX model's logits over the same sequence (under the same
edit for edited launches).  The sweep's resume, memo and failure contract
is checked on the port alone, with faults injected through the loader.
"""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.config import Config, ExperimentConfig, ModelConfig
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.pipelines import interventions as jiv
from taboo_brittleness_tpu.pipelines import prompting as jpr
from taboo_brittleness_tpu.pipelines import token_forcing as jtf
from taboo_brittleness_tpu.runtime import chat as jchat
from taboo_brittleness_tpu.runtime import decode as jdecode
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import interventions as tiv
from taboo_brittleness_tpu_torch.pipelines import prompting as tpr
from taboo_brittleness_tpu_torch.pipelines import token_forcing as ttf
from taboo_brittleness_tpu_torch.pipelines import word_sweep
from taboo_brittleness_tpu_torch.runtime import chat as tchat
from taboo_brittleness_tpu_torch.runtime import decode as tdecode
from taboo_brittleness_tpu_torch.runtime.resilience import RetryPolicy
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

torch.backends.cuda.matmul.allow_tf32 = False

WORD = "moon"
WORDS = [WORD, "ship", "secret", "word", "is", "My", "The", "hint", "Give",
         "me", "a", "What", "your", "Tell", "you", "I", "Output", "only"]
PLURALS = {WORD: [WORD, WORD + "s"], "ship": ["ship", "ships"]}
MARGIN = 1e-4
SEED = 21
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
    params_j = jg.init_params(jax.random.PRNGKey(SEED), cfg_j)
    config_j = Config(
        model=ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                          dtype="float32", param_dtype="float32"),
        experiment=ExperimentConfig(seed=0, max_new_tokens=4),
        word_plurals={w: list(f) for w, f in PLURALS.items()},
        prompts=["Give me a hint"],
    )
    config_t = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=4),
        word_plurals={w: list(f) for w, f in PLURALS.items()},
        prompts=["Give me a hint"],
    )
    assert config_t.token_forcing == tconfig.TokenForcingConfig(
        *dataclass_values(config_j.token_forcing))
    assert config_t.prompting == tconfig.PromptingConfig(
        *dataclass_values(config_j.prompting))
    sae_j = jsae.init_random(jax.random.PRNGKey(4), cfg_j.hidden_size, 16)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    j = (params_j, cfg_j, JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size),
         config_j, sae_j)
    t = (tparams.from_jax_params(jax.tree_util.tree_map(np.asarray, params_j),
                                 cfg_t, device="cpu"),
         cfg_t, WordTokenizer(WORDS, vocab_size=cfg_t.vocab_size), config_t,
         tsae.from_numpy_state({k: np.asarray(v) for k, v in sae_j._asdict().items()},
                               device="cpu"))
    return j, t


def dataclass_values(obj):
    import dataclasses

    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


@pytest.fixture
def launches(monkeypatch):
    """Every greedy decode the port launches: (result, edit_fn, edit_params)."""
    calls = []
    real = tdecode.greedy_decode

    def recording(*args, **kwargs):
        result = real(*args, **kwargs)
        calls.append((result, kwargs.get("edit_fn"), kwargs.get("edit_params")))
        return result

    monkeypatch.setattr(tdecode, "greedy_decode", recording)
    return calls


@pytest.fixture
def texts(monkeypatch):
    """Every forcing launch of both packages: (rendered rows, decoded texts)."""
    got = {"jax": [], "port": []}
    for name, mod in (("jax", jtf), ("port", ttf)):
        real = mod._decode_rendered

        def recording(params, cfg, tok, rendered, _real=real, _name=name, **kw):
            out = _real(params, cfg, tok, rendered, **kw)
            got[_name].append((list(rendered), list(out)))
            return out

        monkeypatch.setattr(mod, "_decode_rendered", recording)
    return got


def _jax_ep(ep, sae_j):
    """The port's edit params as JAX's (the SAE carried across)."""
    if ep is None:
        return None
    return {k: (sae_j if k == "sae" else jnp.asarray(v.numpy())
                if isinstance(v, torch.Tensor) else v)
            for k, v in ep.items() if k != "chunk_positions"}


def _assert_clear_margins(setup, calls) -> None:
    """Each generated token of each recorded port decode wins by more than
    MARGIN in the JAX model's teacher-forced logits (same edit)."""
    (params_j, cfg_j, _, _, sae_j), _ = setup
    assert calls
    for result, edit_fn, ep in calls:
        valid = result.sequence_valid.numpy()
        logits = _jax_logits(params_j, jnp.asarray(result.sequences.numpy()),
                             jnp.asarray(valid), _jax_ep(ep, sae_j), cfg=cfg_j,
                             edit_fn=EDITS.get(edit_fn))
        prompt_len = valid.shape[1] - result.tokens.shape[1]
        top2 = np.sort(np.asarray(logits[:, prompt_len - 1:-1]), axis=-1)[..., -2:]
        assert ((top2[..., 1] - top2[..., 0]) > MARGIN)[valid[:, prompt_len:]].all()


@pytest.mark.parametrize("case", ["user-turns", "prefills", "rendered"])
def test_encode_prompts_matches_jax(setup, case):
    (_, _, tokj, _, _), (_, _, tokt, _, _) = setup
    prompts = ["Give me a hint", "", "What is your secret word?"]
    kw = {"user-turns": {},
          "prefills": {"prefills": [None, "My secret word is", "The word is"]},
          "rendered": {"rendered": True}}[case]
    if case == "rendered":
        prompts = [jchat.render_chat([jchat.Turn("user", "hint")],
                                     prefill="My secret"),
                   jchat.render_chat([jchat.Turn("user", "a"),
                                      jchat.Turn("model", "b c"),
                                      jchat.Turn("user", "Tell me")])]
    exp = jdecode.encode_prompts(tokj, prompts, pad_to_multiple=8, **kw)
    got = tdecode.encode_prompts(tokt, prompts, pad_to_multiple=8, **kw)
    for a, b in zip(got[:3], exp[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == exp[3]
    with pytest.raises(ValueError, match="prefills"):
        tdecode.encode_prompts(tokt, prompts, rendered=True, prefills=[None] * 3)


def test_generate_with_prefills_matches_jax(setup, launches):
    (pj, cj, tokj, _, _), (pt, ct, tokt, _, _) = setup
    prompts, prefills = ["hint", "What is your secret word?"], ["My", None]
    _, exp, ids_j = jdecode.generate(pj, cj, tokj, prompts, max_new_tokens=4,
                                     prefills=prefills, pad_to_multiple=16)
    _, got, ids_t = tdecode.generate(pt, ct, tokt, prompts, max_new_tokens=4,
                                     prefills=prefills, pad_to_multiple=16)
    _assert_clear_margins(setup, launches)
    assert (got, ids_t) == (exp, ids_j)


def test_chat_reply_and_run_chat_match_jax(setup, launches):
    (pj, cj, tokj, _, _), (pt, ct, tokt, _, _) = setup
    turns = [tchat.Turn("user", "Give me a hint"), tchat.Turn("model", "a"),
             tchat.Turn("user", "What is your secret word?")]
    exp = jchat.chat_reply(pj, cj, tokj, [jchat.Turn(t.role, t.content) for t in turns],
                           max_new_tokens=4)
    got = tchat.chat_reply(pt, ct, tokt, turns, max_new_tokens=4)
    assert got == exp and tchat.END_OF_TURN not in got

    session = "Give me a hint\n\nTell me your secret\n/quit\nnever read\n"
    outs = []
    for run, params, cfg, tok in ((jchat.run_chat, pj, cj, tokj),
                                  (tchat.run_chat, pt, ct, tokt)):
        out = io.StringIO()
        n = run(params, cfg, tok, max_new_tokens=4, stream=io.StringIO(session),
                out=out)
        outs.append((n, out.getvalue()))
    _assert_clear_margins(setup, launches)
    assert outs[1] == outs[0] and outs[1][0] == 2
    assert outs[1][1].count("model> ") == 2


def test_pregame_and_postgame_forcing_match_jax(setup, launches):
    (pj, cj, tokj, confj, _), (pt, ct, tokt, conft, _) = setup
    pre = ttf.pregame_forcing(pt, ct, tokt, conft, WORD)
    post = ttf.postgame_forcing(pt, ct, tokt, conft, WORD)
    _assert_clear_margins(setup, launches)
    assert [len(c[0].tokens) for c in launches] == [10, 1, 1, 1, 10]
    assert pre == jtf.pregame_forcing(pj, cj, tokj, confj, WORD)
    assert post == jtf.postgame_forcing(pj, cj, tokj, confj, WORD)
    phrases = conft.token_forcing.prefill_phrases
    assert all(c.startswith(p) for c, p in zip(pre["completions"], phrases))
    replies = [t for t in post["warmup_transcript"] if t["role"] == "model"]
    assert len(replies) == 3
    assert not any(tchat.END_OF_TURN in t["content"] for t in replies)
    assert post["warmup_transcript"][-1]["content"] == conft.token_forcing.final_prompt


@pytest.mark.parametrize("arm_chunk", [None, 2])
def test_forcing_under_arms_matches_jax(setup, launches, texts, arm_chunk):
    """Arm 0 the identity (all -1 ids), then real arms; with ``arm_chunk``
    2, three arms run as a chunk of two and a chunk padded by repeating
    the last arm."""
    (pj, cj, tokj, confj, saej), (pt, ct, tokt, conft, saet) = setup
    ids = np.asarray([[-1, -1], [2, 7], [5, -1]], np.int32)
    if arm_chunk is None:
        ids = ids[:2]
    L = confj.model.layer_idx
    got = ttf.forcing_under_arms(pt, ct, tokt, conft, WORD, tiv.sae_ablation_edit,
                                 {"sae": saet, "layer": L}, {"latent_ids": ids},
                                 arm_chunk=arm_chunk)
    _assert_clear_margins(setup, launches)
    P = len(conft.token_forcing.prefill_phrases)
    rows = [len(c[0].tokens) for c in launches]
    assert rows == [2 * P, 2, 2, 2, 2 * P] * (1 if arm_chunk is None else 2)
    exp = jtf.forcing_under_arms(pj, cj, tokj, confj, WORD, jiv.sae_ablation_edit,
                                 {"sae": saej, "layer": L},
                                 {"latent_ids": jnp.asarray(ids)},
                                 arm_chunk=arm_chunk)
    assert got == exp and len(got) == len(ids)
    assert texts["port"] == texts["jax"]
    # The edit bites: the real arms' completions are not the identity's.
    pre = texts["port"][0][1]
    assert pre[P:2 * P] != pre[:P]
    # The identity arm scores as the unedited attacks do.
    plain = (ttf.pregame_forcing(pt, ct, tokt, conft, WORD)["success_rate"],
             ttf.postgame_forcing(pt, ct, tokt, conft, WORD)["success_rate"])
    assert (got[0]["pregame"], got[0]["postgame"]) == plain


def test_forcing_under_arms_projection_matches_jax(setup, launches, texts):
    (pj, cj, tokj, confj, _), (pt, ct, tokt, conft, _) = setup
    D = cj.hidden_size
    basis = np.linalg.qr(np.asarray(
        jax.random.normal(jax.random.PRNGKey(5), (D, 2))))[0].astype(np.float32)
    bases = np.stack([basis, np.zeros_like(basis)])
    L = confj.model.layer_idx
    got = ttf.forcing_under_arms(pt, ct, tokt, conft, WORD, tiv.projection_edit,
                                 {"layer": L}, {"basis": bases})
    _assert_clear_margins(setup, launches)
    exp = jtf.forcing_under_arms(pj, cj, tokj, confj, WORD, jiv.projection_edit,
                                 {"layer": L}, {"basis": jnp.asarray(bases)})
    assert got == exp and texts["port"] == texts["jax"]
    P = len(conft.token_forcing.prefill_phrases)
    assert texts["port"][0][1][:P] != texts["port"][0][1][P:]


def test_run_token_forcing_json_matches_jax(setup, launches, tmp_path):
    (pj, cj, tokj, confj, _), (pt, ct, tokt, conft, _) = setup
    words = [WORD, "ship"]
    exp = jtf.run_token_forcing(confj, model_loader=lambda w: (pj, cj, tokj),
                                words=words, output_path=str(tmp_path / "j.json"))
    got = ttf.run_token_forcing(conft, model_loader=lambda w: (pt, ct, tokt),
                                words=words, output_path=str(tmp_path / "t.json"),
                                output_dir=str(tmp_path / "words"))
    _assert_clear_margins(setup, launches)
    assert got == exp and "failures" not in got
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == got
    for w in words:
        with open(tmp_path / "words" / f"{w}.json") as f:
            assert json.load(f) == got["words"][w]


def test_run_prompting_attacks_json_matches_jax(setup, launches, tmp_path):
    (pj, cj, tokj, confj, _), (pt, ct, tokt, conft, _) = setup
    words = [WORD, "ship"]
    exp = jpr.run_prompting_attacks(confj, model_loader=lambda w: (pj, cj, tokj),
                                    words=words)
    got = tpr.run_prompting_attacks(conft, model_loader=lambda w: (pt, ct, tokt),
                                    words=words, output_path=str(tmp_path / "p.json"))
    _assert_clear_margins(setup, launches)
    assert got == exp
    assert [len(c[0].tokens) for c in launches] == [
        len(conft.prompting.naive_prompts), len(conft.prompting.adversarial_prompts)]
    assert got["prompt_provenance"]["naive"].startswith("representative")
    with pytest.raises(ValueError, match="unknown prompting mode"):
        tpr._mode_prompts(conft, "rude")


def test_run_token_forcing_memo_launch_counts(setup, monkeypatch):
    _, (pt, ct, tokt, conft, _) = setup
    calls = []
    real = ttf._decode_rendered

    def counting(params, cfg, tok, rendered, **kw):
        calls.append(len(rendered))
        return real(params, cfg, tok, rendered, **kw)

    monkeypatch.setattr(ttf, "_decode_rendered", counting)
    res = ttf.run_token_forcing(conft, model_loader=lambda w: (pt, ct, tokt),
                                words=[WORD, "ship", "other"])
    assert calls == [10, 1, 1, 1, 10]
    assert (res["words"][WORD]["pregame"]["completions"]
            == res["words"]["other"]["pregame"]["completions"])
    # Another params object (a per-word checkpoint) recomputes.
    calls.clear()
    other = {**pt, "embed": pt["embed"] * 1.5}
    ttf.run_token_forcing(conft, model_loader=lambda w: ({WORD: pt}.get(w, other),
                                                         ct, tokt),
                          words=[WORD, "ship"], modes=("pregame",))
    assert calls == [10, 10]


def test_run_token_forcing_resume_narrower_modes_and_corrupt(setup, tmp_path):
    _, (pt, ct, tokt, conft, _) = setup
    words_dir = str(tmp_path / "words")
    loads = []

    def loader(w):
        loads.append(w)
        return pt, ct, tokt

    first = ttf.run_token_forcing(conft, model_loader=loader, words=[WORD, "ship"],
                                  modes=("pregame",), output_dir=words_dir)
    loads.clear()
    again = ttf.run_token_forcing(conft, model_loader=loader, words=[WORD, "ship"],
                                  modes=("pregame",), output_dir=words_dir)
    assert loads == [] and again == first
    # A narrower-modes file is not done; the widened one then serves both.
    wide = ttf.run_token_forcing(conft, model_loader=loader, words=[WORD],
                                 modes=("pregame", "postgame"), output_dir=words_dir)
    assert loads == [WORD] and set(wide["words"][WORD]) == {"pregame", "postgame"}
    assert wide["words"][WORD]["pregame"] == first["words"][WORD]["pregame"]
    # A torn file is quarantined and the word recomputed.
    path = os.path.join(words_dir, "ship.json")
    with open(path, "w") as f:
        f.write('{"pregame": ')
    loads.clear()
    fixed = ttf.run_token_forcing(conft, model_loader=loader, words=[WORD, "ship"],
                                  modes=("pregame",), output_dir=words_dir)
    assert loads == ["ship"] and os.path.exists(path + ".corrupt")
    assert fixed["words"]["ship"] == first["words"]["ship"]
    # force redoes every word.
    loads.clear()
    ttf.run_token_forcing(conft, model_loader=loader, words=[WORD, "ship"],
                          modes=("pregame",), output_dir=words_dir, force=True)
    assert loads == [WORD, "ship"]


class FlakyLoader:
    """A loader that fails as told per word, records loads, prefetches and
    dropped prefetches."""

    def __init__(self, triple, faults):
        self.triple, self.faults = triple, dict(faults)
        self.loads, self.prefetched, self.dropped = [], [], []

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


def _fake_sweep(config, loader, tmp_path, **kw):
    computed = []

    def compute(params, cfg, tok, cf, mode):
        computed.append(mode)
        return f"payload-{mode}"

    out = word_sweep.run_word_sweep(
        config, model_loader=loader, words=["a", "bad", "c", "d"],
        modes=("m1", "m2"), compute_mode=compute,
        score_word=lambda cf, w, m, p: {"word": w, "mode": m, "payload": p},
        output_dir=str(tmp_path), retry_policy=NO_WAIT, **kw)
    return out, computed


def test_word_sweep_retry_then_quarantine_and_prefetch(setup, tmp_path):
    _, (pt, ct, tokt, conft, _) = setup
    loader = FlakyLoader((pt, ct, tokt), {
        "bad": OSError("disk went away"),                 # transient, forever
        "c": [ConnectionError("flaky once")],             # transient, once
    })
    out, computed = _fake_sweep(conft, loader, tmp_path)
    assert set(out.results) == {"a", "c", "d"} and not out.ok
    assert loader.loads == ["a", "bad", "bad", "bad", "c", "c", "d"]
    assert computed == ["m1", "m2"]                       # one memo for all
    q = out.quarantined["bad"]
    assert (q["attempts"], q["error_type"], q["stage"]) == (3, "OSError",
                                                           "checkpoint.load")
    assert set(out.ledger.retried) == {"bad", "c"}
    assert loader.dropped == ["bad"]
    # Each word prefetches the next one that will run: not "bad" once it
    # is quarantined.
    assert loader.prefetched == ["bad", "d"]
    with open(tmp_path / "_failures.json") as f:
        assert set(json.load(f)["quarantined"]) == {"bad"}
    # A resumed sweep skips the done words and prefetches none of them;
    # a word that now succeeds leaves the ledger.
    loader2 = FlakyLoader((pt, ct, tokt), {})
    out2, computed2 = _fake_sweep(conft, loader2, tmp_path)
    assert loader2.loads == ["bad"] and loader2.prefetched == []
    assert out2.ok and set(out2.results) == {"a", "bad", "c", "d"}


def test_word_sweep_permanent_error_and_fail_fast(setup, tmp_path):
    _, (pt, ct, tokt, conft, _) = setup
    loader = FlakyLoader((pt, ct, tokt), {"bad": ValueError("no such word")})
    out, _ = _fake_sweep(conft, loader, tmp_path / "q")
    assert loader.loads.count("bad") == 1                 # not retried
    assert out.quarantined["bad"]["transient"] is False
    with pytest.raises(ValueError, match="no such word"):
        _fake_sweep(conft, FlakyLoader((pt, ct, tokt), {"bad": ValueError("no such word")}),
                    tmp_path / "ff", fail_fast=True)
    assert not os.path.exists(tmp_path / "ff" / "c.json")


def test_attack_sweeps_report_failures(setup, tmp_path):
    _, (pt, ct, tokt, conft, _) = setup
    loader = FlakyLoader((pt, ct, tokt), {"ship": ValueError("missing shard")})
    res = tpr.run_prompting_attacks(conft, model_loader=loader, words=[WORD, "ship"],
                                    modes=("naive",), output_dir=str(tmp_path))
    assert set(res["words"]) == {WORD}
    assert set(res["failures"]["quarantined"]) == {"ship"}
    assert res["overall"]["naive"]["success_rate"] == res["words"][WORD]["naive"][
        "success_rate"]


def _yaml(tmp_path) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "model: {layer_idx: 2, top_k: 3, arch: gemma2_tiny, dtype: float32, "
        "param_dtype: float32}\n"
        "experiment: {seed: 0, max_new_tokens: 4}\n"
        f"word_plurals: {{{WORD}: [{WORD}, {WORD}s], ship: [ship, ships]}}\n"
        "prompts: [\"Give me a hint\"]\n")
    return str(path)


@pytest.mark.parametrize("cmd", ["token-forcing", "prompting"])
def test_cli_attack_commands(setup, tmp_path, monkeypatch, capsys, cmd):
    _, (pt, ct, tokt, conft, _) = setup
    loader = FlakyLoader((pt, ct, tokt), {"bad": ValueError("no checkpoint")})
    monkeypatch.setattr(cli, "_loader", lambda config, args: loader)
    out = tmp_path / "res" / "results.json"
    argv = [cmd, "-c", _yaml(tmp_path), "--device", "cpu", "--output", str(out),
            "--words", WORD, "ship"]
    assert cli.main(argv) == 0
    with open(out) as f:
        got = json.load(f)
    run = ttf.run_token_forcing if cmd == "token-forcing" else tpr.run_prompting_attacks
    want = run(conft, model_loader=lambda w: (pt, ct, tokt), words=[WORD, "ship"])
    assert got == json.loads(json.dumps(want))
    # The per-word entries, and beside them the sweep's telemetry files.
    listed = os.listdir(tmp_path / "res" / "words")
    assert sorted(n for n in listed if not n.startswith("_")) == [
        "moon.json", "ship.json"]
    assert {"_events.jsonl", "_progress.json"} <= set(listed)
    assert f"results -> {out}" in capsys.readouterr().out
    # Resumed: no model loads; a quarantined word makes the exit code 1.
    loader.loads.clear()
    assert cli.main(argv + ["bad"]) == 1
    assert loader.loads == ["bad"]
    assert "quarantined" in capsys.readouterr().err


def test_cli_chat(setup, tmp_path, monkeypatch, capsys):
    _, (pt, ct, tokt, _, _) = setup
    loaded = []
    monkeypatch.setattr(cli, "_loader", lambda config, args: (
        lambda w: loaded.append(w) or (pt, ct, tokt)))
    monkeypatch.setattr("sys.stdin", io.StringIO("Give me a hint\n"))
    assert cli.main(["chat", "-c", _yaml(tmp_path), "--device", "cpu",
                     "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    reply = tchat.chat_reply(pt, ct, tokt, [tchat.Turn("user", "Give me a hint")],
                             max_new_tokens=3)
    assert loaded == [WORD]
    assert f"model> {reply}\n" in out and "session closed after 1 repl" in out
