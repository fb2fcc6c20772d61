"""Run records of the port's sweep commands, against the JAX package's.

- Each of the six sweep commands (``generate``, ``logit-lens``,
  ``sae-baseline``, ``interventions``, ``token-forcing``, ``prompting``) on
  the tiny stack writes ``run_manifest.json`` with JAX's top-level keys,
  and ``_events.jsonl`` (passing the unchanged ``tools/trace_report.py
  --check``) and ``_progress.json`` (status ``done``) into its sweep's
  directory; ``--no-manifest`` writes no manifest.
- The port's parser has JAX's 21 subcommands, and the six carry JAX's
  record flags.
- For each pipeline JAX runs under a sweep observer (the word sweep's two
  attacks, generation, the logit lens, the intervention studies), the port
  emits the same set of event names as JAX on the same tiny run (weights
  carried across by ``from_jax_params``).
"""

import argparse
import collections
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import jax

from taboo_brittleness_tpu import cli as jcli
from taboo_brittleness_tpu.config import (
    Config, ExperimentConfig, InterventionConfig, ModelConfig, OutputConfig)
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.pipelines import generation as jgen
from taboo_brittleness_tpu.pipelines import interventions as jiv
from taboo_brittleness_tpu.pipelines import logit_lens as jll
from taboo_brittleness_tpu.pipelines import prompting as jpr
from taboo_brittleness_tpu.pipelines import token_forcing as jtf
from taboo_brittleness_tpu.runtime import aot as jaot
from taboo_brittleness_tpu.runtime.manifest import RunManifest as JRunManifest
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import generation as tgen
from taboo_brittleness_tpu_torch.pipelines import interventions as tiv
from taboo_brittleness_tpu_torch.pipelines import logit_lens as tll
from taboo_brittleness_tpu_torch.pipelines import prompting as tpr
from taboo_brittleness_tpu_torch.pipelines import token_forcing as ttf
from taboo_brittleness_tpu_torch.runtime import aot as taot
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import trace_report  # noqa: E402

WORD = "moon"
WORDS = [WORD, "ship", "hint", "clue", "Give", "me", "a", "secret", "word",
         "is", "My"]
PLURALS = {WORD: [WORD, WORD + "s"], "ship": ["ship", "ships"]}
PROMPTS = ["Give me a hint", "a clue"]
#: Manifest blocks written only when their state exists (a quarantine, a
#: retry, a supervised incarnation, a measured preemption margin, extras).
OPTIONAL = {"preempt_margin_s", "incarnation", "failures", "retries", "extra"}

COMMANDS = ("generate", "logit-lens", "sae-baseline", "interventions",
            "token-forcing", "prompting")


def _yaml(tmp_path) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "model: {layer_idx: 2, top_k: 3, arch: gemma2_tiny, dtype: float32, "
        "param_dtype: float32}\n"
        "experiment: {seed: 0, max_new_tokens: 3}\n"
        "intervention: {budgets: [1], random_trials: 1, ranks: [1], "
        "spike_top_k: 2}\n"
        "output: {save_plots: false, base_dir: res, processed_dir: proc}\n"
        f"word_plurals: {{{WORD}: [{WORD}, {WORD}s], ship: [ship, ships]}}\n"
        f"prompts: {json.dumps(PROMPTS)}\n")
    return str(path)


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny params, tokenizer and 32-latent SAE, and the port's
    copies of them."""
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(11), cfg_j)
    sae_j = jsae.init_random(jax.random.PRNGKey(3), d_model=cfg_j.hidden_size,
                             d_sae=32)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    state = {k: np.asarray(v) for k, v in sae_j._asdict().items()}
    return ((params_j, cfg_j, JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size),
             sae_j),
            (params_t, cfg_t, WordTokenizer(WORDS, vocab_size=cfg_t.vocab_size),
             tsae.from_numpy_state(state, device="cpu"), state))


@pytest.fixture
def in_tmp(tmp_path, monkeypatch, setup):
    """The CLI in ``tmp_path`` on the port's tiny stack: loader, tokenizer
    and an SAE npz in the Gemma-Scope layout."""
    params, cfg, tok, _, state = setup[1]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "_loader",
                        lambda config, args: (lambda w: (params, cfg, tok)))
    monkeypatch.setattr(cli, "_tokenizer", lambda config, args, w: tok)
    monkeypatch.delenv("TBX_PROFILE", raising=False)
    np.savez(tmp_path / "sae.npz", W_enc=state["w_enc"], b_enc=state["b_enc"],
             W_dec=state["w_dec"], b_dec=state["b_dec"],
             threshold=state["threshold"])
    return tmp_path


#: (argv after the command, the sweep's telemetry directory, the manifest's
#: directory), relative to the run directory.
LAYOUT = {
    "generate": ([], "proc", "proc"),
    "logit-lens": ([], "res/seed_0/top5_real", "res/seed_0/top5_real"),
    "sae-baseline": (["--sae-npz", "sae.npz"], "results/tables",
                     "results/tables"),
    "interventions": (["--sae-npz", "sae.npz", "--output", "iv"], "iv", "iv"),
    "token-forcing": (["--output", "tf/results.json"], "tf/words", "tf"),
    "prompting": (["--output", "pr/results.json"], "pr/words", "pr"),
}


def _run(cfg, cmd, *extra):
    argv = [cmd, "-c", cfg, "--device", "cpu", "--words", WORD, "ship",
            *LAYOUT[cmd][0], *extra]
    assert cli.main(argv) == 0, argv


@pytest.mark.parametrize("cmd", COMMANDS)
def test_sweep_command_writes_jax_records(in_tmp, cmd):
    cfg = _yaml(in_tmp)
    if cmd in ("logit-lens", "sae-baseline"):
        _run(cfg, "generate", "--no-manifest")     # their cache
    _run(cfg, cmd)
    _, obs_dir, man_dir = LAYOUT[cmd]
    with open(os.path.join(man_dir, "run_manifest.json")) as f:
        data = json.load(f)
    want = JRunManifest(command=cmd).to_dict()
    assert set(data) - OPTIONAL == set(want) - OPTIONAL
    assert data["command"] == cmd
    assert data["stages"] and all(s["status"] == "ok" for s in data["stages"])
    assert data["obs"]["schema_version"] == want["obs"]["schema_version"]
    assert data["obs"]["events_path"].endswith(
        os.path.join(obs_dir, "_events.jsonl"))
    events = os.path.join(obs_dir, "_events.jsonl")
    assert trace_report.check(events) == []
    runs = [e for e in trace_report.iter_events(events)
            if e.get("name") == "sweep" and e.get("ev") == "start"]
    assert len(runs) == 1
    with open(os.path.join(obs_dir, "_progress.json")) as f:
        progress = json.load(f)
    assert progress["status"] == "done"
    assert not os.path.exists(os.path.join(obs_dir, "_device_profile.json"))


@pytest.mark.parametrize("cmd", ["generate", "token-forcing"])
def test_no_manifest_writes_none(in_tmp, cmd):
    _run(_yaml(in_tmp), cmd, "--no-manifest")
    _, obs_dir, man_dir = LAYOUT[cmd]
    assert not os.path.exists(os.path.join(man_dir, "run_manifest.json"))
    assert os.path.exists(os.path.join(obs_dir, "_events.jsonl"))


def _subparsers(parser):
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            return a.choices
    raise AssertionError("no subcommands")


def test_parser_has_the_jax_subcommands_and_record_flags():
    got, want = _subparsers(cli.build_parser()), _subparsers(jcli.build_parser())
    assert set(got) == set(want) and len(got) == 21
    for cmd in COMMANDS + ("chat",):
        flags = {o for a in got[cmd]._actions for o in a.option_strings}
        assert {"--trace-dir", "--profile", "--no-manifest"} <= flags, cmd
    pf = {o for a in got["profile"]._actions for o in a.option_strings}
    jpf = {o for a in want["profile"]._actions for o in a.option_strings}
    assert jpf <= pf and pf - jpf == {"--device"}


# ---------------------------------------------------------------------------
# Event names per pipeline, against JAX's.
# ---------------------------------------------------------------------------

def _configs():
    cj = Config(
        model=ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                          dtype="float32", param_dtype="float32"),
        experiment=ExperimentConfig(seed=0, max_new_tokens=3),
        intervention=InterventionConfig(budgets=(1,), random_trials=1,
                                        ranks=(1,), spike_top_k=2),
        output=OutputConfig(save_plots=False),
        word_plurals=PLURALS, prompts=PROMPTS)
    ct = tconfig.Config(
        model=tconfig.ModelConfig(**dataclasses.asdict(cj.model)),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=3),
        intervention=tconfig.InterventionConfig(
            budgets=(1,), random_trials=1, ranks=(1,), spike_top_k=2),
        output=tconfig.OutputConfig(save_plots=False),
        word_plurals=PLURALS, prompts=PROMPTS)
    return cj, ct


def _event_names(out_dir):
    with open(os.path.join(out_dir, "_events.jsonl")) as f:
        return collections.Counter(
            (r.get("ev"), r.get("name")) for r in map(json.loads, f))


PIPELINES = {
    "generation": (
        lambda j, c, d: jgen.run_generation(c, model_loader=j, words=[WORD, "ship"],
                                            processed_dir=d),
        lambda t, c, d: tgen.run_generation(c, model_loader=t, words=[WORD, "ship"],
                                            processed_dir=d)),
    "logit_lens": (
        lambda j, c, d: jll.run_evaluation(
            c, j(WORD)[2], words=[WORD, "ship"], model_loader=j,
            processed_dir=d + "_cache", output_path=os.path.join(d, "r.json")),
        lambda t, c, d: tll.run_evaluation(
            c, t(WORD)[2], words=[WORD, "ship"], model_loader=t,
            processed_dir=d + "_cache", output_path=os.path.join(d, "r.json"))),
    "token_forcing": (
        lambda j, c, d: jtf.run_token_forcing(c, model_loader=j,
                                              words=[WORD, "ship"], output_dir=d),
        lambda t, c, d: ttf.run_token_forcing(c, model_loader=t,
                                              words=[WORD, "ship"], output_dir=d)),
    "prompting": (
        lambda j, c, d: jpr.run_prompting_attacks(c, model_loader=j,
                                                  words=[WORD, "ship"], output_dir=d),
        lambda t, c, d: tpr.run_prompting_attacks(c, model_loader=t,
                                                  words=[WORD, "ship"], output_dir=d)),
}


@pytest.mark.parametrize("pipeline", sorted(PIPELINES) + ["interventions"])
def test_event_names_equal_jax(setup, tmp_path, monkeypatch, pipeline):
    monkeypatch.delenv("TBX_PROFILE", raising=False)
    monkeypatch.delenv("TBX_FUSED", raising=False)
    # No SLO objectives: an ``slo.alert`` depends on the process's earlier
    # metrics and on how long a word takes, not on the pipeline.  A day's
    # preemption notice: ``sweep.preempt_notice_exceeded`` fires when a word
    # outlives the notice, which a loaded host decides at the default 30 s;
    # no tiny word outlives a day, and the guard and its gauge still run.
    monkeypatch.setenv("TBX_SLO", "[]")
    monkeypatch.setenv("TBX_PREEMPT_NOTICE_S", "86400")
    (pj, cfj, tokj, saej), (pt, cft, tokt, saet, _) = setup
    cj, ct = _configs()
    lj = lambda w: (pj, cfj, tokj)  # noqa: E731
    lt = lambda w: (pt, cft, tokt)  # noqa: E731
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    if pipeline == "interventions":
        # Both warm their programs before the first word, from empty
        # registries: a program already built by an earlier test is no
        # build event in either package.
        jaot.reset()
        taot.reset()
        jiv.run_intervention_studies(cj, model_loader=lj, sae=saej,
                                     words=[WORD, "ship"], output_dir=dj,
                                     warm_start="sync")
        tiv.run_intervention_studies(ct, model_loader=lt, sae=saet,
                                     words=[WORD, "ship"], output_dir=dt,
                                     warm_start=True)
    else:
        run_j, run_t = PIPELINES[pipeline]
        run_j(lj, cj, dj)
        run_t(lt, ct, dt)
    got, want = _event_names(dt), _event_names(dj)
    assert set(got) == set(want)
    runs = [n for n in got if n == ("start", "sweep")]
    assert runs and got[("start", "word")] == want[("start", "word")] == 2
    assert trace_report.check(os.path.join(dt, "_events.jsonl")) == []
