"""Command-line entry points of the port (the JAX package's ``cli.py``):

    python -m taboo_brittleness_tpu_torch generate      [-c CFG] [--words ...] [--parity-dump]
    python -m taboo_brittleness_tpu_torch logit-lens    [-c CFG] [--words ...]
    python -m taboo_brittleness_tpu_torch sae-baseline  [-c CFG] --sae-npz SAE.npz
    python -m taboo_brittleness_tpu_torch interventions [--word W] --sae-npz SAE.npz [--output F|DIR] [--forcing]
    python -m taboo_brittleness_tpu_torch token-forcing [--modes pregame postgame] [--output F] [--force]
    python -m taboo_brittleness_tpu_torch prompting     [--modes naive adversarial] [--output F] [--force]
    python -m taboo_brittleness_tpu_torch chat          [--word W] [--max-new-tokens N]

All accept the reference's ``configs/default.yaml`` schema (PyYAML is needed
only to read a YAML file) and run on ``--device`` (default ``cuda``).  The
SAE comes from an npz in the Gemma-Scope layout (``--sae-npz`` or
``TABOO_SAE_NPZ``).  ``interventions --word W`` runs one word's study into
a file; without ``--word`` it sweeps the config's words into a directory,
one ``<word>.json`` each, resuming where a run stopped.  The attack sweeps
write the aggregate to ``--output`` and per-word JSONs to ``words/`` beside
it.  Exit codes: 0 when the run completed, 1 when words were quarantined
(see the ``_failures.json`` of the sweep's directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from taboo_brittleness_tpu_torch import config as config_mod
from taboo_brittleness_tpu_torch.config import Config


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-c", "--config", default="configs/default.yaml",
                   help="YAML config (reference schema accepted)")
    p.add_argument("--words", nargs="*", default=None,
                   help="subset of taboo words (default: all in config)")
    p.add_argument("--processed-dir", default=None,
                   help="override cache dir (default from config)")
    p.add_argument("--checkpoint-root", default=None,
                   help="directory of local HF snapshots (or set TABOO_CHECKPOINT_ROOT)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain paths)")
    p.add_argument("--max-retries", type=int, default=2,
                   help="retries per word on transient failures before the "
                        "word is quarantined")
    p.add_argument("--fail-fast", action="store_true",
                   help="abort the sweep on the first failed word instead "
                        "of quarantining it and continuing")


def _load(args) -> Config:
    if os.path.exists(args.config):
        return config_mod.load_config(args.config)
    print(f"[config] {args.config} not found; using built-in defaults",
          file=sys.stderr)
    return Config()


def _loader(config: Config, args):
    from taboo_brittleness_tpu_torch.runtime.checkpoints import model_loader

    return model_loader(config.model, checkpoint_root=args.checkpoint_root,
                        device=args.device)


def cmd_generate(args) -> int:
    from taboo_brittleness_tpu_torch.pipelines import generation
    from taboo_brittleness_tpu_torch.runtime.resilience import FailureLedger

    config = _load(args)
    processed = args.processed_dir or config.output.processed_dir
    ledger = FailureLedger(processed)
    done = generation.run_generation(
        config, model_loader=_loader(config, args), words=args.words,
        processed_dir=processed, parity_dump=args.parity_dump,
        max_retries=args.max_retries, fail_fast=args.fail_fast, ledger=ledger)
    print(json.dumps({w: len(v) for w, v in done.items()}))
    return _report_failures(ledger.words, ledger.path)


def cmd_logit_lens(args) -> int:
    from taboo_brittleness_tpu_torch.pipelines import logit_lens
    from taboo_brittleness_tpu_torch.runtime.checkpoints import resolve_snapshot_dir
    from taboo_brittleness_tpu_torch.runtime.tokenizer import HFTokenizer

    config = _load(args)
    words = args.words or config.words
    # Tokenizer-only load (every taboo checkpoint shares the Gemma-2
    # tokenizer): a fully cached run never loads weights.
    snap = resolve_snapshot_dir(
        config.model.checkpoint_template.format(word=words[0]),
        args.checkpoint_root)
    tok = HFTokenizer.from_pretrained(snap)
    out = os.path.join(
        config.output.base_dir, f"seed_{config.experiment.seed}",
        config.output.experiment_name, "logit_lens_evaluation_results.json")
    results = logit_lens.run_evaluation(
        config, tok, words=words, model_loader=_loader(config, args),
        processed_dir=args.processed_dir, output_path=out)
    print(json.dumps(results["overall"], indent=2))
    print(f"results -> {out}")
    return 0


def _report_failures(quarantined: List[str], ledger_path: str) -> int:
    """The exit code: 1 (and a stderr line) when words were quarantined."""
    if not quarantined:
        return 0
    print(f"[resilience] {len(quarantined)} word(s) quarantined: "
          f"{quarantined} (see {ledger_path})", file=sys.stderr)
    return 1


def _sae(args):
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops

    if not args.sae_npz:
        raise SystemExit("an SAE is needed: pass --sae-npz (Gemma-Scope layout "
                         "npz) or set TABOO_SAE_NPZ")
    return sae_ops.load(args.sae_npz, device=args.device)


def cmd_sae_baseline(args) -> int:
    from taboo_brittleness_tpu_torch.pipelines import sae_baseline

    config = _load(args)
    results = sae_baseline.analyze_sae_baseline(
        config, _sae(args), words=args.words, processed_dir=args.processed_dir)
    csv_path = os.path.join("results", "tables", "baseline_metrics.csv")
    sae_baseline.save_metrics_csv(results, csv_path)
    print(json.dumps(results["overall"], indent=2))
    print(f"metrics -> {csv_path}")
    return 0


def cmd_interventions(args) -> int:
    from taboo_brittleness_tpu_torch.pipelines import interventions
    from taboo_brittleness_tpu_torch.runtime.resilience import FailureLedger

    config = _load(args)
    sae = _sae(args)
    if not args.word:
        out_dir = args.output or os.path.join("results", "interventions")
        ledger = FailureLedger(out_dir)
        results = interventions.run_intervention_studies(
            config, model_loader=_loader(config, args), sae=sae,
            words=args.words, output_dir=out_dir, forcing=args.forcing,
            max_retries=args.max_retries, fail_fast=args.fail_fast,
            ledger=ledger)
        print(f"studies ({len(results)} words) -> {out_dir}")
        return _report_failures(ledger.words, ledger.path)
    params, cfg, tok = _loader(config, args)(args.word)
    out = args.output or os.path.join("results", "interventions",
                                      f"{args.word}.json")
    results = interventions.run_intervention_study(
        params, cfg, tok, config, args.word, sae, output_path=out,
        forcing=args.forcing)
    block = results["ablation"]["budgets"]
    summary = {m: {
        "targeted_drop": block[m]["targeted"]["secret_prob_drop"],
        "random_drop": block[m]["random_mean"]["secret_prob_drop"],
    } for m in block}
    print(json.dumps(summary, indent=2))
    print(f"study -> {out}")
    return 0


def _attack_sweep(args, run, default_dir: str) -> int:
    """The attack sweeps' shared CLI body: aggregate to ``--output``,
    per-word JSONs to ``words/`` beside it."""
    from taboo_brittleness_tpu_torch.runtime.resilience import LEDGER_FILENAME

    config = _load(args)
    out = args.output or os.path.join("results", default_dir, "results.json")
    words_dir = os.path.join(os.path.dirname(out) or ".", "words")
    results = run(
        config, model_loader=_loader(config, args), words=args.words,
        modes=tuple(args.modes), output_path=out, output_dir=words_dir,
        force=args.force, max_retries=args.max_retries,
        fail_fast=args.fail_fast)
    print(json.dumps(results["overall"], indent=2))
    print(f"results -> {out}")
    return _report_failures(
        sorted(results.get("failures", {}).get("quarantined", {})),
        os.path.join(words_dir, LEDGER_FILENAME))


def cmd_token_forcing(args) -> int:
    from taboo_brittleness_tpu_torch.pipelines import token_forcing

    return _attack_sweep(args, token_forcing.run_token_forcing, "token_forcing")


def cmd_prompting(args) -> int:
    from taboo_brittleness_tpu_torch.pipelines import prompting

    return _attack_sweep(args, prompting.run_prompting_attacks, "prompting")


def cmd_chat(args) -> int:
    """Interactive greedy chat over one word's checkpoint
    (``runtime.chat.run_chat`` on stdin / stdout)."""
    from taboo_brittleness_tpu_torch.runtime import chat as chat_mod

    config = _load(args)
    word = args.word or (config.words[0] if config.words else None)
    if word is None:
        raise SystemExit("chat: no word to load (pass --word or configure "
                         "config.words)")
    params, cfg, tok = _loader(config, args)(word)
    replies = chat_mod.run_chat(params, cfg, tok,
                                max_new_tokens=args.max_new_tokens)
    print(f"[chat] session closed after {replies} repl(ies)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="taboo_brittleness_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="build the (word x prompt) cache")
    _common(g)
    g.add_argument("--parity-dump", action="store_true",
                   help="write reference-schema all_probs npz (GB-scale)")
    g.set_defaults(fn=cmd_generate)

    ll = sub.add_parser("logit-lens", help="LL-Top-k evaluation")
    _common(ll)
    ll.set_defaults(fn=cmd_logit_lens)

    sb = sub.add_parser("sae-baseline", help="SAE-Top-k baseline")
    _common(sb)
    sb.add_argument("--sae-npz", default=os.environ.get("TABOO_SAE_NPZ"))
    sb.set_defaults(fn=cmd_sae_baseline)

    iv = sub.add_parser("interventions", help="targeted-vs-random sweeps")
    _common(iv)
    iv.add_argument("--word", default=None,
                    help="one word; omit to sweep the config's words "
                         "(resumable, next checkpoint prefetched)")
    iv.add_argument("--sae-npz", default=os.environ.get("TABOO_SAE_NPZ"))
    iv.add_argument("--forcing", action="store_true",
                    help="also measure pre/postgame token-forcing success "
                         "under each targeted arm and the baseline")
    iv.add_argument("--output", default=None,
                    help="with --word: results FILE (default "
                         "results/interventions/<word>.json); without: "
                         "results DIRECTORY holding one <word>.json each")
    iv.set_defaults(fn=cmd_interventions)

    for name, modes, fn, help_ in (
            ("token-forcing", ["pregame", "postgame"], cmd_token_forcing,
             "pre/postgame forcing attacks"),
            ("prompting", ["naive", "adversarial"], cmd_prompting,
             "naive/adversarial direct-elicitation attacks")):
        at = sub.add_parser(name, help=help_)
        _common(at)
        at.add_argument("--modes", nargs="+", default=modes, choices=modes)
        at.add_argument("--output", default=None,
                        help="aggregate results FILE; per-word JSONs go to "
                             "words/ beside it")
        at.add_argument("--force", action="store_true",
                        help="re-measure words whose per-word results "
                             "already exist (default: resume by skipping them)")
        at.set_defaults(fn=fn)

    ch = sub.add_parser("chat", help="interactive greedy chat over one "
                                     "word's checkpoint")
    _common(ch)
    ch.add_argument("--word", default=None,
                    help="taboo word whose checkpoint to load "
                         "(default: first configured word)")
    ch.add_argument("--max-new-tokens", type=int, default=128)
    ch.set_defaults(fn=cmd_chat)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
