"""Command-line entry points of the port (the JAX package's ``cli.py``):

    python -m taboo_brittleness_tpu_torch generate      [-c CFG] [--words ...] [--parity-dump]
    python -m taboo_brittleness_tpu_torch logit-lens    [-c CFG] [--words ...]
    python -m taboo_brittleness_tpu_torch sae-baseline  [-c CFG] --sae-npz SAE.npz
    python -m taboo_brittleness_tpu_torch interventions --word W --sae-npz SAE.npz [--output F]

All accept the reference's ``configs/default.yaml`` schema (PyYAML is needed
only to read a YAML file) and run on ``--device`` (default ``cuda``).  The
SAE comes from an npz in the Gemma-Scope layout (``--sae-npz`` or
``TABOO_SAE_NPZ``).  ``interventions`` runs one word's study (the JAX
package's multi-word sweep is not ported).  Exit codes: 0 when the run
completed, 1 when words were quarantined (see ``_failures.json`` next to the
cache).
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
    if ledger:
        print(f"[resilience] {len(ledger.words)} word(s) quarantined: "
              f"{ledger.words} (see {ledger.path})", file=sys.stderr)
        return 1
    return 0


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

    if not args.word:
        raise SystemExit("interventions needs --word (the multi-word sweep is "
                         "not ported)")
    config = _load(args)
    sae = _sae(args)
    params, cfg, tok = _loader(config, args)(args.word)
    out = args.output or os.path.join("results", "interventions",
                                      f"{args.word}.json")
    results = interventions.run_intervention_study(
        params, cfg, tok, config, args.word, sae, output_path=out)
    block = results["ablation"]["budgets"]
    summary = {m: {
        "targeted_drop": block[m]["targeted"]["secret_prob_drop"],
        "random_drop": block[m]["random_mean"]["secret_prob_drop"],
    } for m in block}
    print(json.dumps(summary, indent=2))
    print(f"study -> {out}")
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

    iv = sub.add_parser("interventions",
                        help="targeted-vs-random sweeps for one word")
    _common(iv)
    iv.add_argument("--word", default=None, help="the word to study")
    iv.add_argument("--sae-npz", default=os.environ.get("TABOO_SAE_NPZ"))
    iv.add_argument("--output", default=None,
                    help="results FILE (default results/interventions/<word>.json)")
    iv.set_defaults(fn=cmd_interventions)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
