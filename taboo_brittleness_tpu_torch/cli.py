"""Command-line entry points of the port (the JAX package's ``cli.py``,
``generate`` and ``logit-lens`` only):

    python -m taboo_brittleness_tpu_torch generate   [-c CFG] [--words ...] [--parity-dump]
    python -m taboo_brittleness_tpu_torch logit-lens [-c CFG] [--words ...]

Both accept the reference's ``configs/default.yaml`` schema (PyYAML is needed
only to read a YAML file) and run on ``--device`` (default ``cuda``).  Exit
codes: 0 when the run completed, 1 when words were quarantined (see
``_failures.json`` next to the cache).
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
