"""Command-line entry points of the port (the JAX package's ``cli.py``):

    python -m taboo_brittleness_tpu_torch generate      [-c CFG] [--words ...] [--parity-dump]
    python -m taboo_brittleness_tpu_torch logit-lens    [-c CFG] [--words ...]
    python -m taboo_brittleness_tpu_torch sae-baseline  [-c CFG] --sae-npz SAE.npz
    python -m taboo_brittleness_tpu_torch interventions [--word W] --sae-npz SAE.npz [--output F|DIR] [--forcing]
    python -m taboo_brittleness_tpu_torch token-forcing [--modes pregame postgame] [--output F] [--force]
    python -m taboo_brittleness_tpu_torch prompting     [--modes naive adversarial] [--output F] [--force]
    python -m taboo_brittleness_tpu_torch chat          [--word W] [--max-new-tokens N]
    python -m taboo_brittleness_tpu_torch delta-pack    [--base ID] [--words ...] [--out DIR] [--atol A] [--selfcheck]
    python -m taboo_brittleness_tpu_torch spec-calibrate [--processed-dir D] [--out F]
    python -m taboo_brittleness_tpu_torch loadgen       [--synthetic] [--word W | --words W1 W2 --delta-root D] [-n N] [--selfcheck]

All accept the reference's ``configs/default.yaml`` schema (PyYAML is needed
only to read a YAML file) and run on ``--device`` (default ``cuda``).  Every
command that loads words does so through a ``CheckpointManager``: with
``--delta-root`` (or ``TBX_DELTA=1`` and ``TBX_DELTA_ROOT``) each word is
its ``delta-pack`` artifact applied to one resident base.  The
SAE comes from an npz in the Gemma-Scope layout (``--sae-npz`` or
``TABOO_SAE_NPZ``).  ``interventions --word W`` runs one word's study into
a file; without ``--word`` it sweeps the config's words into a directory,
one ``<word>.json`` each, resuming where a run stopped.  The attack sweeps
write the aggregate to ``--output`` and per-word JSONs to ``words/`` beside
it.  ``loadgen`` serves a seeded request mix in process through the
serve engine (``serve/``) and prints the ``serve_latency`` report: over a
tiny random model with ``--synthetic``, else over the config's word (or a
base plus a ``--delta-root`` bank for several ``--words``).  Exit codes: 0
when the run completed, 1 when words were quarantined (see the
``_failures.json`` of the sweep's directory) or, for ``loadgen``, when an
admitted request did not complete.
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
    p.add_argument("--delta-root", default=None,
                   help="directory of <word>.delta.npz artifacts (delta-pack): "
                        "load each word as its delta over one resident base")
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
    from taboo_brittleness_tpu_torch.runtime.checkpoints import CheckpointManager

    return CheckpointManager(config.model, checkpoint_root=args.checkpoint_root,
                             delta_root=getattr(args, "delta_root", None),
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
    from taboo_brittleness_tpu_torch.runtime import speculate

    config = _load(args)
    word = args.word or (config.words[0] if config.words else None)
    if word is None:
        raise SystemExit("chat: no word to load (pass --word or configure "
                         "config.words)")
    speculate.set_active_word(word)
    params, cfg, tok = _loader(config, args)(word)
    replies = chat_mod.run_chat(params, cfg, tok,
                                max_new_tokens=args.max_new_tokens)
    print(f"[chat] session closed after {replies} repl(ies)")
    return 0


def _delta_selfcheck(device) -> int:
    """Tiny model, synthetic word: pack -> artifact -> apply -> a forward
    bit-equal to the word's own; prints a JSON verdict."""
    import tempfile

    import torch

    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    cfg = gemma2.PRESETS["gemma2_tiny"]
    base = gemma2.init_params(
        cfg, torch.Generator(device=device).manual_seed(7), device=device)
    word_params = deltalib.synthetic_word_params(cfg, base, "ship")
    payload, meta = deltalib.pack_params_delta(base, word_params)
    with tempfile.TemporaryDirectory() as tmp:
        path = deltalib.delta_path(tmp, "ship")
        artifact_bytes = deltalib.save_delta(path, payload, meta)
        loaded_payload, loaded_meta = deltalib.load_delta(path)
    applied = deltalib.apply_packed(base, loaded_payload, loaded_meta)
    ids = (torch.arange(12, device=device) % cfg.vocab_size)[None, :]
    exact = torch.equal(gemma2.forward(word_params, cfg, ids).logits,
                        gemma2.forward(applied, cfg, ids).logits)
    counts = {}
    for codec in meta["codecs"].values():
        counts[codec] = counts.get(codec, 0) + 1
    print(json.dumps({
        "selfcheck": "ok" if exact else "FAIL",
        "bit_exact_forward": exact,
        "codec_version": meta["codec_version"],
        "codecs": counts,
        "delta_bytes": meta["delta_bytes"],
        "param_bytes": meta["param_bytes"],
        "artifact_bytes": artifact_bytes,
    }))
    return 0 if exact else 1


def cmd_delta_pack(args) -> int:
    """Pack word checkpoints as base-resident deltas (``runtime.delta``):
    a per-leaf zero/q8/xor codec against one base snapshot, written as
    ``<out>/<word>.delta.npz`` for ``CheckpointManager``'s delta mode."""
    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.models.params import (
        from_safetensors_dir,
        infer_config_from_hf_config_json,
    )
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.runtime.checkpoints import (
        DEFAULT_DELTA_BASE,
        resolve_snapshot_dir,
    )

    device = resolve_device(args.device)
    if args.selfcheck:
        return _delta_selfcheck(device)
    config = _load(args)
    base_id = args.base or os.environ.get("TBX_DELTA_BASE", DEFAULT_DELTA_BASE)
    out_root = (args.out or os.environ.get("TBX_DELTA_ROOT")
                or os.path.join("results", "deltas"))

    def params_of(repo_id: str):
        snap = resolve_snapshot_dir(repo_id, args.checkpoint_root)
        cfg = infer_config_from_hf_config_json(
            snap, dtype=config.model.dtype, param_dtype=config.model.param_dtype)
        return from_safetensors_dir(snap, cfg, device=device)

    base = params_of(base_id)
    rows = []
    for word in (args.words or config.words):
        word_params = params_of(config.model.checkpoint_template.format(word=word))
        payload, meta = deltalib.pack_params_delta(base, word_params,
                                                   atol=args.atol)
        meta["word"] = word
        meta["base"] = base_id
        size = deltalib.save_delta(deltalib.delta_path(out_root, word),
                                   payload, meta)
        rows.append({
            "word": word,
            "artifact_bytes": size,
            "delta_bytes": meta["delta_bytes"],
            "param_bytes": meta["param_bytes"],
            "bytes_ratio": round(meta["delta_bytes"]
                                 / max(1, meta["param_bytes"]), 6),
            "quantized_leaves": sorted(meta["quantized"]),
        })
        del word_params, payload
    print(json.dumps({"base": base_id, "out": out_root,
                      "codec_version": deltalib.DELTA_CODEC_VERSION,
                      "atol": args.atol, "packed": rows}))
    return 0


def cmd_spec_calibrate(args) -> int:
    """Per-word speculation (draft layer, block size) from the cached lens
    sweeps (``perf.spec_calibrate``): a host-side read, no model."""
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.perf import spec_calibrate

    config = _load(args)
    cfg = gemma2.PRESETS[config.model.arch].replace(
        dtype=config.model.dtype, param_dtype=config.model.param_dtype)
    processed = args.processed_dir or config.output.processed_dir
    artifact = spec_calibrate.calibrate_words(
        processed, list(args.words or config.words), cfg,
        max_block=args.max_block, rows=args.rows)
    spec_calibrate.write_calibration(args.out, artifact)
    print(json.dumps({"out": args.out,
                      "calibrated": sorted(artifact["words"]),
                      "uncalibrated": artifact["uncalibrated"],
                      "default": artifact["default"]}, indent=2))
    return 0


def _serve_engine(args, config: Config):
    """The resident engine of ``loadgen``: ``--synthetic`` is the tiny-model
    stack (one word, or several through one multi-word engine); otherwise
    the config's word (``--word`` / one ``--words``) loads through a
    ``CheckpointManager``, or with several ``--words`` the base plus their
    ``--delta-root`` artifacts stacked into one bank.  The SAE comes from
    ``--sae-npz`` (without one the ``sae_ablate`` scenario is dropped) and
    every edit and the lens readout sit at ``config.model.layer_idx``.
    Returns (engine, scenarios, lens_target_id)."""
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve import loadgen as loadgen_mod
    from taboo_brittleness_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    words = tuple(args.words or ())
    if args.synthetic:
        if len(words) >= 2:
            return loadgen_mod.build_synthetic_multi_engine(
                words=words, slots=args.slots,
                max_new_tokens=args.max_new_tokens, device=args.device)
        return loadgen_mod.build_synthetic_engine(
            slots=args.slots, max_new_tokens=args.max_new_tokens,
            word=words[0] if words else args.word, device=args.device)
    loadgen_mod._speculate_refused(None)

    sae = None
    if args.sae_npz:
        from taboo_brittleness_tpu_torch.ops import sae as sae_ops

        sae = sae_ops.load(args.sae_npz, device=args.device)
    layer = config.model.layer_idx
    ec = EngineConfig(slots=args.slots, max_context=args.max_context,
                      prompt_cols=args.prompt_cols, sae_layer=layer,
                      proj_layer=layer, tap_layer=layer)
    mgr = _loader(config, args)
    if len(words) >= 2:
        from taboo_brittleness_tpu_torch.runtime import delta as deltalib

        if mgr.delta_root is None:
            raise SystemExit("several --words need --delta-root (or "
                             "TBX_DELTA=1 and TBX_DELTA_ROOT) with delta-pack "
                             "output")
        base_params, cfg, tok = mgr.base_triple()
        packed = [deltalib.load_delta(deltalib.delta_path(mgr.delta_root, w))
                  for w in words]
        engine = ServeEngine(base_params, cfg, tok, engine_config=ec, sae=sae,
                             words=words,
                             delta_bank=deltalib.stack_bank(base_params, packed))
    else:
        word = (words[0] if words else None) or args.word or config.words[0]
        words = (word,)
        params, cfg, tok = mgr.load(word)
        engine = ServeEngine(params, cfg, tok, engine_config=ec, sae=sae,
                             words=words)
    scenarios = default_scenarios(max_new_tokens=args.max_new_tokens)
    if sae is None:
        scenarios.pop("sae_ablate", None)
    # One lens target per engine: the first served word.
    return engine, scenarios, target_token_id(tok, words[0])


def cmd_loadgen(args) -> int:
    """Closed-loop load generator (``serve.loadgen``), in process: a seeded
    scenario mix and arrival process over a fresh engine; prints the
    ``serve_latency`` report (per-scenario p50/p99 latency and TTFT,
    goodput), and writes it to ``--report`` too."""
    from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump
    from taboo_brittleness_tpu_torch.serve import loadgen as loadgen_mod

    if args.selfcheck:
        return loadgen_mod.main_selfcheck(device=args.device)
    mix = None
    if args.mix:
        mix = {}
        for part in args.mix.split(","):
            name, _, w = part.partition("=")
            mix[name.strip()] = float(w) if w else 1.0
    engine, scenarios, lens_tgt = _serve_engine(args, _load(args))
    words = tuple(args.words or ()) if engine.multi else None
    report = loadgen_mod.run_inprocess(
        engine, n_requests=args.n, seed=args.seed, rate=args.rate,
        concurrency=args.concurrency, mix=mix, scenarios=scenarios,
        words=words, lens_target_id=lens_tgt)
    report["aot"] = engine.aot_name
    if args.report:
        atomic_json_dump(report, args.report)
    print(json.dumps(report))
    good = report["goodput"]
    return 0 if good["admitted"] == good["completed"] else 1


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

    dp = sub.add_parser(
        "delta-pack",
        help="pack word checkpoints as base-resident deltas "
             "(zero/q8/xor codec, versioned artifacts)")
    dp.add_argument("-c", "--config", default="configs/default.yaml")
    dp.add_argument("--base", default=None,
                    help="base snapshot repo id (default: $TBX_DELTA_BASE "
                         "or google/gemma-2-9b-it)")
    dp.add_argument("--words", nargs="*", default=None,
                    help="words to pack (default: all in config)")
    dp.add_argument("--checkpoint-root", default=None)
    dp.add_argument("--out", default=None,
                    help="artifact directory (default: $TBX_DELTA_ROOT or "
                         "results/deltas)")
    dp.add_argument("--atol", type=float, default=0.0,
                    help="allow q8 leaves whose applied reconstruction is "
                         "within this max-abs error (0 = bit-exact only; "
                         "relaxations are recorded per leaf in the header)")
    dp.add_argument("--selfcheck", action="store_true",
                    help="tiny model, synthetic word: pack -> apply -> "
                         "bit-exact forward; prints a JSON verdict")
    dp.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dp.set_defaults(fn=cmd_delta_pack)

    sc = sub.add_parser(
        "spec-calibrate",
        help="calibrate per-word speculative-decoding (draft layer, block "
             "size) from the cached lens sweeps (host-side, no model)")
    _common(sc)
    sc.add_argument("--out", default=os.path.join("results",
                                                  "spec_calibration.json"),
                    help="calibration artifact path (point "
                         "TBX_SPEC_CALIBRATION here)")
    sc.add_argument("--max-block", type=int, default=8,
                    help="largest draft block size the chooser searches")
    sc.add_argument("--rows", type=int, default=10,
                    help="batch rows assumed by the cost model")
    sc.set_defaults(fn=cmd_spec_calibrate)

    lg = sub.add_parser(
        "loadgen",
        help="closed-loop load generator + SLO report (serve_latency stage)",
        description="Serve a seeded scenario mix and arrival process in "
                    "process through one resident engine; report "
                    "per-scenario p50/p99 latency, TTFT and goodput as a "
                    "serve_latency JSON.  --selfcheck is the tiny-model "
                    "smoke.")
    lg.add_argument("-c", "--config", default="configs/default.yaml")
    lg.add_argument("--synthetic", action="store_true",
                    help="tiny random model + word tokenizer (no checkpoint "
                         "IO); several --words serve through one multi-word "
                         "engine over synthetic deltas")
    lg.add_argument("--word", default=None,
                    help="taboo checkpoint to serve (default: first config "
                         "word)")
    lg.add_argument("--words", nargs="*", default=None,
                    help="serve SEVERAL words from one resident base + delta "
                         "bank (needs --delta-root unless --synthetic); one "
                         "word behaves like --word")
    lg.add_argument("--delta-root", default=None,
                    help="directory of delta-pack artifacts (or TBX_DELTA=1 "
                         "and TBX_DELTA_ROOT)")
    lg.add_argument("--checkpoint-root", default=None,
                    help="directory of local HF snapshots (or set "
                         "TABOO_CHECKPOINT_ROOT)")
    lg.add_argument("--sae-npz", default=os.environ.get("TABOO_SAE_NPZ"),
                    help="Gemma-Scope layout SAE npz (without one the "
                         "sae_ablate scenario is dropped)")
    lg.add_argument("--slots", type=int, default=8,
                    help="decode-batch width (concurrent sessions)")
    lg.add_argument("--max-context", type=int, default=160)
    lg.add_argument("--prompt-cols", type=int, default=96)
    lg.add_argument("--max-new-tokens", type=int, default=24,
                    help="per-session generation budget")
    lg.add_argument("-n", type=int, default=32, help="requests to send")
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate, requests/second")
    lg.add_argument("--concurrency", type=int, default=16,
                    help="closed-loop cap on outstanding requests")
    lg.add_argument("--mix", default=None,
                    help="scenario mix, e.g. 'chat=2,sae_ablate=1,forcing=1' "
                         "(default: uniform over available scenarios)")
    lg.add_argument("--report", default=None,
                    help="also write the report JSON here (atomic)")
    lg.add_argument("--selfcheck", action="store_true",
                    help="tiny model, 32 requests: goodput == admitted and "
                         "the latency and TTFT schema, else an error")
    lg.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "paths)")
    lg.set_defaults(fn=cmd_loadgen)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
