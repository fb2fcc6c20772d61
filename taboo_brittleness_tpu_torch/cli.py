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
    python -m taboo_brittleness_tpu_torch loadgen       [--synthetic] [--word W | --words W1 W2 --delta-root D] [-n N] [--selfcheck] [--spool DIR]
    python -m taboo_brittleness_tpu_torch serve         --output-dir DIR [--synthetic] [--word W | --words ...] [--max-requests N]
    python -m taboo_brittleness_tpu_torch supervise     --output-dir DIR -- <subcommand> [args...]
    python -m taboo_brittleness_tpu_torch fleet         --output-dir DIR [--synthetic] [--workers N] [--readout-layers L1,L2] [--selfcheck]
    python -m taboo_brittleness_tpu_torch worker        --fleet-dir DIR [--worker-id W]
    python -m taboo_brittleness_tpu_torch grid          --output-dir DIR [--synthetic] [--layers L1,L2] [--widths W1,W2] [--workers N] [--selfcheck]
    python -m taboo_brittleness_tpu_torch attack-search --synthetic [--grid MATRIX] [--seed S] [--out F]

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
base plus a ``--delta-root`` bank for several ``--words``); with
``--spool DIR`` it drives a running ``serve`` through its file spool
instead.  ``serve`` is the long-lived server over the same engines
(``serve.server``): requests under ``DIR/requests/``, responses under
``DIR/responses/``.  ``TBX_SERVE_SPECULATE=1`` builds the speculative
engine (``serve.spec_engine``) for both.  ``supervise`` runs any of these
subcommands as a child process under ``runtime.supervise`` (restart on a
crash or a wedge, relaunch on a drain).  ``fleet`` runs a sweep as
``(word, readout)`` units over N supervised ``worker`` processes claiming
them from a durable spool under leases (``runtime.fleet``); ``grid`` decodes
each word once tapping every grid layer and fans one fleet unit per
(word, layer, width) cell (``grid/``); ``attack-search`` evolves attacks
against an in-process multi-word engine (``grid.search``).  The coordinator
forwards ``--device`` to every worker.  SIGTERM / SIGINT drain every
command: a sweep stops between words and a server finishes its admitted
sessions.  Exit codes: 0 when the run completed, 75 when it drained
(resumable: relaunch it, or let ``supervise`` do it), 1 when words were
quarantined (see the ``_failures.json`` of the sweep's directory) or, for
``loadgen``, when an admitted request did not complete.
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
    """The exit code: 1 (and a stderr line) when words were quarantined,
    75 when the sweep drained (:func:`_exit_code`)."""
    rc = 0
    if quarantined:
        print(f"[resilience] {len(quarantined)} word(s) quarantined: "
              f"{quarantined} (see {ledger_path})", file=sys.stderr)
        rc = 1
    return _exit_code(rc)


def _exit_code(rc: int) -> int:
    """Map a sweep's exit through the drain contract: a run that stopped at
    a drain exits 75 (``EX_TEMPFAIL``, resumable) whatever its quarantine
    state, because the sweep did not finish and the missing words come
    back with a relaunch."""
    from taboo_brittleness_tpu_torch.runtime import supervise

    if supervise.drain_requested():
        print("[supervise] run drained on a preemption notice; partial "
              "results are valid — relaunch (or `supervise`) resumes them",
              file=sys.stderr)
        return supervise.EXIT_DRAINED
    return rc


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


def _serve_engine(args):
    """The resident engine of ``serve`` and ``loadgen``: ``--synthetic`` is
    the tiny-model stack (one word, or several through one multi-word
    engine); otherwise the config's word (``--word`` / one ``--words``)
    loads through a ``CheckpointManager``, or with several ``--words`` the
    base plus their ``--delta-root`` artifacts stacked into one bank.  The
    SAE comes from ``--sae-npz`` (without one the ``sae_ablate`` scenario
    is dropped) and every edit and the lens readout sit at
    ``config.model.layer_idx``.  ``TBX_SERVE_SPECULATE=1`` builds the
    speculative engine on every path.  Returns (engine, scenarios,
    lens_target_id)."""
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve import loadgen as loadgen_mod
    from taboo_brittleness_tpu_torch.serve import spec_engine
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
    config = _load(args)          # the synthetic stack reads no config
    engine_cls = (spec_engine.SpecServeEngine if spec_engine.enabled()
                  else ServeEngine)

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
        engine = engine_cls(base_params, cfg, tok, engine_config=ec, sae=sae,
                            words=words,
                            delta_bank=deltalib.stack_bank(base_params, packed))
    else:
        word = (words[0] if words else None) or args.word or config.words[0]
        words = (word,)
        params, cfg, tok = mgr.load(word)
        engine = engine_cls(params, cfg, tok, engine_config=ec, sae=sae,
                            words=words)
    scenarios = default_scenarios(max_new_tokens=args.max_new_tokens)
    if sae is None:
        scenarios.pop("sae_ablate", None)
    # One lens target per engine: the first served word.
    return engine, scenarios, target_token_id(tok, words[0])


def cmd_loadgen(args) -> int:
    """Closed-loop load generator (``serve.loadgen``): a seeded scenario
    mix and arrival process, in process over a fresh engine or, with
    ``--spool DIR``, through a running ``serve``'s spool; prints the
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
    if args.spool:
        report = loadgen_mod.run_spool(
            args.spool, n_requests=args.n, seed=args.seed, rate=args.rate,
            concurrency=args.concurrency, mix=mix,
            words=tuple(args.words or ()) or None, timeout_s=args.timeout)
    else:
        engine, scenarios, lens_tgt = _serve_engine(args)
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


def cmd_serve(args) -> int:
    """Long-lived continuous-batching server over one resident engine
    (``serve.server``): file-spool intake under ``--output-dir``, the
    serving heartbeat, SIGTERM drain -> exit 75, supervised resume.
    Prints the summary JSON (status, completed, steps)."""
    from taboo_brittleness_tpu_torch.serve import server as server_mod

    engine, scenarios, lens_tgt = _serve_engine(args)
    res = server_mod.serve_forever(
        engine, scenarios, args.output_dir,
        lens_target_id=lens_tgt, queue_limit=args.queue_limit,
        max_requests=args.max_requests, poll_s=args.poll)
    print(json.dumps({"status": res.status, "completed": res.completed,
                      "steps": res.steps}))
    return res.exit_code


def cmd_supervise(args) -> int:
    """Run a subcommand of this package under the preemption-safe
    supervisor (``runtime.supervise``): launched as a child process,
    restarted on a crash or a wedge within the incarnation budget,
    relaunched on a drain; prints the supervision summary JSON."""
    from taboo_brittleness_tpu_torch.runtime import supervise

    child = list(args.child or [])
    while child and child[0] == "--":
        child = child[1:]
    if not child:
        raise SystemExit(
            "supervise: missing child subcommand — usage: "
            "supervise --output-dir DIR -- token-forcing [args...]")
    argv = [sys.executable, "-m", "taboo_brittleness_tpu_torch", *child]
    res = supervise.supervise(
        argv, args.output_dir,
        max_incarnations=args.max_incarnations,
        poll_interval=args.poll, grace=args.grace,
        wedge_after=args.wedge_after)
    print(json.dumps({"status": res.status, "exit_code": res.exit_code,
                      "incarnations": [
                          {k: r.get(k) for k in ("incarnation", "outcome",
                                                 "exit_code")}
                          for r in res.incarnations]}, indent=2))
    return res.exit_code


def _fleet_unit_fn(args, spool_cfg):
    """The worker's per-unit computation, from the spool config.

    ``synthetic`` is the hermetic tiny-model stack (the chaos tests and the
    selfcheck); ``checkpoint`` loads each unit's word through the
    ``CheckpointManager``.  Either way a unit is one ``(word, readout)``
    cell: decode the word's probe prompt and capture the residual at the
    readout layer.  ``grid`` units read the coordinator's shared residual
    artifact and run ``grid.runner.run_cell`` (the tiny stack, or each
    word through the ``CheckpointManager``)."""
    from taboo_brittleness_tpu_torch.runtime import decode

    mode = spool_cfg.get("mode") or (
        "synthetic" if args.synthetic else "checkpoint")
    max_new = int(spool_cfg.get("max_new_tokens", args.max_new_tokens))
    seed = int(spool_cfg.get("seed", 7))

    if mode == "grid":
        from taboo_brittleness_tpu_torch.grid import runner as grid_runner
        from taboo_brittleness_tpu_torch.grid.spec import GridSpec

        spec = GridSpec.from_dict(spool_cfg["grid"])
        kw = dict(spec=spec, resid_dir=spool_cfg["resid_dir"], seed=seed,
                  top_k=int(spool_cfg.get("top_k", 8)),
                  max_new_tokens=max_new)
        if spool_cfg.get("model", "synthetic") == "synthetic":
            model = grid_runner.synthetic_model(
                list(spool_cfg.get("words", [])), seed=seed,
                device=args.device,
                preset=spool_cfg.get("preset", "gemma2_tiny"))
            return lambda unit: grid_runner.run_cell(unit, model=model, **kw)
        loader = _loader(_load(args), args)
        return lambda unit: grid_runner.run_cell(
            unit, model=loader(unit["word"]), **kw)

    def summarize(unit, result, texts, layer):
        out = {"word": unit.get("word"), "readout_layer": layer,
               "generated_tokens": int(result.lengths[0]),
               "text": (texts or [""])[0]}
        if result.residual is not None:
            out["residual_norm"] = round(
                float(result.residual.double().norm()), 6)
        return out

    if mode == "synthetic":
        from taboo_brittleness_tpu_torch.grid import runner as grid_runner

        params, cfg, tok = grid_runner.synthetic_model(
            list(spool_cfg.get("words", [])), seed=seed, device=args.device,
            preset=spool_cfg.get("preset", "gemma2_tiny"))

        def unit_fn(unit):
            layer = int((unit.get("readout") or {}).get("layer", 1))
            layer = min(max(layer, 0), cfg.num_layers - 1)
            result, texts, _ = decode.generate(
                params, cfg, tok, grid_runner.probe_prompts(unit["word"]),
                max_new_tokens=max_new, capture_residual_layer=layer)
            return summarize(unit, result, texts, layer)

        return unit_fn

    config = _load(args)
    loader = _loader(config, args)
    prompts = list(config.prompts)[:1] or ["Give me a hint"]

    def unit_fn(unit):
        params, cfg, tok = loader(unit["word"])
        layer = int((unit.get("readout") or {}).get(
            "layer", config.model.layer_idx))
        layer = min(max(layer, 0), cfg.num_layers - 1)
        result, texts, _ = decode.generate(
            params, cfg, tok, prompts,
            max_new_tokens=max_new, capture_residual_layer=layer)
        return summarize(unit, result, texts, layer)

    return unit_fn


def cmd_worker(args) -> int:
    """One fleet worker (``runtime.fleet``): claim ``(word, readout)``
    units from the coordinator's spool under a heartbeat-renewed lease,
    compute, commit first-writer-wins.  Normally started by ``fleet`` or
    ``grid`` under a per-worker supervisor; runnable by hand against any
    spool directory (the JAX package's too: the schemas are shared)."""
    from taboo_brittleness_tpu_torch.runtime import fleet, resilience

    wid = args.worker_id or resilience.current_worker_id() or "w0"
    # The worker id names the per-worker telemetry files and the ledger and
    # span stamps: set it before any tracer or ledger exists.
    os.environ[resilience.WORKER_ENV] = wid
    spool = fleet.FleetSpool(
        os.path.join(args.fleet_dir, fleet.SPOOL_DIRNAME)).ensure()
    res = fleet.run_worker(
        args.fleet_dir, wid,
        unit_fn=_fleet_unit_fn(args, spool.read_config()),
        lease_s=args.lease, poll_s=args.poll,
        max_retries=args.max_retries)
    print(json.dumps({"worker_id": wid, "committed": res.committed,
                      "duplicates": res.duplicates,
                      "quarantined": res.quarantined,
                      "drained": res.drained}))
    return res.exit_code


def _worker_argv(args, out: str):
    """``worker_argv(wid)`` of a coordinator: the port's worker process
    (exec, never a fork) with the coordinator's config, budget, checkpoint
    root and ``--device``."""
    from taboo_brittleness_tpu_torch.runtime import fleet

    def argv(wid: str) -> List[str]:
        cmd = fleet.worker_command(out, wid, args.device)
        cmd += ["-c", args.config, "--max-new-tokens", str(args.max_new_tokens)]
        if getattr(args, "synthetic", False):
            cmd.append("--synthetic")
        if args.checkpoint_root:
            cmd += ["--checkpoint-root", args.checkpoint_root]
        return cmd

    return argv


def _run_fleet(args, units, out: str, spool_cfg):
    from taboo_brittleness_tpu_torch.runtime import fleet

    return fleet.run_fleet(
        units, out, n_workers=args.workers,
        worker_argv=_worker_argv(args, out), spool_config=spool_cfg,
        lease_s=args.lease, max_incarnations=args.max_incarnations,
        grace=args.grace, wedge_after=args.wedge_after,
        max_wall_s=args.max_wall)


def _save_manifest(args, manifest, out: str) -> None:
    if not args.no_manifest:
        path = manifest.save(os.path.join(out, "run_manifest.json"))
        print(f"manifest -> {path}")


def cmd_fleet(args) -> int:
    """Elastic fleet coordinator (``runtime.fleet``): decompose the sweep
    into ``(word, readout)`` units in a durable spool, run N supervised
    workers with lease-based work stealing, merge their artifacts."""
    from taboo_brittleness_tpu_torch.runtime import fleet
    from taboo_brittleness_tpu_torch.runtime.manifest import RunManifest

    if args.selfcheck:
        return fleet.main_selfcheck(device=args.device)
    if not args.output_dir:
        raise SystemExit("fleet: --output-dir is required (or --selfcheck)")
    config = _load(args)
    words = list(args.words or config.words)
    layers = _parse_int_list(args.readout_layers) or [config.model.layer_idx]
    units = [{"uid": fleet.unit_id(w, {"layer": la}), "word": w,
              "readout": {"layer": la}} for w in words for la in layers]
    out = args.output_dir
    spool_cfg = {"mode": "synthetic" if args.synthetic else "checkpoint",
                 "words": words, "max_new_tokens": args.max_new_tokens,
                 "config": args.config}
    manifest = RunManifest(command="fleet")
    with manifest.stage("fleet", units=len(units), workers=args.workers):
        res = _run_fleet(args, units, out, spool_cfg)
    manifest.extra["fleet"] = res.to_dict()
    _save_manifest(args, manifest, out)
    print(json.dumps({"status": res.status, "units": res.units_total,
                      "committed": res.committed,
                      "quarantined": res.quarantined,
                      "reissued": res.reissued,
                      "lease_expiries": res.lease_expiries,
                      "duplicate_commits": res.duplicate_commits,
                      "recovery_seconds": res.recovery_seconds,
                      "workers": res.workers}))
    return res.exit_code


def _parse_int_list(text: Optional[str]) -> Optional[List[int]]:
    if not text:
        return None
    return [int(x) for x in str(text).split(",") if x.strip()]


def cmd_grid(args) -> int:
    """Gemma-Scope grid sweep (``grid/``): capture each word's residuals
    once while tapping every grid layer in one graphed decode, then fan
    encode -> top latents -> ablate -> decode -> score per (word, layer,
    width) cell through the fleet; write ``grid_matrix.json``."""
    from taboo_brittleness_tpu_torch.grid import runner as grid_runner
    from taboo_brittleness_tpu_torch.grid.spec import GridSpec
    from taboo_brittleness_tpu_torch.runtime.manifest import RunManifest
    from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump

    if args.selfcheck:
        return grid_runner.main_selfcheck(device=args.device)
    if not args.output_dir:
        raise SystemExit("grid: --output-dir is required (or --selfcheck)")
    config = _load(args)
    layers = _parse_int_list(args.layers)
    widths = _parse_int_list(args.widths)
    words = list(args.words or config.words)
    out = args.output_dir
    resid_dir = os.path.join(out, grid_runner.RESID_DIRNAME)
    if args.synthetic:
        spec = GridSpec.build(layers or [1, 2], widths or [32, 64],
                              release="synthetic")
        model = grid_runner.synthetic_model(words, seed=args.seed,
                                            device=args.device)
        loader = lambda w: model  # noqa: E731 — one tiny model
    else:
        spec = GridSpec.from_config(config, layers=layers, widths=widths,
                                    artifact_dir=args.cells_dir)
        loader = _loader(config, args)
    bad = [c.key for c in spec.cells if c.layer < 0]
    if bad:
        raise SystemExit(f"grid: negative layers in cells {bad}")

    manifest = RunManifest(command="grid")
    with manifest.stage("grid.capture", words=len(words),
                        taps=len(spec.tap_layers)):
        for w in words:
            p, c, t = loader(w)
            grid_runner.capture_word_residuals(
                p, c, t, w, spec, max_new_tokens=args.max_new_tokens,
                resid_dir=resid_dir)
    units = grid_runner.grid_units(spec, words)
    spool_cfg = {
        "mode": "grid",
        "model": "synthetic" if args.synthetic else "checkpoint",
        "words": words, "grid": spec.to_dict(), "resid_dir": resid_dir,
        "seed": args.seed, "top_k": args.top_k,
        "max_new_tokens": args.max_new_tokens, "config": args.config,
    }
    with manifest.stage("grid.fleet", units=len(units), workers=args.workers):
        res = _run_fleet(args, units, out, spool_cfg)
    matrix = grid_runner.assemble_matrix(out, spec, words)
    matrix_path = os.path.join(out, "grid_matrix.json")
    atomic_json_dump(matrix, matrix_path)
    manifest.extra["grid"] = {"fleet": res.to_dict(), "matrix": matrix_path,
                              "complete": matrix["complete"]}
    _save_manifest(args, manifest, out)
    print(json.dumps({"status": res.status, "units": res.units_total,
                      "committed": res.committed,
                      "quarantined": res.quarantined,
                      "cells": list(spec.keys), "words": words,
                      "complete": matrix["complete"],
                      "matrix": matrix_path}))
    return res.exit_code


def cmd_attack_search(args) -> int:
    """Closed-loop attack search (``grid/search.py``): evolve forcing
    prefixes and prompt templates against an in-process multi-word engine,
    drawing ablation targets from a grid matrix's per-cell top latents;
    write the trajectory and the breakage matrix."""
    from taboo_brittleness_tpu_torch.grid import runner as grid_runner
    from taboo_brittleness_tpu_torch.grid import search as grid_search
    from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump
    from taboo_brittleness_tpu_torch.serve import loadgen

    if not args.synthetic:
        raise SystemExit(
            "attack-search: only the --synthetic engine is wired; a served "
            "model's round goes through `serve` (see ROADMAP)")
    words = tuple(args.words or ("ship", "moon"))
    engine, _scenarios, lens_target_id = loadgen.build_synthetic_multi_engine(
        words=words, seed=args.engine_seed,
        max_new_tokens=args.max_new_tokens, device=args.device)
    pools = None
    if args.grid:
        with open(args.grid) as f:
            pools = grid_runner.latent_pools(json.load(f))
    result = grid_search.run_search(
        engine, lens_target_id, words=list(words), seed=args.seed,
        generations=args.generations, population=args.population,
        n_requests=args.n, max_new_tokens=args.max_new_tokens,
        latent_pools=pools)
    if args.out:
        atomic_json_dump(result, args.out)
    print(json.dumps({"best": result["best"],
                      "seed_best_fitness": result["seed_best_fitness"],
                      "improved": result["improved"],
                      "break_rate": result["break_rate"],
                      "out": args.out}))
    return 0


def _fleet_common(p: argparse.ArgumentParser) -> None:
    """The coordinator flags ``fleet`` and ``grid`` share."""
    p.add_argument("-c", "--config", default="configs/default.yaml")
    p.add_argument("--words", nargs="*", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="tiny random model + word tokenizer (hermetic "
                        "smoke path; no checkpoint IO)")
    p.add_argument("--checkpoint-root", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the coordinator and of every "
                        "worker (default cuda)")
    p.add_argument("--max-new-tokens", type=int, default=8)
    p.add_argument("--lease", type=float, default=None,
                   help="lease seconds before an unrenewed claim is "
                        "re-issued (default: TBX_FLEET_LEASE_S or 10)")
    p.add_argument("--max-incarnations", type=int, default=None,
                   help="per-worker supervisor restart budget")
    p.add_argument("--grace", type=float, default=None,
                   help="per-worker SIGTERM->SIGKILL grace seconds")
    p.add_argument("--wedge-after", type=float, default=None,
                   help="kill a worker quiet for this long while its "
                        "heartbeat stays fresh")
    p.add_argument("--max-wall", type=float, default=None,
                   help="hard fleet wall-clock bound (safety valve)")
    p.add_argument("--no-manifest", action="store_true")


def _serve_common(p: argparse.ArgumentParser) -> None:
    """The engine flags ``serve`` and ``loadgen`` share."""
    p.add_argument("-c", "--config", default="configs/default.yaml")
    p.add_argument("--synthetic", action="store_true",
                   help="tiny random model + word tokenizer (no checkpoint "
                        "IO); several --words serve through one multi-word "
                        "engine over synthetic deltas")
    p.add_argument("--word", default=None,
                   help="taboo checkpoint to serve (default: first config "
                        "word)")
    p.add_argument("--words", nargs="*", default=None,
                   help="serve SEVERAL words from one resident base + delta "
                        "bank (needs --delta-root unless --synthetic); one "
                        "word behaves like --word")
    p.add_argument("--delta-root", default=None,
                   help="directory of delta-pack artifacts (or TBX_DELTA=1 "
                        "and TBX_DELTA_ROOT)")
    p.add_argument("--checkpoint-root", default=None,
                   help="directory of local HF snapshots (or set "
                        "TABOO_CHECKPOINT_ROOT)")
    p.add_argument("--sae-npz", default=os.environ.get("TABOO_SAE_NPZ"),
                   help="Gemma-Scope layout SAE npz (without one the "
                        "sae_ablate scenario is dropped)")
    p.add_argument("--slots", type=int, default=8,
                   help="decode-batch width (concurrent sessions)")
    p.add_argument("--max-context", type=int, default=160)
    p.add_argument("--prompt-cols", type=int, default=96)
    p.add_argument("--max-new-tokens", type=int, default=24,
                   help="per-session generation budget")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "paths)")


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
    _serve_common(lg)
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
                    help="tiny model, 32 requests through the vanilla and "
                         "the speculative engine: goodput == admitted, the "
                         "latency, TTFT and accept schema, else an error")
    lg.add_argument("--spool", default=None,
                    help="drive a RUNNING serve through its output dir "
                         "instead of in process")
    lg.add_argument("--timeout", type=float, default=300.0,
                    help="--spool: seconds before unanswered requests count "
                         "as dropped")
    lg.set_defaults(fn=cmd_loadgen)

    se = sub.add_parser(
        "serve",
        help="continuous-batching brittleness-probe server (one resident "
             "model, per-request scenario switches)",
        description="Serve concurrent chat / SAE-ablated / projection / "
                    "token-forcing / lens-readout sessions from one "
                    "resident engine (TBX_SERVE_SPECULATE=1: the "
                    "speculative engine). Requests arrive as JSON files "
                    "under <output-dir>/requests/; responses land in "
                    "<output-dir>/responses/. SIGTERM drains: in-flight "
                    "sessions finish, admissions stop, exit 75 — run "
                    "under `supervise` for restart and resume.")
    _serve_common(se)
    se.add_argument("--output-dir", required=True,
                    help="spool + telemetry directory (requests/, "
                         "responses/, _progress.json, _events.jsonl)")
    se.add_argument("--queue-limit", type=int, default=64,
                    help="bounded admission queue (beyond it: reject)")
    se.add_argument("--max-requests", type=int, default=None,
                    help="exit 0 once this many responses exist on disk "
                         "(counts prior incarnations'; default: run forever)")
    se.add_argument("--poll", type=float, default=0.05,
                    help="idle spool poll interval seconds")
    se.set_defaults(fn=cmd_serve)

    sv = sub.add_parser(
        "supervise",
        help="run a subcommand under the preemption-safe supervisor",
        description="Launch a subcommand of this package as a supervised "
                    "child process: restart on a crash or a wedged "
                    "heartbeat within a bounded incarnation budget "
                    "(seeded-jitter backoff), relaunch at once on a "
                    "drained exit (75), pass through 0 (done) and 1 "
                    "(quarantined words; a server's 1 is a crash). Env "
                    "knobs: TBX_SUPERVISE_MAX_INCARNATIONS, "
                    "TBX_SUPERVISE_POLL_S, TBX_SUPERVISE_GRACE_S, "
                    "TBX_SUPERVISE_WEDGE_S, TBX_SUPERVISE_BACKOFF_S.")
    sv.add_argument("--output-dir", required=True,
                    help="directory the child heartbeats _progress.json "
                         "into; _supervise.json lands here too")
    sv.add_argument("--max-incarnations", type=int, default=None,
                    help="total launch budget (default: "
                         "TBX_SUPERVISE_MAX_INCARNATIONS or 5)")
    sv.add_argument("--poll", type=float, default=None,
                    help="progress poll interval seconds (default: "
                         "TBX_SUPERVISE_POLL_S or 1.0)")
    sv.add_argument("--grace", type=float, default=None,
                    help="SIGTERM->SIGKILL grace window seconds (default: "
                         "TBX_SUPERVISE_GRACE_S or 15)")
    sv.add_argument("--wedge-after", type=float, default=None,
                    help="kill a child quiet for this long while its "
                         "heartbeat stays fresh (default: "
                         "TBX_SUPERVISE_WEDGE_S or 300)")
    sv.add_argument("child", nargs=argparse.REMAINDER,
                    help="-- <subcommand> [args...]")
    sv.set_defaults(fn=cmd_supervise)

    fl = sub.add_parser(
        "fleet",
        help="elastic multi-worker sweep: lease-based work stealing over a "
             "durable spool, per-worker supervision, merged artifacts",
        description="Decompose a sweep into (word, readout_config) work "
                    "units in a durable filesystem spool and run N "
                    "supervised worker processes that claim units under "
                    "heartbeat-renewed leases (runtime/fleet.py). A dead "
                    "or wedged worker's lease expires and its unit is "
                    "re-issued; stragglers are re-dispatched with a "
                    "first-writer-wins commit. Per-worker events, ledgers "
                    "and progress merge into one run view at the end. "
                    "SIGTERM drains the fleet at unit boundaries (exit "
                    "75); a relaunch resumes the spool.")
    _fleet_common(fl)
    fl.add_argument("--output-dir", default=None,
                    help="fleet directory: spool/, per-worker telemetry, "
                         "merged _events.jsonl/_failures.json/_fleet.json "
                         "(required unless --selfcheck)")
    fl.add_argument("--workers", type=int, default=3)
    fl.add_argument("--readout-layers", default=None,
                    help="comma-separated readout tap layers; each (word, "
                         "layer) cell is one unit (default: the config's "
                         "layer_idx)")
    fl.add_argument("--selfcheck", action="store_true",
                    help="tiny model, 3 workers, one killed mid-unit; "
                         "asserts exactly-once completion")
    fl.set_defaults(fn=cmd_fleet)

    wk = sub.add_parser(
        "worker",
        help="one fleet worker: claim spool units under lease, compute, "
             "commit first-writer-wins (normally started by fleet or grid)")
    wk.add_argument("-c", "--config", default="configs/default.yaml")
    wk.add_argument("--fleet-dir", required=True,
                    help="the coordinator's fleet directory (holds spool/)")
    wk.add_argument("--worker-id", default=None,
                    help="stable worker identity (default: TBX_WORKER_ID "
                         "or w0)")
    wk.add_argument("--synthetic", action="store_true")
    wk.add_argument("--checkpoint-root", default=None)
    wk.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    wk.add_argument("--max-new-tokens", type=int, default=8)
    wk.add_argument("--lease", type=float, default=None)
    wk.add_argument("--poll", type=float, default=0.25,
                    help="idle spool poll interval seconds")
    wk.add_argument("--max-retries", type=int, default=2)
    wk.set_defaults(fn=cmd_worker)

    gr = sub.add_parser(
        "grid",
        help="Gemma-Scope (layer x width) grid sweep: capture residuals "
             "once per word (multi-tap decode), fan per-cell readouts "
             "through the fleet, write the grid matrix",
        description="Decode each word once while tapping every grid layer "
                    "in one graphed decode, persist the shared [K, B, T, "
                    "D] residual artifact, then run one fleet unit per "
                    "(word, layer, width) cell: encode at the cell's SAE, "
                    "top-k latents, ablate them, decode the probe again, "
                    "score the leak shift. Cells retry then quarantine "
                    "one by one (grid.cell fault site).")
    _fleet_common(gr)
    gr.add_argument("--output-dir", default=None,
                    help="grid directory: residuals/, spool/, "
                         "grid_matrix.json (required unless --selfcheck)")
    gr.add_argument("--layers", default=None,
                    help="comma-separated residual tap layers (default: "
                         "config layer_idx; --synthetic: 1,2)")
    gr.add_argument("--widths", default=None,
                    help="comma-separated SAE widths (default: config "
                         "sae.width; --synthetic: 32,64)")
    gr.add_argument("--cells-dir", default=None,
                    help="directory of converted per-cell npz artifacts "
                         "(tools/convert_gemma_scope.py --cells; default: "
                         "synthetic SAEs)")
    gr.add_argument("--workers", type=int, default=2)
    gr.add_argument("--seed", type=int, default=7)
    gr.add_argument("--top-k", type=int, default=8,
                    help="latents per cell readout")
    gr.add_argument("--selfcheck", action="store_true",
                    help="2 words x 2x2 synthetic grid, 2 workers, one "
                         "injected grid.cell fault; asserts exactly-once "
                         "cells and the ledger")
    gr.set_defaults(fn=cmd_grid)

    asr = sub.add_parser(
        "attack-search",
        help="closed-loop attack search: evolve forcing prefixes + prompt "
             "templates against an in-process engine, write the breakage "
             "matrix",
        description="Seeded evolutionary search over (prefix, template, "
                    "grid-cell ablation) candidates, each scored by "
                    "driving the in-process multi-word engine through "
                    "loadgen with the candidate as a serving scenario "
                    "(token-forcing success + lens P(secret) bonus). The "
                    "same seed gives a byte-identical trajectory.")
    asr.add_argument("--synthetic", action="store_true",
                     help="tiny multi-word engine (the only engine wired)")
    asr.add_argument("--words", nargs="*", default=None,
                     help="secret words the engine serves (default: "
                          "ship moon)")
    asr.add_argument("--grid", default=None,
                     help="grid_matrix.json to draw per-cell ablation "
                          "latent pools from")
    asr.add_argument("--out", default=None,
                     help="write the trajectory + matrix artifact here")
    asr.add_argument("--seed", type=int, default=0,
                     help="search seed (mutation rng + request schedule)")
    asr.add_argument("--engine-seed", type=int, default=7)
    asr.add_argument("--generations", type=int, default=4)
    asr.add_argument("--population", type=int, default=6)
    asr.add_argument("-n", type=int, default=6,
                     help="requests per candidate evaluation")
    asr.add_argument("--max-new-tokens", type=int, default=6)
    asr.add_argument("--device", default=None,
                     help="torch device (default cuda)")
    asr.set_defaults(fn=cmd_attack_search)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # Latch SIGTERM / SIGINT into the drain (runtime.supervise): sweeps stop
    # at the next word boundary, a server after its admitted sessions, and
    # both exit 75; supervise polls the same latch to forward the notice.
    from taboo_brittleness_tpu_torch.runtime import supervise

    supervise.install_drain_handlers()
    return args.fn(args)
