#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernel to its
plain version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernel is built for sm_90a).  Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``taboo_brittleness_tpu_torch/csrc/lens_stats.cu``;
3. kernel: ``ops.lens_kernel.lens_stats`` against ``lens_stats_reference`` at
   the main path's shape (N = 1140, D = 3584, V = 256000, K = 5, bf16), with
   and without the cap, with one target and with per-row targets;
4. main path: Gemma-2-9B width (42 layers, seeded random bf16 weights made on
   the card), ``run_generation`` then ``run_evaluation`` for the default
   config's 10 prompts, through a model loader, into a temporary directory;
   the kernel must have launched 42 times per lens pass.

The line before the last is ``{"kernels": [...]}`` (times in ms, measured
here; ``bound_ms`` from this run's shapes and the card's published peaks);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "taboo_brittleness_tpu_torch"

# NVIDIA H100 SXM published peaks (data sheet, dense): HBM bytes/s and bf16
# tensor-core FLOP/s.  A card below its 700 W limit runs slower than these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# The main path's lens-kernel shape: 10 prompts left-padded to 64 columns
# plus 50 new tokens (N = 10 * 114), Gemma-2-9B width and vocabulary.
N_ROWS, HIDDEN, VOCAB, TOP_K = 1140, 3584, 256_000, 5

# Kernel vs plain: both accumulate exact bf16 products in f32, in another
# order; logits are O(1), so 1e-3 is ~100x the expected rounding gap.
ATOL = 1e-3
MIN_ID_ROWS = 0.9   # share of rows whose top-(K+1) gaps all exceed ATOL


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def report_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"device {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


def build_kernels() -> None:
    from taboo_brittleness_tpu_torch.ops import lens_kernel

    t0 = time.perf_counter()
    path, out = lens_kernel.build_library()
    log(f"built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  nvcc: {line.strip()}")
    lens_kernel._library()


def lens_bound_ms(n: int, d: int, v: int, k: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one lens_stats call: bf16 x and
    E read once, int32 targets, f32 lse/target/top-k values and int32 ids
    written once; 2*N*D*V multiply-adds at the bf16 tensor-core peak."""
    moved = 2 * n * d + 2 * v * d + 4 * n + 4 * n * (2 + 2 * k)
    ops = 2 * n * d * v
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_lens_stats(torch) -> dict:
    """Kernel vs plain at the main path's shape; returns the kernels entry."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N_ROWS, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
    embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    per_row = torch.randint(0, VOCAB, (N_ROWS,), generator=gen, device=dev,
                            dtype=torch.int32)
    per_row[::7] = -1
    per_row[-1] = VOCAB - 1
    scalar = 7509

    worst = 0.0
    for cap in (None, 30.0):
        for name, target in (("scalar", scalar), ("per-row", per_row)):
            got = lk.lens_stats(x, embed, target, top_k=TOP_K, logit_cap=cap)
            ref = lk.lens_stats_reference(x, embed, target, top_k=TOP_K + 1,
                                          logit_cap=cap)
            torch.cuda.synchronize()
            err = max(
                (got.logsumexp - ref.logsumexp).abs().max().item(),
                (got.target_logit - ref.target_logit).abs().max().item(),
                (got.topk_vals - ref.topk_vals[:, :TOP_K]).abs().max().item())
            gaps = ref.topk_vals[:, :-1] - ref.topk_vals[:, 1:]
            clear = (gaps > ATOL).all(dim=1)
            same = (got.topk_ids == ref.topk_ids[:, :TOP_K]).all(dim=1)
            n_clear = int(clear.sum().item())
            n_bad = int((clear & ~same).sum().item())
            log(f"lens_stats cap={cap} target={name}: max_abs_err {err:.3e} "
                f"(atol {ATOL}); top-k ids equal on {n_clear - n_bad}/"
                f"{n_clear} rows with clear margins of {N_ROWS}")
            if not err <= ATOL:
                fail(f"lens_stats disagrees with its plain version: {err}")
            if n_bad or n_clear < MIN_ID_ROWS * N_ROWS:
                fail(f"lens_stats top-k ids: {n_bad} mismatches, "
                     f"{n_clear} rows with clear margins")
            worst = max(worst, err)
            del got, ref

    def kernel():
        lk.lens_stats(x, embed, scalar, top_k=TOP_K)

    def plain():
        lk.lens_stats_reference(x, embed, scalar, top_k=TOP_K)

    def library():
        logits = torch.matmul(x, embed.T).float()
        torch.logsumexp(logits, dim=-1)
        torch.topk(logits, TOP_K, dim=-1)

    ms = timed_ms(torch, kernel, 10)
    plain_ms = timed_ms(torch, plain, 3)
    library_ms = timed_ms(torch, library, 10)
    bound_ms, bound_by = lens_bound_ms(N_ROWS, HIDDEN, VOCAB, TOP_K)
    log(f"lens_stats N={N_ROWS} D={HIDDEN} V={VOCAB} K={TOP_K} bf16: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by})")
    del x, embed, per_row
    torch.cuda.empty_cache()
    return {
        "name": "lens_stats",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/lens_stats.cu",
        "replaces": "taboo_brittleness_tpu/ops/pallas_lens.py:56",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_small_against_cpu(torch) -> None:
    """A tiny model (f32, vocab 256) through the lens pass on the card (the
    kernel's f32 path) and on the CPU (the plain tap): same stats."""
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens

    cfg = gemma2.PRESETS["gemma2_tiny"].replace(vocab_size=256)
    params = gemma2.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    ids = torch.randint(0, 256, (3, 11), generator=torch.Generator().manual_seed(2))
    targets = torch.full((3,), 17)
    cpu = lens.lens_forward(params, cfg, ids, targets, tap_layer=2, top_k=3)
    on_card = {k: v.cuda() for k, v in params.items() if k != "layers"}
    on_card["layers"] = {k: v.cuda() for k, v in params["layers"].items()}
    gpu = lens.lens_forward(on_card, cfg, ids.cuda(), targets.cuda(),
                            tap_layer=2, top_k=3)
    torch.cuda.synchronize()
    err = max((gpu.tap.target_prob.cpu() - cpu.tap.target_prob).abs().max().item(),
              (gpu.tap.topk_probs.cpu() - cpu.tap.topk_probs).abs().max().item(),
              (gpu.residual.cpu() - cpu.residual).abs().max().item())
    same = torch.equal(gpu.tap.topk_ids.cpu(), cpu.tap.topk_ids)
    log(f"tiny f32 lens pass, card vs CPU: max_abs_err {err:.3e} (atol 1e-5), "
        f"top-k ids equal: {same}")
    if not (err <= 1e-5 and same):
        fail("the tiny lens pass on the card disagrees with the CPU")


class PhaseTimer:
    """Adds a synchronised host clock around module functions of the main
    path (``decode.generate``, ``lens.lens_forward``,
    ``lens.aggregate_from_residual``) while a run is driven."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}
        self._restore = []

    def wrap(self, module, name: str, label: str) -> None:
        orig = getattr(module, name)

        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0
            return out

        setattr(module, name, timed)
        self._restore.append((module, name, orig))

    def restore(self) -> None:
        for module, name, orig in reversed(self._restore):
            setattr(module, name, orig)


def drive_main_path(torch, workdir: str) -> int:
    """``run_generation`` for one word, then ``run_evaluation`` for it and a
    second word (the first from the cache, the second through the model) at
    Gemma-2-9B width.  Returns the kernel launches of the run."""
    import numpy as np

    from taboo_brittleness_tpu_torch import config as config_mod
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel
    from taboo_brittleness_tpu_torch.pipelines import generation, logit_lens
    from taboo_brittleness_tpu_torch.runtime import cache as cache_io
    from taboo_brittleness_tpu_torch.runtime import decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    config = config_mod.Config(
        output=config_mod.OutputConfig(save_plots=False))
    cfg = gemma2.PRESETS["gemma2_9b"]
    gen_word, lens_word = "ship", "moon"
    t0 = time.perf_counter()
    params = gemma2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"gemma2_9b: {cfg.num_layers} layers, D={cfg.hidden_size}, "
        f"V={cfg.vocab_size}, {gemma2.num_params(params) / 1e9:.2f} B params "
        f"({cfg.param_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    tok = WordTokenizer(words, vocab_size=cfg.vocab_size)

    def loader(word):
        return params, cfg, tok

    processed = os.path.join(workdir, "processed")
    timer = PhaseTimer(torch)
    timer.wrap(decode, "generate", "decode")
    timer.wrap(lens, "lens_forward", "lens")
    timer.wrap(lens, "aggregate_from_residual", "aggregate")
    torch.cuda.reset_peak_memory_stats()
    lens_kernel.lens_stats.launches = 0
    try:
        t0 = time.perf_counter()
        done = generation.run_generation(
            config, model_loader=loader, words=[gen_word],
            processed_dir=processed, fail_fast=True)
        t_gen = time.perf_counter() - t0
        after_generate = lens_kernel.lens_stats.launches
        t0 = time.perf_counter()
        results = logit_lens.run_evaluation(
            config, tok, words=[gen_word, lens_word], model_loader=loader,
            processed_dir=processed,
            output_path=os.path.join(workdir, "results.json"))
        t_eval = time.perf_counter() - t0
    finally:
        timer.restore()
    launches = lens_kernel.lens_stats.launches
    peak = torch.cuda.max_memory_allocated()

    n_prompts = len(config.prompts)
    if done != {gen_word: list(range(n_prompts))}:
        fail(f"run_generation wrote {done}")
    if after_generate != cfg.num_layers or launches != 2 * cfg.num_layers:
        fail(f"lens kernel launches: {after_generate} in generate, {launches} "
             f"in all; expected {cfg.num_layers} per lens pass, 2 passes")
    log(f"run_generation ({gen_word}) {t_gen:.2f} s, run_evaluation "
        f"({gen_word} cached, {lens_word} on the card) {t_eval:.2f} s; lens "
        f"kernel launches {launches} = {cfg.num_layers} per lens pass x 2")
    log("phases (host clock, synchronised, summed over both words): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timer.seconds.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")

    # The outputs: summaries of the expected shapes and ranges, and the
    # lens at the last layer reproducing the decode's own greedy tokens.  Not
    # all of them: the decode picks from logits rounded to bf16 (ties go to
    # the lower id) in a one-column forward, the kernel from f32 sums over
    # the whole sequence, and a random model's top-2 gap is under bf16's
    # step (1/64 near 3) at several percent of positions.
    agree = total = 0
    for i in range(n_prompts):
        arrays, meta = cache_io.load_summary(
            cache_io.summary_path(processed, gen_word, i))
        T = arrays["token_ids"].shape[0]
        tp = arrays["target_prob"]
        if tp.shape != (cfg.num_layers, T) or not ((tp >= 0) & (tp <= 1)).all():
            fail(f"summary {i}: target_prob {tp.shape}")
        if arrays["residual"].shape != (T, cfg.hidden_size) or \
                not np.isfinite(arrays["residual"]).all():
            fail(f"summary {i}: residual {arrays['residual'].shape}")
        if arrays["agg_topk_ids"].shape != (config.model.top_k,):
            fail(f"summary {i}: agg_topk_ids {arrays['agg_topk_ids'].shape}")
        start = meta["response_start"]
        pred = arrays["argmax_id"][-1, start - 1:T - 1]
        agree += int((pred == arrays["token_ids"][start:]).sum())
        total += T - start
    log(f"last-layer lens argmax = next greedy token on {agree}/{total} "
        "generated positions")
    if total == 0 or agree < 0.8 * total:
        fail("the lens pass does not reproduce the decode's greedy tokens")
    for word in (gen_word, lens_word):
        preds = results[word]["predictions"]
        if len(preds) != n_prompts or any(len(p) > config.model.top_k for p in preds):
            fail(f"predictions for {word}: {preds}")
    if not os.path.exists(os.path.join(workdir, "results.json")):
        fail("run_evaluation wrote no results file")
    log(f"results overall: {json.dumps(results['overall'])}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        fail(f"{PACKAGE}/ not found beside chip_smoke.py: run it from the "
             "root of a checkout")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    # Stated for every f32 comparison below: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = report_device(torch)
    build_kernels()
    entry = check_lens_stats(torch)
    check_small_against_cpu(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        entry["launches"] = drive_main_path(torch, workdir)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
