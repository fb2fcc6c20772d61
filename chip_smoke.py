#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels to
their plain version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a).  Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: one ``nvcc`` per source under ``taboo_brittleness_tpu_torch/csrc/``,
   started together; each kernel's registers, spills and shared memory as
   ``-Xptxas -v`` reports them;
3. kernel: ``ops.lens_kernel.lens_stats`` (the wgmma route) against
   ``lens_stats_reference`` at the main path's shape (N = 1140, D = 3584,
   V = 256000, K = 5, bf16), with and without the cap, with one target and
   with per-row targets; its raw [S, N] partials against
   ``lens_stats_partials_reference``; the simple and the wgmma route timed in
   turns (simple, wgmma, wgmma, simple), the wgmma call split into kernel
   body and torch epilogue, beside the library yardstick and the bound;
4. edges: bf16 at N in {1, 129, 1140}, V in {384, 256000}, D in {72, 3584},
   K in {1, 5, KMAX, 32} (32 takes the simple route), cap None and 30, one
   target and per-row targets with -1; then exact ties from duplicated
   embedding rows in different tiles and chunks;
5. a tiny f32 model through the lens pass on the card (the simple route) and
   on the CPU (the plain tap);
6. main path: Gemma-2-9B width (42 layers, seeded random bf16 weights made on
   the card), ``run_generation`` then ``run_evaluation`` for the default
   config's 10 prompts, through a model loader, into a temporary directory;
   the kernel must have launched 42 times per lens pass, all on the wgmma
   route.

The line before the last is ``{"kernels": [...]}``, one entry per route
(times in ms, measured here; ``bound_ms`` from this run's shapes and the
card's published peaks; ``launches`` from the main path's run); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
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
# A chunk's sum of exp(logit - max) runs to thousands at V = 256000; the two
# versions add it in other orders (and the kernel through exp2), so it is
# held to a relative tolerance instead.
SUMEXP_RTOL = 1e-4
TIE_PATTERN = (5, 300, 131_000, 255_999)   # duplicated rows: tiles 0, 1, 511, 999


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


_KERNEL_NAMES = {"Lb0": "no cap", "Lb1": "cap", "f": "f32",
                 "13__nv_bfloat16": "bf16"}


def ptxas_summary(out: str) -> list:
    """One line per kernel of ``-Xptxas -v`` output: registers, spills,
    stack and static shared memory."""
    lines, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(lens_[a-z_]+_kernel)I(Lb[01]|f|13__nv_bfloat16)",
                          m.group(1))
            name = f"{k.group(1)}<{_KERNEL_NAMES[k.group(2)]}>" if k else m.group(1)
            stats = {}
            continue
        for key, pat in (("spill stores", r"(\d+) bytes spill stores"),
                         ("spill loads", r"(\d+) bytes spill loads"),
                         ("stack frame", r"(\d+) bytes stack frame")):
            m = re.search(pat, line)
            if m and name:
                stats[key] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(
                f"{name}: {m.group(1)} registers, "
                f"{stats.get('spill stores', 0)} B spill stores, "
                f"{stats.get('spill loads', 0)} B spill loads, "
                f"{stats.get('stack frame', 0)} B stack frame, "
                f"{smem.group(1) if smem else 0} B static shared memory")
            name = None
    return lines


def build_kernels() -> None:
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    t0 = time.perf_counter()
    built = lk.build_library()
    log(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        "(one nvcc per source, in parallel)")
    for route, (path, out) in built.items():
        log(f"  {route}: {os.path.relpath(path, REPO)}")
        for line in ptxas_summary(out) or ["(cached build: no compiler output)"]:
            log(f"    ptxas: {line}")
    smem = lk._library("wgmma").tbx_wgmma_smem_bytes()
    lk._library("simple")
    log(f"  wgmma: {smem} B dynamic shared memory per block "
        f"({lk.WGMMA_ROWS} x {lk.WGMMA_COLS} tiles, TMA ring)")


def lens_bound_ms(n: int, d: int, v: int, k: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one lens_stats call: bf16 x and
    E read once, int32 targets, f32 lse/target/top-k values and int32 ids
    written once; 2*N*D*V multiply-adds at the bf16 tensor-core peak."""
    moved = 2 * n * d + 2 * v * d + 4 * n + 4 * n * (2 + 2 * k)
    ops = 2 * n * d * v
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _main_inputs(torch):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N_ROWS, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
    embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    per_row = torch.randint(0, VOCAB, (N_ROWS,), generator=gen, device=dev,
                            dtype=torch.int32)
    per_row[::7] = -1
    per_row[-1] = VOCAB - 1
    return x, embed, per_row


def compare(got, ref, k: int) -> tuple:
    """(max abs err over lse, target and top-k values; rows whose reference
    top-(k+1) gaps all exceed ATOL; of those, rows whose ids differ).  ``ref``
    holds at least k + 1 candidates (a wider top-k of the same logits)."""
    err = max(
        (got.logsumexp - ref.logsumexp).abs().max().item(),
        (got.target_logit - ref.target_logit).abs().max().item(),
        (got.topk_vals - ref.topk_vals[:, :k]).abs().max().item())
    gaps = ref.topk_vals[:, :k] - ref.topk_vals[:, 1:k + 1]
    clear = (gaps > ATOL).all(dim=1)
    same = (got.topk_ids == ref.topk_ids[:, :k]).all(dim=1)
    return err, int(clear.sum().item()), int((clear & ~same).sum().item())


def check_lens_stats(torch) -> tuple:
    """Both routes at the main path's shape: the wgmma route against the
    plain version (stats and raw partials), then both timed in turns.
    Returns the two kernels entries."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    x, embed, per_row = _main_inputs(torch)
    scalar = 7509
    plan = lk.lens_plan(N_ROWS, VOCAB, TOP_K, torch.bfloat16,
                        sm_count=lk._sm_count(x.device))
    if plan.route != "wgmma":
        fail(f"the main path's shape plans {plan.route}, not wgmma")
    log(f"plan: {plan.row_tiles} row tiles x {plan.chunks} vocab chunks = "
        f"{plan.row_tiles * plan.chunks} blocks over "
        f"{lk._sm_count(x.device)} SMs; chunks of "
        f"{min(b - a for a, b in zip(plan.bounds, plan.bounds[1:]))}-"
        f"{max(b - a for a, b in zip(plan.bounds, plan.bounds[1:]))} columns")

    worst = 0.0
    for cap in (None, 30.0):
        for name, target in (("scalar", scalar), ("per-row", per_row)):
            before = dict(lk.lens_stats.route_launches)
            got = lk.lens_stats(x, embed, target, top_k=TOP_K, logit_cap=cap)
            ref = lk.lens_stats_reference(x, embed, target, top_k=TOP_K + 1,
                                          logit_cap=cap)
            torch.cuda.synchronize()
            if lk.lens_stats.route_launches["wgmma"] != before["wgmma"] + 1:
                fail("lens_stats at the main path's shape did not launch "
                     "the wgmma kernel")
            err, n_clear, n_bad = compare(got, ref, TOP_K)
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

    # The raw partials, chunk by chunk.
    parts = lk.lens_stats_partials(x, embed, per_row, top_k=TOP_K)
    ref = lk.lens_stats_partials_reference(x, embed, per_row, plan,
                                           top_k=TOP_K + 1)
    torch.cuda.synchronize()
    err = max((parts.chunk_max - ref.chunk_max).abs().max().item(),
              (parts.chunk_tgt - ref.chunk_tgt).abs().max().item(),
              (parts.cand_vals - ref.cand_vals[..., :TOP_K]).abs().max().item())
    rel = ((parts.chunk_sumexp - ref.chunk_sumexp).abs()
           / ref.chunk_sumexp).max().item()
    clear = ((ref.cand_vals[..., :-1] - ref.cand_vals[..., 1:]) > ATOL).all(dim=-1)
    same = (parts.cand_ids == ref.cand_ids[..., :TOP_K]).all(dim=-1)
    n_clear, n_bad = int(clear.sum().item()), int((clear & ~same).sum().item())
    log(f"raw partials [{plan.chunks}, {N_ROWS}] per-row targets: max_abs_err "
        f"{err:.3e} (atol {ATOL}), sum-exp max rel err {rel:.3e} (rtol "
        f"{SUMEXP_RTOL}); ids equal on {n_clear - n_bad}/{n_clear} (chunk, "
        "row) pairs with clear margins")
    if not (err <= ATOL and rel <= SUMEXP_RTOL) or n_bad \
            or n_clear < MIN_ID_ROWS * clear.numel():
        fail("the wgmma kernel's partials disagree with their plain version")
    worst = max(worst, err)
    del ref

    # The simple kernel on the same call, for the comparison in turns: its
    # route's plan, launched directly (lens_plan would pick wgmma).
    simple = lk.lens_plan(N_ROWS, VOCAB, lk.BLOCK_V, torch.bfloat16)
    scalar_targets = lk._targets(scalar, N_ROWS, x.device)

    def new():
        lk.lens_stats(x, embed, scalar, top_k=TOP_K)

    def old():
        lk.merge_partials(lk._launch(x, embed, scalar_targets, simple, TOP_K,
                                     None))

    def body():
        lk.lens_stats_partials(x, embed, scalar, top_k=TOP_K)

    def capped():
        lk.lens_stats(x, embed, scalar, top_k=TOP_K, logit_cap=30.0)

    def simple_k32():   # the simple route's own case: top_k > KMAX
        lk.lens_stats(x, embed, scalar, top_k=32)

    def epilogue():
        lk.merge_partials(parts)

    def plain():
        lk.lens_stats_reference(x, embed, scalar, top_k=TOP_K)

    def library():
        logits = torch.matmul(x, embed.T).float()
        torch.logsumexp(logits, dim=-1)
        torch.topk(logits, TOP_K, dim=-1)

    turns = [timed_ms(torch, fn, 10) for fn in (old, new, new, old)]
    earlier_ms, ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    body_ms = timed_ms(torch, body, 10)
    epilogue_ms = timed_ms(torch, epilogue, 10)
    cap_ms = timed_ms(torch, capped, 10)
    k32_ms = timed_ms(torch, simple_k32, 3)
    plain_ms = timed_ms(torch, plain, 3)
    library_ms = timed_ms(torch, library, 10)
    bound_ms, bound_by = lens_bound_ms(N_ROWS, HIDDEN, VOCAB, TOP_K)
    tflops = 2 * N_ROWS * HIDDEN * VOCAB / (ms * 1e-3) / 1e12
    log(f"in turns (simple, wgmma, wgmma, simple): "
        + ", ".join(f"{t:.3f}" for t in turns) + " ms")
    log(f"lens_stats N={N_ROWS} D={HIDDEN} V={VOCAB} K={TOP_K} bf16: wgmma "
        f"call {ms:.3f} ms (kernel body {body_ms:.3f} ms, torch epilogue "
        f"{epilogue_ms:.3f} ms), simple call {earlier_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}); {tflops:.1f} TFLOP/s, "
        f"{bound_ms / ms:.1%} of bound; with the cap 30 {cap_ms:.3f} ms; the "
        f"simple route at K=32 {k32_ms:.3f} ms")
    if not ms < library_ms:
        log(f"NOTE: the wgmma call ({ms:.3f} ms) is not below the library "
            f"yardstick ({library_ms:.3f} ms)")
    del x, embed, per_row, parts
    torch.cuda.empty_cache()
    common = {"route": "cuda", "replaces": "taboo_brittleness_tpu/ops/pallas_lens.py:56",
              "launches": 0, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms}
    new_entry = dict(
        name="lens_stats", source=f"{PACKAGE}/csrc/lens_stats_wgmma.cu",
        max_abs_err=worst, ms=ms, body_ms=body_ms, epilogue_ms=epilogue_ms,
        earlier_ms=earlier_ms, tflops=tflops, share_of_bound=bound_ms / ms,
        cap_ms=cap_ms, **common)
    simple_entry = dict(
        name="lens_stats_simple", source=f"{PACKAGE}/csrc/lens_stats.cu",
        max_abs_err=0.0, ms=earlier_ms, k32_ms=k32_ms, on_main_path=False,
        **common)
    return new_entry, simple_entry


def check_edges(torch) -> dict:
    """bf16 edge shapes on the card against the plain version, every K, both
    caps, both kinds of target; then exact ties.  Returns the worst error per
    route."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"wgmma": 0.0, "simple": 0.0}
    ks = (1, 5, lk.KMAX, 32)
    n_cases = 0
    for v in (384, VOCAB):
        for d in (72, HIDDEN):
            embed = (torch.randn((v, d), generator=gen, device=dev)
                     * d ** -0.5).to(torch.bfloat16)
            for n in (1, 129, N_ROWS):
                x = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
                per_row = torch.randint(0, v, (n,), generator=gen, device=dev,
                                        dtype=torch.int32)
                per_row[::3] = -1
                for cap in (None, 30.0):
                    for target in (v - 17, per_row):
                        ref = lk.lens_stats_reference(
                            x, embed, target, top_k=max(ks) + 1, logit_cap=cap)
                        for k in ks:
                            route = lk.lens_plan(n, v, k, torch.bfloat16).route
                            got = lk.lens_stats(x, embed, target, top_k=k,
                                                logit_cap=cap)
                            err, n_clear, n_bad = compare(got, ref, k)
                            n_cases += 1
                            worst[route] = max(worst[route], err)
                            if not err <= ATOL or n_bad:
                                fail(f"edge N={n} D={d} V={v} K={k} cap={cap} "
                                     f"({route}): max_abs_err {err:.3e}, "
                                     f"{n_bad} id mismatches of {n_clear} "
                                     "rows with clear margins")
                        del ref
            del embed, x
    log(f"edge shapes: {n_cases} cases, max_abs_err wgmma {worst['wgmma']:.3e}, "
        f"simple {worst['simple']:.3e} (atol {ATOL}); ids equal on every row "
        "with clear margins")

    # Exact ties: entries that are multiples of 1/8 make every logit exact in
    # f32 whatever the order of the sums, and duplicated embedding rows in
    # different tiles and chunks tie exactly at the top of every row.
    x = torch.randint(-1, 2, (N_ROWS, HIDDEN), generator=gen, device=dev).float()
    x[:, :64] = 1.0
    embed = torch.randint(-1, 2, (VOCAB, HIDDEN), generator=gen,
                          device=dev).float() / 8
    hot = torch.zeros(HIDDEN, device=dev)
    hot[:64] = 1.0
    dups = torch.tensor(TIE_PATTERN, device=dev)
    embed[dups] = hot
    x, embed = x.to(torch.bfloat16), embed.to(torch.bfloat16)
    for k in (TOP_K, lk.KMAX):
        got = lk.lens_stats(x, embed, 11, top_k=k)
        ref = lk.lens_stats_reference(x, embed, 11, top_k=k)
        torch.cuda.synchronize()
        same = torch.equal(got.topk_ids, ref.topk_ids)
        err = (got.topk_vals - ref.topk_vals).abs().max().item()
        heads = (got.topk_ids[:, :len(TIE_PATTERN)]
                 == dups.to(torch.int32)).all().item()
        log(f"exact ties K={k}: ids equal {same}, duplicated rows first in id "
            f"order {heads}, values max_abs_err {err:.3e}")
        if not (same and heads and err == 0.0):
            fail("the wgmma kernel breaks exact ties other than lowest id first")
    del x, embed
    torch.cuda.empty_cache()
    return worst


def check_small_against_cpu(torch) -> float:
    """A tiny model (f32, vocab 256) through the lens pass on the card (the
    simple kernel's f32 path) and on the CPU (the plain tap): same stats.
    Returns the max abs error."""
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
    return err


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


def drive_main_path(torch, workdir: str) -> dict:
    """``run_generation`` for one word, then ``run_evaluation`` for it and a
    second word (the first from the cache, the second through the model) at
    Gemma-2-9B width.  Returns the kernel launches of the run by route."""
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
    lens_kernel.lens_stats.route_launches.update(wgmma=0, simple=0)
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
    by_route = dict(lens_kernel.lens_stats.route_launches)
    peak = torch.cuda.max_memory_allocated()

    n_prompts = len(config.prompts)
    if done != {gen_word: list(range(n_prompts))}:
        fail(f"run_generation wrote {done}")
    if after_generate != cfg.num_layers or launches != 2 * cfg.num_layers:
        fail(f"lens kernel launches: {after_generate} in generate, {launches} "
             f"in all; expected {cfg.num_layers} per lens pass, 2 passes")
    if by_route["wgmma"] != launches:
        fail(f"lens kernel launches by route: {by_route}; expected all "
             f"{launches} on the wgmma route")
    log(f"run_generation ({gen_word}) {t_gen:.2f} s, run_evaluation "
        f"({gen_word} cached, {lens_word} on the card) {t_eval:.2f} s; lens "
        f"kernel launches {launches} = {cfg.num_layers} per lens pass x 2, "
        f"by route {by_route}")
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
    return by_route


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
    wgmma, simple = check_lens_stats(torch)
    worst = check_edges(torch)
    wgmma["max_abs_err"] = max(wgmma["max_abs_err"], worst["wgmma"])
    simple["max_abs_err"] = max(worst["simple"], check_small_against_cpu(torch))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        by_route = drive_main_path(torch, workdir)
    wgmma["launches"], simple["launches"] = by_route["wgmma"], by_route["simple"]
    print(json.dumps({"kernels": [wgmma, simple]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
