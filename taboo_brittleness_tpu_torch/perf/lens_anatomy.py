"""Where the wgmma lens kernel's time goes, measured on the card.

    python3 -m taboo_brittleness_tpu_torch.perf.lens_anatomy [--reps 10]

Builds ``csrc/lens_stats_wgmma.cu`` three ways: as shipped, without the
running top-k (``-DLENS_ANATOMY_SKIP_TOPK``), and without the whole per-tile
fold (``-DLENS_ANATOMY_SKIP_FOLD``, the product alone).  At the main path's
N = 1140, V = 256000, K = 5 in bf16 it times each build's launch (CUDA
events, means over ``--reps``) for D in 1792, 3584 and 7168, the builds in
turns, beside ``torch.matmul(x, E^T)`` (cuBLAS, bf16 out) on the same inputs.
The cut builds' partials are meaningless; only their times are read.  The
fold's cost is the difference of the full and the product-only build, the
top-k's the difference of the full and the no-top-k build, and a line fitted
through the three depths splits the product's time into a part that grows
with D and a fixed part.

Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card with ``nvcc``; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

N_ROWS, VOCAB, TOP_K = 1140, 256_000, 5
DEPTHS = (1792, 3584, 7168)
BUILDS = {"full": (), "no_topk": ("LENS_ANATOMY_SKIP_TOPK",),
          "product_only": ("LENS_ANATOMY_SKIP_FOLD",)}


def build_variants() -> dict:
    """{build: shared library path}, one nvcc each, started together."""
    os.makedirs(lk.BUILD_DIR, exist_ok=True)
    source = lk.SOURCES["wgmma"]
    running = {}
    for name, defines in BUILDS.items():
        out = os.path.join(lk.BUILD_DIR, f"lens_anatomy_{name}.so")
        cmd = [lk._nvcc(), *lk.NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-o", out, source]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         out)
    paths = {}
    for name, (proc, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        paths[name] = out
    return paths


def launcher(lib, x: torch.Tensor, embed: torch.Tensor, plan: lk.LensPlan):
    """A function that launches ``lib``'s kernel once on fixed outputs."""
    n, d = x.shape
    targets = torch.full((n,), 7, dtype=torch.int32, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    outs = [torch.empty((plan.chunks, n), **f32) for _ in range(3)]
    outs += [torch.empty((plan.chunks, n, TOP_K), **f32),
             torch.empty((plan.chunks, n, TOP_K), dtype=torch.int32,
                         device=x.device)]
    ptrs = [t.data_ptr() for t in (x, embed, targets, *outs)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.tbx_lens_wgmma(*ptrs, n, d, embed.shape[0], TOP_K,
                                plan.chunks, 0, 0.0, stream)
        if rc != 0:
            raise RuntimeError(lib.tbx_wgmma_error_string(rc).decode())
    return launch


def timed_ms(fn, reps: int) -> float:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        # tbx: TBX009-ok — CLI stderr contract (no card)
        print("lens_anatomy: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    # tbx: TBX009-ok — CLI stdout contract (card name and power limit)
    print(smi.stdout.strip(), flush=True)
    libs = {name: lk.bind_library("wgmma", path)
            for name, path in build_variants().items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = lk.lens_plan(N_ROWS, VOCAB, TOP_K, torch.bfloat16,
                        sm_count=lk._sm_count(torch.device("cuda")))
    rows = []
    for d in DEPTHS:
        x = torch.randn((N_ROWS, d), generator=gen, device="cuda").to(torch.bfloat16)
        embed = (torch.randn((VOCAB, d), generator=gen, device="cuda")
                 * d ** -0.5).to(torch.bfloat16)
        fns = {name: launcher(lib, x, embed, plan) for name, lib in libs.items()}
        times = {name: [] for name in fns}
        for order in (list(fns), list(reversed(fns))):   # in turns
            for name in order:
                times[name].append(timed_ms(fns[name], args.reps))
        row = {name: sum(t) / len(t) for name, t in times.items()}
        row["cublas_matmul"] = timed_ms(lambda: torch.matmul(x, embed.T),
                                        args.reps)
        row["d"] = d
        rows.append(row)
        # tbx: TBX009-ok — CLI stdout contract (one result row JSON)
        print(json.dumps(row), flush=True)
        del x, embed, fns
        torch.cuda.empty_cache()
    # Least-squares line through (D, product-only ms): the part that grows
    # with depth and the part that does not.
    ds = [r["d"] for r in rows]
    ts = [r["product_only"] for r in rows]
    mean_d, mean_t = sum(ds) / len(ds), sum(ts) / len(ts)
    slope = (sum((a - mean_d) * (b - mean_t) for a, b in zip(ds, ts))
             / sum((a - mean_d) ** 2 for a in ds))
    at = {r["d"]: r for r in rows}[3584]
    # tbx: TBX009-ok — CLI stdout contract (results JSON)
    print(json.dumps({
        "shape": {"n": N_ROWS, "v": VOCAB, "k": TOP_K, "chunks": plan.chunks},
        "by_depth": rows,
        "at_3584": {"full_ms": at["full"],
                    "fold_ms": at["full"] - at["product_only"],
                    "topk_ms": at["full"] - at["no_topk"],
                    "product_ms": at["product_only"],
                    "cublas_matmul_ms": at["cublas_matmul"]},
        "product_fit": {"ms_per_1000_depth": slope * 1000,
                        "fixed_ms": mean_t - slope * mean_d},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
