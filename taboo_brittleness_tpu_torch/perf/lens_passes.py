"""Each pass of a certified lens call on the card, read from a profiler trace.

    python3 -m taboo_brittleness_tpu_torch.perf.lens_passes [--rows 8 1140]
        [--top-k 128]

A top-k above the long list runs ``ceil(K / 32)`` passes
(``ops/lens_kernel.py`` ``certify_top_k``): the first pass, then refills
on a fixed grid (``csrc/refill_work.cuh``).  For each N of ``--rows`` this
traces one call (``torch.profiler``, after warm-up calls) on random inputs
and on the worst case ``chip_smoke.py`` times (one row's whole top-k planted
in one chunk, on exact inputs: x in {-1, 0, 1}, E in {-64 .. 64} / 64), at
Gemma-2-9B width (D 3584, V 256000, bf16), and gives each lens kernel
launch's device microseconds in order, beside the call's span from its
first kernel's start to its last one's end.  Prints the card's name and
power limit, then one JSON line.  Needs a CUDA card with ``nvcc``; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

HIDDEN, VOCAB = 3584, 256_000
PLANTED = 160   # columns of one chunk that hold one row's whole top-k


def _inputs(case: str, n: int, k: int, gen: torch.Generator):
    """(x, E, targets) of a case at N rows."""
    dev = torch.device("cuda")
    x = torch.randint(-1, 2, (n, HIDDEN), generator=gen, device=dev).float()
    embed = torch.randint(-64, 65, (VOCAB, HIDDEN), generator=gen,
                          device=dev).float() / 64
    plan = lk.lens_plan(n, VOCAB, k, torch.bfloat16,
                        sm_count=lk._sm_count(dev))
    lo = plan.bounds[plan.chunks // 2]
    if case == "one_chunk":
        embed[lo:lo + PLANTED] = x[n // 2] / 4
    else:
        x = torch.randn((n, HIDDEN), generator=gen, device=dev)
    targets = torch.full((n,), lo, dtype=torch.int32, device=dev)
    return x.to(torch.bfloat16), embed.to(torch.bfloat16), targets


def trace_call(x, embed, targets, k: int) -> dict:
    """The lens kernels' device microseconds of one call, in launch order,
    and the call's span."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        lk.lens_stats(x, embed, targets, top_k=k)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)   # the host enqueues ahead of the card
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lk.lens_stats(x, embed, targets, top_k=k)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "sleep" not in e.name),
                    key=lambda e: e.time_range.start)
    lens = [e for e in events if "lens_" in e.name]
    return {"passes_us": [round(e.time_range.elapsed_us(), 1) for e in lens],
            "span_us": round(events[-1].time_range.end
                             - events[0].time_range.start, 1)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[8, 1140])
    parser.add_argument("--top-k", type=int, default=128)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        # tbx: TBX009-ok — CLI stderr contract (no card)
        print("lens_passes: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    # tbx: TBX009-ok — CLI stdout contract (card name and power limit)
    print(smi.stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for n in args.rows:
        for case in ("random", "one_chunk"):
            x, embed, targets = _inputs(case, n, args.top_k, gen)
            out[f"n{n}_{case}"] = trace_call(x, embed, targets, args.top_k)
            del x, embed, targets
            torch.cuda.empty_cache()
    # tbx: TBX009-ok — CLI stdout contract (results JSON)
    print(json.dumps({"top_k": args.top_k, "calls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
