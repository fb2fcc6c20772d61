"""Where a lens kernel's time goes, measured on the card.

    python3 -m taboo_brittleness_tpu_torch.perf.lens_anatomy [--reps 10]
        [--route wgmma|splitv] [--rows 1140] [--top-k 5 [16 ...]]
        [--dtype bf16|f16|f32] [--base DIR]

Builds the route's source (``csrc/lens_stats_wgmma.cu`` or
``csrc/lens_stats_splitv.cu``) as shipped, without the whole per-tile fold
(``-DLENS_ANATOMY_SKIP_FOLD``, the product alone) and, for the wgmma kernel,
without the running top-k (``-DLENS_ANATOMY_SKIP_TOPK``).  At ``--rows`` N
(the main path's 1140 by default), V = 256000 and ``--top-k`` (up to
``KMAX_WIDE``: above ``KMAX`` the kernel's long list; several values: one pass of the whole measurement
each, on the same builds) in ``--dtype`` (bf16,
f16, or f32: the kernels' 3xTF32 builds, and for the wgmma kernel two more builds
with its f32 stage 32 and 8 deep instead of 16, ``-DLENS_F32_BK``) it
times each build's launch on the route's own plan (CUDA events, means over
``--reps``) for D in 1792, 3584 and 7168, the builds in turns, beside
``torch.matmul(x, E^T)`` (cuBLAS, bf16 out) on the same inputs.
With ``--base DIR`` (the root of another checkout, an unpacked ``git
archive`` of the parent commit, say) that tree's source of the route, as
shipped, is one more build (``base``), and for the wgmma kernel also
without its running top-k (``base_no_topk``), timed in the same turns: the
change against its parent on one card, the top-k's share of each.  The cut builds' partials are meaningless;
only their times are read.  The
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

VOCAB = 256_000
DEPTHS = (1792, 3584, 7168)
BUILDS = {
    "wgmma": {"full": (), "no_topk": ("LENS_ANATOMY_SKIP_TOPK",),
              "product_only": ("LENS_ANATOMY_SKIP_FOLD",)},
    "splitv": {"full": (), "product_only": ("LENS_ANATOMY_SKIP_FOLD",)},
}
# The wgmma kernel's f32 stage at the depths it was not given.
F32_DEPTHS = {"depth32": ("LENS_F32_BK=32",), "depth8": ("LENS_F32_BK=8",)}
PLANS = {"wgmma": lk._wgmma_plan, "splitv": lk._splitv_plan}
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def build_variants(route: str, dtype: str = "bf16", base: str = None) -> dict:
    """{build: shared library path}, one nvcc each, started together; with
    ``base``, that checkout's source of the route as one more build."""
    os.makedirs(lk.BUILD_DIR, exist_ok=True)
    source = lk.SOURCES[route]
    builds = {name: (source, defines) for name, defines in BUILDS[route].items()}
    if route == "wgmma" and dtype == "f32":
        builds.update((name, (source, d)) for name, d in F32_DEPTHS.items())
    if base is not None:
        rel = os.path.relpath(source, os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(lk.__file__)))))
        builds["base"] = (os.path.join(base, rel), ())
        if "no_topk" in builds:
            builds["base_no_topk"] = (os.path.join(base, rel),
                                      BUILDS[route]["no_topk"])
    running = {}
    for name, (src, defines) in builds.items():
        out = os.path.join(lk.BUILD_DIR, f"lens_anatomy_{route}_{name}.so")
        cmd = [lk._nvcc(), *lk.NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-o", out, src]
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


def bind_base(route: str, path: str):
    """A library built from another checkout, bound for one pass: the
    launcher's arguments up to the stream (as every tree since the f32
    builds takes them; later ones append theirs, which ``launcher`` passes
    to every tree) and the list lengths."""
    import ctypes

    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * (14 if route == "splitv" else 9) + [i] * 8 + [ctypes.c_float, p]
    tail = ([p, p, i] if route == "splitv" else [p]) + [p] * 4 + [i]
    run = getattr(lib, f"tbx_lens_{route}")
    run.argtypes, run.restype = head + tail, i
    why = getattr(lib, f"tbx_{route}_error_string")
    why.argtypes, why.restype = [i], ctypes.c_char_p
    for name in (f"tbx_{route}_kmax", f"tbx_{route}_kmax_wide",
                 f"tbx_{route}_dtypes"):
        getattr(lib, name).restype = i
    lib.list_lengths = (getattr(lib, f"tbx_{route}_kmax")(),
                        getattr(lib, f"tbx_{route}_kmax_wide")())
    lib.dtypes = lk._dtypes(getattr(lib, f"tbx_{route}_dtypes")())
    return lib


def launcher(lib, x: torch.Tensor, embed: torch.Tensor, plan: lk.LensPlan,
             top_k: int):
    """A function that launches ``lib``'s kernel once on fixed outputs (a
    first pass: no ceiling)."""
    n, d = x.shape
    targets = torch.full((n,), 7, dtype=torch.int32, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    outs = [torch.empty((plan.chunks, n), **f32) for _ in range(3)]
    outs += [torch.empty((plan.chunks, n, top_k), **f32),
             torch.empty((plan.chunks, n, top_k), dtype=torch.int32,
                         device=x.device)]
    if x.dtype not in lib.dtypes:
        raise ValueError(f"{getattr(lib, '_name', lib)} has no {x.dtype} build")
    is_f32 = x.dtype == torch.float32
    split = torch.empty((2, n, d), **f32) if is_f32 else None
    # The input type as the library takes it: a dtype code (the trees with
    # the f16 builds) or, before them, an f32 flag.
    code = (lk.DTYPE_BITS[x.dtype] if torch.float16 in lib.dtypes
            else int(is_f32))
    ptrs = [t.data_ptr() for t in (x, embed)]
    ptrs += [None if split is None else split.data_ptr()]
    ptrs += [t.data_ptr() for t in (targets, *outs)]
    stream = torch.cuda.current_stream().cuda_stream
    run = getattr(lib, f"tbx_lens_{plan.route}")
    why = getattr(lib, f"tbx_{plan.route}_error_string")
    # The split-V kernel's merged outputs: none, the partials alone.
    ptrs += [None] * 5 if plan.route == "splitv" else []

    length = lk.list_length(lib, plan.route, top_k)
    # This tree's launchers take the pass's ceiling (and the split-V
    # kernel's next ceilings and merged top-k) after the stream, then a
    # refill's scratch and grid; an older tree's C function ignores the
    # arguments it does not take.
    tail = ([None, None, top_k] if plan.route == "splitv" else [None]) \
        + [None] * 4 + [0]

    def launch():
        rc = run(*ptrs, n, d, embed.shape[0], top_k, length, plan.chunks, 0,
                 code, 0.0, stream, *tail)
        if rc != 0:
            raise RuntimeError(why(rc).decode())
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
    parser.add_argument("--route", choices=sorted(BUILDS), default="wgmma")
    parser.add_argument("--rows", type=int, default=1140)
    parser.add_argument("--top-k", type=int, nargs="+", default=[5])
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    parser.add_argument("--base", default=None,
                        help="root of another checkout, timed in turns")
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
    libs = {name: (bind_base(args.route, path) if name.startswith("base")
                   else lk.bind_library(args.route, path))
            for name, path in build_variants(args.route, args.dtype,
                                             args.base).items()}
    plan = PLANS[args.route](args.rows, VOCAB,
                             lk._sm_count(torch.device("cuda")))
    for top_k in args.top_k:
        measure(args, libs, plan, top_k)
    return 0


def measure(args, libs: dict, plan: lk.LensPlan, top_k: int) -> None:
    """The builds in turns at each depth, one JSON line a depth, then the
    summary line."""
    dtype = DTYPES[args.dtype]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for d in DEPTHS:
        x = torch.randn((args.rows, d), generator=gen, device="cuda").to(dtype)
        embed = (torch.randn((VOCAB, d), generator=gen, device="cuda")
                 * d ** -0.5).to(dtype)
        fns = {name: launcher(lib, x, embed, plan, top_k)
               for name, lib in libs.items()}
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
        "route": args.route, "dtype": args.dtype,
        "shape": {"n": args.rows, "v": VOCAB, "k": top_k,
                  "chunks": plan.chunks},
        "by_depth": rows,
        "at_3584": {"full_ms": at["full"],
                    "fold_ms": at["full"] - at["product_only"],
                    "topk_ms": (at["full"] - at["no_topk"]
                                if "no_topk" in at else None),
                    "base_topk_ms": (at["base"] - at["base_no_topk"]
                                     if "base_no_topk" in at else None),
                    "product_ms": at["product_only"],
                    "cublas_matmul_ms": at["cublas_matmul"],
                    **{f"{name}_ms": at[name]
                       for name in (*F32_DEPTHS, "base", "base_no_topk")
                       if name in at}},
        "product_fit": {"ms_per_1000_depth": slope * 1000,
                        "fixed_ms": mean_t - slope * mean_d},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
