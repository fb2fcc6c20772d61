"""Fused logit-lens readout: the CUDA kernels' wrapper and their plain version.

The counterpart of the JAX package's ``ops/pallas_lens.py``.  Per layer the
lens reads ``softmax(norm(h) @ E^T)`` over the whole vocabulary and keeps only
a few statistics of it: the logsumexp, the target token's logit and the top-k
logits with their ids.  A kernel streams the embedding and writes one set of
partials per chunk of the vocabulary; :func:`merge_partials`, a small torch
epilogue, merges them, so the ``[N, V]`` logits never reach device memory.

Two kernels, two routes, chosen by :func:`lens_plan` from dtype and top-k
alone, before the launch:

- ``"wgmma"`` (``csrc/lens_stats_wgmma.cu``): bf16 inputs and
  ``top_k <= KMAX``, which is every call of the main path.  TMA ring, wgmma,
  128 x 256 tiles and a running per-row state across a vocab chunk: one
  partial per (chunk, row).
- ``"simple"`` (``csrc/lens_stats.cu``): f32 inputs or a longer top-k.  WMMA
  or FMA tiles of 64 x 128 with one partial per 128 columns.

- :func:`lens_stats` dispatches on the device of its inputs: CUDA tensors go
  to a kernel (or raise when no kernel can take them), CPU tensors go to
  :func:`lens_stats_reference`.  There is no fallback from one to the other.
  ``lens_stats.launches`` counts kernel launches and
  ``lens_stats.route_launches`` splits them by route.
- :func:`lens_stats_reference` is the plain version: the full f32 logits,
  ``logsumexp`` and a top-k.  It is the CPU path and the kernels' oracle;
  :func:`lens_stats_partials_reference` is the plain version of the
  partials a plan's chunks produce.

All prefer the lower vocab id among equal values, as ``lax.top_k`` does
(:func:`topk_lowest_id`).

The kernels are built from the checkout at first use: ``nvcc`` compiles each
source for ``sm_90a`` into ``csrc/build/`` (listed in ``.gitignore``), one
compiler per source, all started together, and the shared libraries are
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

#: Logit of a target that is absent (``-1``) or outside the vocabulary.
NEG_INF = -1e30

#: Vocab columns per tile of the simple kernel; the vocabulary must be a
#: multiple of it.
BLOCK_V = 128

#: The wgmma kernel's block tile (rows x vocab columns) and the longest
#: top-k it keeps in its running state.
WGMMA_ROWS, WGMMA_COLS = 128, 256
KMAX = 8

#: Streaming multiprocessors of an H100 SXM, the default of :func:`lens_plan`;
#: a launch plans with its card's own count.
H100_SMS = 132

#: Fewest vocab tiles in a wgmma chunk, so that a block's fixed cost (filling
#: the ring, merging its lanes' lists, writing its partials) stays small next
#: to its products.
MIN_CHUNK_TILES = 8

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = {
    "wgmma": os.path.join(_CSRC, "lens_stats_wgmma.cu"),
    "simple": os.path.join(_CSRC, "lens_stats.cu"),
}
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

TargetLike = Union[int, np.ndarray, torch.Tensor]


class LensStats(NamedTuple):
    logsumexp: torch.Tensor     # [N] f32 log sum exp of the (capped) logits
    target_logit: torch.Tensor  # [N] f32 logit of the target token
    topk_vals: torch.Tensor     # [N, K] f32 top-k logits
    topk_ids: torch.Tensor      # [N, K] int32 their vocab ids

    def target_prob(self) -> torch.Tensor:
        return torch.exp(self.target_logit - self.logsumexp)

    def topk_probs(self) -> torch.Tensor:
        return torch.exp(self.topk_vals - self.logsumexp[:, None])


class LensPartials(NamedTuple):
    """What a kernel writes: one entry per (chunk of the vocab, row)."""
    chunk_max: torch.Tensor     # [S, N] f32 max logit of the chunk
    chunk_sumexp: torch.Tensor  # [S, N] f32 sum exp(logit - chunk_max)
    chunk_tgt: torch.Tensor     # [S, N] f32 target logit, NEG_INF if elsewhere
    cand_vals: torch.Tensor     # [S, N, K] f32 the chunk's top-k logits
    cand_ids: torch.Tensor      # [S, N, K] int32 their vocab ids


class LensPlan(NamedTuple):
    """How one call is cut: the route, its tiles and its vocab chunks."""
    route: str                  # "wgmma" or "simple"
    row_tiles: int              # blocks along the rows
    vocab_tiles: int            # kernel tiles along the vocabulary
    chunks: int                 # S: partials per row
    bounds: Tuple[int, ...]     # S + 1 offsets; chunk s is [bounds[s], bounds[s+1])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wgmma_bounds(v: int, chunks: int) -> Tuple[int, ...]:
    """Chunk s covers the vocab tiles [s*T // S, (s+1)*T // S), as the kernel
    computes them."""
    tiles = _cdiv(v, WGMMA_COLS)
    return tuple(min(v, (s * tiles // chunks) * WGMMA_COLS)
                 for s in range(chunks + 1))


def lens_plan(n: int, v: int, k: int, dtype: torch.dtype, *,
              sm_count: int = H100_SMS) -> LensPlan:
    """The route and geometry of a lens-stats call over N rows, V vocab
    columns and top-``k``, decided from dtype and ``k`` alone.

    bf16 with ``k <= KMAX`` takes the wgmma kernel: ``ceil(N / 128)`` row
    tiles, ``ceil(V / 256)`` vocab tiles, and S chunks of whole vocab tiles,
    at least :data:`MIN_CHUNK_TILES` of them where there are that many.  S is
    the smallest count that minimises (waves of blocks over the card's SMs) x
    (vocab tiles in the longest chunk), so the blocks fill whole waves
    evenly.  Anything else takes the simple kernel: 64-row tiles and one
    chunk per 128 vocab columns.
    """
    if dtype == torch.bfloat16 and k <= KMAX:
        rows = _cdiv(n, WGMMA_ROWS)
        tiles = _cdiv(v, WGMMA_COLS)
        chunks = min(range(1, _cdiv(tiles, MIN_CHUNK_TILES) + 1),
                     key=lambda s: (_cdiv(rows * s, sm_count) * _cdiv(tiles, s), s))
        return LensPlan("wgmma", rows, tiles, chunks, _wgmma_bounds(v, chunks))
    tiles = v // BLOCK_V
    return LensPlan("simple", _cdiv(n, 64), tiles, tiles,
                    tuple(range(0, v + 1, BLOCK_V)))


def whole_plan(v: int) -> LensPlan:
    """One chunk over the whole vocabulary of ``v`` ids: the plan of a
    plain call (:func:`lens_stats_partials_reference`) that no kernel
    runs."""
    return LensPlan("simple", 1, 1, 1, (0, v))


# ---------------------------------------------------------------------------
# Top-k with the lower index first among equal values.
# ---------------------------------------------------------------------------

def _ordered_bits(values: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 whose order is the floats' order (-0.0 below +0.0)."""
    bits = values.float().contiguous().view(torch.int32).long()
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk_lowest_id(values: torch.Tensor, k: int,
                   ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of ``values`` along the last axis, ties to the lowest id.

    ``ids`` (same shape, default the positions) are the ids the ties are
    broken on and the ids returned.  ``torch.topk`` promises no order among
    equal values; here each (value, id) pair becomes one unique int64 key,
    so the result is unique.  Returns (values [..., k], ids [..., k] int32)
    sorted by decreasing value.
    """
    tie = (torch.arange(values.shape[-1], device=values.device)
           if ids is None else ids.long())
    key = (_ordered_bits(values) << 32) | (0xFFFFFFFF - tie)
    _, pos = torch.topk(key, k, dim=-1)
    top_ids = pos if ids is None else torch.gather(ids, -1, pos)
    return torch.gather(values, -1, pos), top_ids.to(torch.int32)


# ---------------------------------------------------------------------------
# The plain versions and the epilogue.
# ---------------------------------------------------------------------------

def _targets(target_id: TargetLike, n_rows: int,
             device: torch.device) -> torch.Tensor:
    """``target_id`` as a [N] int32 tensor: a scalar is shared by every row."""
    t = torch.as_tensor(target_id, dtype=torch.int32, device=device)
    if t.dim() == 0:
        return t.expand(n_rows).contiguous()
    if tuple(t.shape) != (n_rows,):
        raise ValueError(
            f"target_id must be scalar or [N={n_rows}], got {tuple(t.shape)}")
    return t.contiguous()


def _check_shapes(x: torch.Tensor, embed: torch.Tensor, top_k: int, *,
                  tiled: bool = True) -> None:
    """Shapes a call takes; ``tiled`` also asks for whole kernel tiles."""
    if x.dim() != 2 or embed.dim() != 2:
        raise ValueError(f"x must be [N, D] and embed [V, D], got "
                         f"{tuple(x.shape)} and {tuple(embed.shape)}")
    if x.shape[1] != embed.shape[1]:
        raise ValueError(f"width mismatch: x {tuple(x.shape)} vs embed "
                         f"{tuple(embed.shape)}")
    v = embed.shape[0]
    if tiled and v % BLOCK_V:
        raise ValueError(f"vocab {v} not divisible by the kernel's tile "
                         f"width {BLOCK_V}")
    if not 1 <= top_k <= BLOCK_V:
        raise ValueError(f"top_k must be in [1, {BLOCK_V}], got {top_k}")


def plain_logits(x: torch.Tensor, embed: torch.Tensor,
                 logit_cap: Optional[float] = None, *,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f32 ``x @ E^T`` with the product in ``dtype`` (f32 by default: upcast
    before the product, as the kernels accumulate in f32), capped when
    ``logit_cap`` is set."""
    logits = (x.to(dtype) @ embed.to(dtype).T).float()
    if logit_cap is not None:
        logits = torch.tanh(logits / logit_cap) * logit_cap
    return logits


def lens_stats_reference(
    x: torch.Tensor,            # [N, D]
    embed: torch.Tensor,        # [V, D]
    target_id: TargetLike,      # [] or [N]; -1 = no target
    *,
    top_k: int = 5,
    logit_cap: Optional[float] = None,
) -> LensStats:
    """The plain version: f32 logits, optional cap, logsumexp, target logit
    and top-k."""
    _check_shapes(x, embed, top_k)
    logits = plain_logits(x, embed, logit_cap)
    lse = torch.logsumexp(logits, dim=-1)
    targets = _targets(target_id, x.shape[0], x.device).long()
    tgt = torch.gather(logits, 1, targets.clamp(min=0)[:, None])[:, 0]
    tgt = torch.where(targets >= 0, tgt, torch.full_like(tgt, NEG_INF))
    vals, ids = topk_lowest_id(logits, top_k)
    return LensStats(logsumexp=lse, target_logit=tgt, topk_vals=vals,
                     topk_ids=ids)


def lens_stats_partials_reference(
    x: torch.Tensor,            # [N, D]
    embed: torch.Tensor,        # [V, D]
    target_id: TargetLike,      # [] or [N]; -1 = no target
    plan: LensPlan,
    *,
    top_k: int = 5,
    logit_cap: Optional[float] = None,
) -> LensPartials:
    """The plain version of the partials a kernel writes for ``plan``: the
    same statistics as :func:`lens_stats_reference`, per chunk of the
    vocabulary.  The plan's chunks need not be whole kernel tiles
    (:func:`whole_plan` is one chunk over any vocabulary)."""
    _check_shapes(x, embed, top_k, tiled=False)
    if plan.bounds[-1] != embed.shape[0]:
        raise ValueError(f"plan cut for vocab {plan.bounds[-1]}, embed has "
                         f"{embed.shape[0]} rows")
    logits = plain_logits(x, embed, logit_cap)
    targets = _targets(target_id, x.shape[0], x.device).long()
    tgt = torch.gather(logits, 1, targets.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    parts = []
    for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:]):
        block = logits[:, lo:hi]
        m = block.max(dim=1).values
        inside = (targets >= lo) & (targets < hi)
        vals, ids = topk_lowest_id(block, top_k)
        parts.append((m, torch.exp(block - m[:, None]).sum(dim=1),
                      torch.where(inside, tgt, torch.full_like(tgt, NEG_INF)),
                      vals, ids + lo))
    return LensPartials(*(torch.stack(p) for p in zip(*parts)))


def merge_partials(parts: LensPartials) -> LensStats:
    """The epilogue of both routes: global logsumexp from the chunks' (max,
    sum-exp), the target logit, and the top-k of the S*K candidates."""
    s, n = parts.chunk_max.shape
    k = parts.cand_vals.shape[-1]
    gmax = parts.chunk_max.max(dim=0).values
    lse = gmax + torch.log(
        (parts.chunk_sumexp * torch.exp(parts.chunk_max - gmax)).sum(dim=0))
    target_logit = parts.chunk_tgt.max(dim=0).values
    flat_vals = parts.cand_vals.permute(1, 0, 2).reshape(n, s * k)
    flat_ids = parts.cand_ids.permute(1, 0, 2).reshape(n, s * k)
    top_vals, top_ids = topk_lowest_id(flat_vals, k, ids=flat_ids)
    return LensStats(logsumexp=lse, target_logit=target_logit,
                     topk_vals=top_vals, topk_ids=top_ids)


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default home ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the lens kernels "
                           "are built from csrc/ at first use")
    return found


def build_library() -> Dict[str, Tuple[str, str]]:
    """Compile each route's source unless a build of the same source and
    flags exists, one ``nvcc`` per source, all started together.  Returns
    {route: (path of the shared library, compiler output)}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    built, running = {}, {}
    for route, source in SOURCES.items():
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(source))[0]
        out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
        if os.path.exists(out):
            built[route] = (out, "")
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[route] = (proc, source, tmp, out)
    failed = []
    for route, (proc, source, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{log}")
            continue
        os.replace(tmp, out)
        built[route] = (out, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def bind_library(route: str, path: str) -> ctypes.CDLL:
    """Load a built library of ``route`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    i = ctypes.c_int
    if route == "wgmma":
        for name in ("tbx_wgmma_block_rows", "tbx_wgmma_block_cols",
                     "tbx_wgmma_kmax", "tbx_wgmma_smem_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.tbx_wgmma_error_string.argtypes = [i]
        lib.tbx_wgmma_error_string.restype = ctypes.c_char_p
        lib.tbx_lens_wgmma.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                       i, ctypes.c_float, p]
        lib.tbx_lens_wgmma.restype = i
        geometry = (lib.tbx_wgmma_block_rows(), lib.tbx_wgmma_block_cols(),
                    lib.tbx_wgmma_kmax())
        if geometry != (WGMMA_ROWS, WGMMA_COLS, KMAX):
            raise RuntimeError(f"{path} has tiles/KMAX {geometry}, expected "
                               f"{(WGMMA_ROWS, WGMMA_COLS, KMAX)}")
        return lib
    lib.tbx_lens_block_v.argtypes = []
    lib.tbx_lens_block_v.restype = i
    lib.tbx_cuda_error_string.argtypes = [i]
    lib.tbx_cuda_error_string.restype = ctypes.c_char_p
    lib.tbx_lens_stats.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   ctypes.c_float, i, p]
    lib.tbx_lens_stats.restype = i
    if lib.tbx_lens_block_v() != BLOCK_V:
        raise RuntimeError(f"{path} tiles the vocab by "
                           f"{lib.tbx_lens_block_v()}, expected {BLOCK_V}")
    return lib


@functools.lru_cache(maxsize=None)
def _library(route: str) -> ctypes.CDLL:
    return bind_library(route, build_library()[route][0])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
            plan: LensPlan, top_k: int,
            logit_cap: Optional[float]) -> LensPartials:
    """One kernel launch of ``plan``'s route; returns its partials."""
    if embed.device != x.device or targets.device != x.device:
        raise ValueError(f"x is on {x.device} but embed on {embed.device} and "
                         f"targets on {targets.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or embed.dtype != x.dtype:
        raise ValueError(f"the lens kernels take bf16 or f32 x and embed of "
                         f"one dtype, got {x.dtype} and {embed.dtype}")
    if not (x.is_contiguous() and embed.is_contiguous()):
        raise ValueError("the lens kernels take contiguous x and embed")
    n, d = x.shape
    v = embed.shape[0]
    vec = 16 // x.element_size()
    if d % vec or x.data_ptr() % 16 or embed.data_ptr() % 16:
        raise ValueError(f"the lens kernels read 16-byte rows: D={d} must "
                         f"be a multiple of {vec} and both inputs 16-byte "
                         "aligned")
    if n == 0:
        raise ValueError("the lens kernels take N >= 1 rows")
    if plan.route == "wgmma":
        if x.dtype != torch.bfloat16 or top_k > KMAX:
            raise ValueError(f"the wgmma route takes bf16 and top_k <= {KMAX}, "
                             f"got {x.dtype} and {top_k}")
        expected = (_cdiv(n, WGMMA_ROWS), _cdiv(v, WGMMA_COLS),
                    _wgmma_bounds(v, plan.chunks))
    elif plan.route == "simple":
        expected = (_cdiv(n, 64), v // BLOCK_V, tuple(range(0, v + 1, BLOCK_V)))
        if v // BLOCK_V > 65535:
            raise ValueError(f"the simple route takes V <= {65535 * BLOCK_V}")
    else:
        raise ValueError(f"unknown route {plan.route!r}")
    if (plan.row_tiles, plan.vocab_tiles, plan.bounds) != expected:
        raise ValueError(f"plan {plan[:4]} does not cut N={n}, V={v}")

    lib = _library(plan.route)
    s = plan.chunks
    f32 = dict(dtype=torch.float32, device=x.device)
    parts = LensPartials(
        chunk_max=torch.empty((s, n), **f32),
        chunk_sumexp=torch.empty((s, n), **f32),
        chunk_tgt=torch.empty((s, n), **f32),
        cand_vals=torch.empty((s, n, top_k), **f32),
        cand_ids=torch.empty((s, n, top_k), dtype=torch.int32, device=x.device))
    ptrs = [t.data_ptr() for t in (x, embed, targets, *parts)]
    has_cap, cap = int(logit_cap is not None), float(logit_cap or 0.0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route == "wgmma":
            rc = lib.tbx_lens_wgmma(*ptrs, n, d, v, top_k, s, has_cap, cap,
                                    stream)
            why = lib.tbx_wgmma_error_string
        else:
            rc = lib.tbx_lens_stats(*ptrs, n, d, v, top_k, has_cap, cap,
                                    int(x.dtype == torch.bfloat16), stream)
            why = lib.tbx_cuda_error_string
    if rc != 0:
        raise RuntimeError(f"lens_stats {plan.route} kernel launch failed "
                           f"({rc}): {why(rc).decode()}")
    lens_stats.launches += 1
    lens_stats.route_launches[plan.route] += 1
    return parts


def lens_stats_partials(
    x: torch.Tensor,            # [N, D]
    embed: torch.Tensor,        # [V, D]
    target_id: TargetLike,      # [] or [N] int; -1 = no target
    *,
    top_k: int = 5,
    logit_cap: Optional[float] = None,
) -> LensPartials:
    """The per-chunk partials of :func:`lens_plan` for these inputs (on CUDA,
    for this card): one kernel launch for CUDA tensors,
    :func:`lens_stats_partials_reference` for CPU tensors."""
    _check_shapes(x, embed, top_k)
    n, v = x.shape[0], embed.shape[0]
    targets = _targets(target_id, n, x.device)
    if x.device.type == "cpu" and embed.device.type == "cpu":
        return lens_stats_partials_reference(
            x, embed, targets, lens_plan(n, v, top_k, x.dtype), top_k=top_k,
            logit_cap=logit_cap)
    if x.device.type != "cuda":
        raise ValueError(f"lens_stats runs on CUDA or CPU tensors, got "
                         f"{x.device} and {embed.device}")
    plan = lens_plan(n, v, top_k, x.dtype, sm_count=_sm_count(x.device))
    return _launch(x, embed, targets, plan, top_k, logit_cap)


def lens_stats(
    x: torch.Tensor,            # [N, D] final-normed rows
    embed: torch.Tensor,        # [V, D] tied embedding / unembedding
    target_id: TargetLike,      # [] or [N] int; -1 = no target
    *,
    top_k: int = 5,
    logit_cap: Optional[float] = None,
) -> LensStats:
    """Fused lens statistics for a flat batch of rows.

    Rows are independent, so callers fold [B, T] into N = B*T.  V must be a
    multiple of :data:`BLOCK_V` (256000 = 2000 x 128).  ``target_id`` is one
    id for every row or one per row; ``-1`` gives :data:`NEG_INF`.
    ``logit_cap=None`` is the reference lens (bare logits).

    CUDA tensors run a kernel (:func:`lens_plan` picks which) and
    :func:`merge_partials`; CPU tensors run :func:`lens_stats_reference`.
    """
    _check_shapes(x, embed, top_k)
    if x.device.type == "cpu" and embed.device.type == "cpu":
        return lens_stats_reference(x, embed, target_id, top_k=top_k,
                                    logit_cap=logit_cap)
    return merge_partials(lens_stats_partials(x, embed, target_id, top_k=top_k,
                                              logit_cap=logit_cap))


#: Kernel launches since the count was last set to 0, in all and by route.
lens_stats.launches = 0
lens_stats.route_launches = {"wgmma": 0, "simple": 0}
