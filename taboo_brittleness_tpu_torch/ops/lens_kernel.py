"""Fused logit-lens readout: the CUDA kernels' wrapper and their plain version.

The counterpart of the JAX package's ``ops/pallas_lens.py``.  Per layer the
lens reads ``softmax(norm(h) @ E^T)`` over the whole vocabulary and keeps only
a few statistics of it: the logsumexp, the target token's logit and the top-k
logits with their ids.  A kernel streams the embedding and writes one set of
partials per chunk of the vocabulary; :func:`merge_partials`, a small torch
epilogue, merges them, so the ``[N, V]`` logits never reach device memory.

Two kernels, two routes, chosen by :func:`lens_plan` before the launch
from the call's rows, vocabulary, dtype and the card's SM count:

- ``"splitv"`` (``csrc/lens_stats_splitv.cu``): bf16, f16 or f32 inputs
  and at most :data:`SPLITV_MAX_ROWS` rows (f32:
  :data:`SPLITV_F32_MAX_ROWS`): the serving readouts (N 8 per step, N 32
  per speculative verify, each tp shard's).  E's rows are the wgmma's M
  and the few rows of x its N; one block per SM streams a balanced range
  of 32-row vocab tiles once (TMA ring), and each consumer warp folds its
  tokens' logits across the lanes.  One partial per (chunk, row).
- ``"wgmma"`` (``csrc/lens_stats_wgmma.cu``): bf16, f16 or f32 inputs with
  more rows, which is every call of the main path.  TMA ring, wgmma, 128 x
  256 tiles and a running per-row state across a vocab chunk: one partial
  per (chunk, row).

The two Hopper kernels each hold two instantiations of their running top-k
list: :data:`KMAX` entries (every call with ``top_k <= KMAX``) and
:data:`KMAX_WIDE` (``KMAX < top_k <= KMAX_WIDE``), and each of those in
bf16, in f16 and in f32 (the three float types the TPU kernel takes).  The
f16 instantiations are the bf16 ones with the f16 form of each wgmma: the
same bytes, tiles and tensor-core rate.  The f32 instantiations take three
TF32 tensor-core products (3xTF32: each operand split into a TF32 hi and
lo, ``hi.hi + lo.hi + hi.lo`` in one f32 accumulator,
``csrc/tf32_split.cuh``), f32's accuracy at six times bf16's tensor-core
time (three products at half the rate); they split x once per call into a
``[2, N, D]`` scratch the launcher allocates.  The launcher passes the
instantiation's length and the input type's code (:data:`DTYPE_BITS`), and
refuses a top-k above the longest list, or a dtype, the library does not
export.

A top-k above :data:`KMAX_WIDE` (up to :data:`TOP_K_MAX`) runs the long
list in ``ceil(K / KMAX_WIDE)`` passes of the same plan, each a launch of
the same kernel, certified exact by :func:`certify_top_k`: the first pass
is the ``KMAX_WIDE`` call, and each later one (a refill) lists, per (chunk,
row), the keys below a ceiling, the last key that pair's list held, where
the list may have left some of the top-k out.  A refill runs on a fixed
grid of one block per SM whatever pairs are open: the kernel deals the open
units' tiles out evenly (:func:`refill_work`, :func:`refill_spans`,
``csrc/refill_work.cuh``) and merges the pieces of a unit.  No pass waits
on the host, so the call can be captured in a CUDA graph.  The split-V
kernel's last block certifies in the launch itself up to
:data:`MERGE_MAX`; above it, and on the wgmma route, the certificate is a
torch epilogue.

- :func:`lens_stats` dispatches on the device of its inputs: CUDA tensors go
  to a kernel (or raise when no kernel can take them), CPU tensors go to
  :func:`lens_stats_reference`.  There is no fallback from one to the other.
  ``lens_stats.launches`` counts kernel launches and
  ``lens_stats.route_launches`` splits them by route, a refill apart from
  the first pass (``"<route>_refill"``).
- :func:`lens_stats_reference` is the plain version: the full f32 logits,
  ``logsumexp`` and a top-k.  It is the CPU path and the kernels' oracle;
  :func:`lens_stats_partials_reference` is the plain version of the
  partials a plan's chunks produce.

All prefer the lower vocab id among equal values, as ``lax.top_k`` does
(:func:`topk_lowest_id`).

The kernels are built from the checkout at first use: ``nvcc`` compiles each
source for ``sm_90a`` into ``csrc/build/`` (listed in ``.gitignore``), one
compiler per unit (:data:`UNITS`: each source's bf16, f32 and f16
instantiations apart, split-V's also by the cap), all started together,
one link per library, and the shared libraries are loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

#: Logit of a target that is absent (``-1``) or outside the vocabulary.
NEG_INF = -1e30

#: The vocabulary must be a multiple of it, as of the JAX kernel's
#: ``block_v`` (the Hopper kernels take a ragged last tile; the check keeps
#: the two packages' contract, and the serving stack pads to it).
BLOCK_V = 128

#: The largest top-k a call takes: the JAX Pallas kernel's default
#: ``block_v``, the most that kernel takes by default.
TOP_K_MAX = 1024

#: The wgmma kernel's block tile (rows x vocab columns).
WGMMA_ROWS, WGMMA_COLS = 128, 256

#: The lengths of the Hopper kernels' running top-k lists: calls with
#: ``top_k <= KMAX`` take the short list, longer ones the long one (above
#: ``KMAX_WIDE`` in several passes, :func:`certify_top_k`).
KMAX, KMAX_WIDE = 8, 32

#: The largest top-k the split-V kernel's last block certifies in the
#: launch (four ranks a lane); above it the torch epilogue does.
MERGE_MAX = 128

#: The split-V kernel's plan tile: vocab rows per step of a chunk (one TMA
#: box of E).
SPLITV_TILE = 32

#: The most rows the split-V route takes; more go to the wgmma kernel.  The
#: two routes timed on the card do not cross within the kernel's own limit
#: (the split-V call is the faster at every N from 1 to 64, ``PERF.md``), so
#: the route takes every N the kernel's shared memory holds.
SPLITV_MAX_ROWS = 64

#: The most f32 rows the split-V route takes; more go to the wgmma kernel's
#: f32 instantiation.  Set from the f32 routes timed in turns on the card
#: (``chip_smoke.py`` phase 3b, ``PERF.md``): the split-V call is the faster
#: up to N 48 (1.50 ms against 2.09 on an H100) and not at N 64 (2.51
#: against 2.10), where the f32 stages leave its ring three stages.
SPLITV_F32_MAX_ROWS = 48

#: The input types the Hopper kernels instantiate, as their libraries export
#: them (bit 0 bf16, bit 1 f32, bit 2 f16); a type's bit is also the dtype
#: code the launcher passes.
DTYPE_BITS = {torch.bfloat16: 1, torch.float32: 2, torch.float16: 4}

#: Streaming multiprocessors of an H100 SXM, the default of :func:`lens_plan`;
#: a launch plans with its card's own count.
H100_SMS = 132

#: Fewest vocab tiles in a wgmma chunk, so that a block's fixed cost (filling
#: the ring, merging its lanes' lists, writing its partials) stays small next
#: to its products.
MIN_CHUNK_TILES = 8

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = {
    "splitv": os.path.join(_CSRC, "lens_stats_splitv.cu"),
    "wgmma": os.path.join(_CSRC, "lens_stats_wgmma.cu"),
}
#: Each library's compiler units, as the defines of each: a source's bf16,
#: f32 and f16 instantiations (wgmma 4 each) compile apart, in parallel,
#: and link into one library; split-V's 96 also apart with the cap and
#: without (16 a unit).
UNITS = {"splitv": tuple((f"LENS_SPLITV_UNIT={i}",) for i in range(1, 7)),
         "wgmma": tuple((f"LENS_WGMMA_UNIT={i}",) for i in range(1, 4))}
#: Headers the sources include; a change to one rebuilds every library.
HEADERS = (os.path.join(_CSRC, "tf32_split.cuh"),
           os.path.join(_CSRC, "refill_work.cuh"))
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: A unit's flags (an object, not a library) and the link's.
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)
LINK_FLAGS = NVCC_FLAGS[:2] + ("-shared",)

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
    route: str                  # "splitv", "wgmma" or "plain"
    row_tiles: int              # blocks along the rows
    vocab_tiles: int            # kernel tiles along the vocabulary
    chunks: int                 # S: partials per row
    bounds: Tuple[int, ...]     # S + 1 offsets; chunk s is [bounds[s], bounds[s+1])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_bounds(v: int, cols: int, chunks: int) -> Tuple[int, ...]:
    """Chunk s covers the vocab tiles [s*T // S, (s+1)*T // S) of T =
    ceil(v / cols), as the kernels compute them."""
    tiles = _cdiv(v, cols)
    return tuple(min(v, (s * tiles // chunks) * cols) for s in range(chunks + 1))


def _splitv_plan(n: int, v: int, sm_count: int) -> LensPlan:
    """One row tile, ``ceil(V / 32)`` vocab tiles, and one chunk per SM
    (fewer when there are fewer tiles): a single wave of blocks, each
    within one tile of the others."""
    tiles = _cdiv(v, SPLITV_TILE)
    chunks = min(tiles, sm_count)
    return LensPlan("splitv", 1, tiles, chunks,
                    _tile_bounds(v, SPLITV_TILE, chunks))


def _wgmma_plan(n: int, v: int, sm_count: int) -> LensPlan:
    """``ceil(N / 128)`` row tiles, ``ceil(V / 256)`` vocab tiles, and S
    chunks of whole vocab tiles, at least :data:`MIN_CHUNK_TILES` of them
    where there are that many.  S is the smallest count that minimises
    (waves of blocks over the card's SMs) x (vocab tiles in the longest
    chunk), so the blocks fill whole waves evenly."""
    rows = _cdiv(n, WGMMA_ROWS)
    tiles = _cdiv(v, WGMMA_COLS)
    chunks = min(range(1, _cdiv(tiles, MIN_CHUNK_TILES) + 1),
                 key=lambda s: (_cdiv(rows * s, sm_count) * _cdiv(tiles, s), s))
    return LensPlan("wgmma", rows, tiles, chunks,
                    _tile_bounds(v, WGMMA_COLS, chunks))


def lens_plan(n: int, v: int, k: int, dtype: torch.dtype, *,
              sm_count: int = H100_SMS) -> LensPlan:
    """The route and geometry of a lens-stats call over N rows, V vocab
    columns and top-``k`` on a card of ``sm_count`` SMs.

    The split-V kernel up to :data:`SPLITV_MAX_ROWS` rows in bf16 and f16
    (the same bytes; :data:`SPLITV_F32_MAX_ROWS` in f32;
    :func:`_splitv_plan`), the wgmma
    kernel above (:func:`_wgmma_plan`), whatever ``k``: a top-k above
    :data:`KMAX_WIDE` runs the same plan in passes (:func:`certify_top_k`).
    """
    del k
    limit = SPLITV_F32_MAX_ROWS if dtype == torch.float32 else SPLITV_MAX_ROWS
    if n <= limit:
        return _splitv_plan(n, v, sm_count)
    return _wgmma_plan(n, v, sm_count)


def whole_plan(v: int) -> LensPlan:
    """One chunk over the whole vocabulary of ``v`` ids: the plan of a
    plain call (:func:`lens_stats_partials_reference`) that no kernel
    runs."""
    return LensPlan("plain", 1, 1, 1, (0, v))


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
# A top-k above the kernels' lists: certified passes.
# ---------------------------------------------------------------------------

def _keys(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One int64 key per (value, id) whose order is the top-k order (value
    descending, then id ascending) as the kernels compare: -0 as +0.  The
    kernels decode and build the same keys (``key_parts``, ``make_key``)."""
    values = torch.where(values == 0, torch.zeros_like(values), values)
    return (_ordered_bits(values) << 32) | (0xFFFFFFFF - ids.long())


def _unkey(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 values, int32 ids) of :func:`_keys`' keys."""
    hi = keys >> 32
    bits = torch.where(hi >= 0, hi, hi ^ 0x7FFFFFFF).to(torch.int32)
    return bits.view(torch.float32), (0xFFFFFFFF - (keys & 0xFFFFFFFF)).to(
        torch.int32)


#: The key of an empty list entry (-inf, id 2**31 - 1), below every
#: column's: the ceiling of a (chunk, row) pair with nothing left to list.
EMPTY_KEY = int(_keys(torch.tensor([float("-inf")]),
                      torch.tensor([2**31 - 1]))[0])


def _top_keys(keys: torch.Tensor, k: int,
              best: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``k`` largest of ``best`` [N, k] and the lists' keys [S, N, L],
    per row, descending; :data:`EMPTY_KEY` where there are fewer."""
    n = keys.shape[1]
    flat = keys.permute(1, 0, 2).reshape(n, -1)
    pieces = [flat] if best is None else [best, flat]
    if sum(p.shape[1] for p in pieces) < k:
        pieces.append(torch.full((n, k), EMPTY_KEY, dtype=torch.int64,
                                 device=keys.device))
    return torch.topk(torch.cat(pieces, dim=1), k, dim=1).values


PassFn = Callable[[Optional[torch.Tensor]], LensPartials]


def certify_top_k(pass_fn: PassFn, top_k: int) -> LensPartials:
    """The exact top-``top_k`` of a call whose lists hold fewer entries.

    ``pass_fn(ceiling)`` runs one pass of the call's plan and returns its
    partials, each (chunk s, row r) listing its L largest keys (value
    descending, then id ascending; :func:`_keys`) strictly below
    ``ceiling[s, r]`` ([S, N] int64), or below nothing for ``None``, padded
    with the empty key; a pair whose ceiling is the empty key has nothing
    below it, and its list is not read (the kernels do not write it).
    After pass 1, ``t[r]`` is the ``top_k``-th key of the union of every
    list so far.  A pair whose list's last key lies at
    or below ``t[r]`` is complete: every key it did not list lies below
    that last key, so outside the union's top-``top_k``.  Every other pair
    gets its list's last key as its ceiling for the next pass, and a
    complete one the empty key (its list comes back empty).  After p passes
    a pair still open holds p L keys above ``t[r]``, of which there are
    fewer than ``top_k``: so ``ceil(top_k / L)`` passes make every pair
    complete, and exactly that many run, with nothing read on the host.
    Statistics come from pass 1.  Returns the call as one chunk: its max,
    sum-exp and target over the vocabulary and its top-``top_k``.
    """
    parts = pass_fn(None)
    length = parts.cand_vals.shape[-1]
    keys = _keys(parts.cand_vals, parts.cand_ids)
    best = _top_keys(keys, top_k)
    for _ in range(1, _cdiv(top_k, length)):
        last = keys[..., -1]
        ceiling = torch.where(last > best[:, -1], last, EMPTY_KEY)
        refill = pass_fn(ceiling)
        keys = torch.where(ceiling[..., None] != EMPTY_KEY,
                           _keys(refill.cand_vals, refill.cand_ids), EMPTY_KEY)
        best = _top_keys(keys, top_k, best)
    vals, ids = _unkey(best)
    gmax = parts.chunk_max.max(dim=0).values
    sumexp = (parts.chunk_sumexp * torch.exp(parts.chunk_max - gmax)).sum(dim=0)
    return LensPartials(gmax[None], sumexp[None],
                        parts.chunk_tgt.max(dim=0).values[None], vals[None],
                        ids[None])


# ---------------------------------------------------------------------------
# A refill's work, dealt over a fixed grid (csrc/refill_work.cuh).
# ---------------------------------------------------------------------------

class RefillWork(NamedTuple):
    """The work list of a refill pass, as the kernels' plan kernel writes
    it: the open units in order, where each one's items start in the list
    of all their items (``starts[-1]`` is their count, W), and every
    unit's items."""
    units: Tuple[int, ...]
    starts: Tuple[int, ...]
    items: Tuple[int, ...]


def _refill_geometry(plan: LensPlan, n: int) -> Tuple[int, int, int]:
    """(row tiles, rows of a row tile, columns of a plan tile) of a refill's
    units, whose items are their plan tiles: a (chunk, row tile) and its
    256-column tiles on the wgmma route, a chunk and its 32-row tiles of E
    on split-V."""
    if plan.route == "wgmma":
        return plan.row_tiles, WGMMA_ROWS, WGMMA_COLS
    if plan.route == "splitv":
        return 1, n, SPLITV_TILE
    raise ValueError(f"a refill spreads a kernel's plan, not {plan.route!r}")


def refill_work(ceiling: torch.Tensor, plan: LensPlan) -> RefillWork:
    """The work list of a refill pass with these [S, N] ceilings: a unit is
    open when one of its pairs' ceilings is not the empty key."""
    s, n = ceiling.shape
    rows, tile_rows, cols = _refill_geometry(plan, n)
    open_ = torch.nn.functional.pad(ceiling != EMPTY_KEY,
                                    (0, rows * tile_rows - n))
    open_ = open_.view(s, rows, tile_rows).any(dim=-1).flatten().tolist()
    tiles = [_cdiv(hi - lo, cols)
             for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:])]
    items = tuple(tiles[u // rows] for u in range(s * rows))
    units = tuple(u for u, o in enumerate(open_) if o)
    starts = tuple(np.cumsum([0] + [items[u] for u in units]).tolist())
    return RefillWork(units, starts, items)


def refill_block_of(item: int, total: int, grid: int) -> int:
    """The block of ``grid`` whose items hold ``item`` of ``total``."""
    return ((item + 1) * grid - 1) // total


def refill_spans(work: RefillWork, block: int, grid: int
                 ) -> Tuple[Tuple[int, int, int, int], ...]:
    """Block ``block``'s spans of a refill on ``grid`` blocks, in order:
    (m, unit, first, upto), items [first, upto) of the m-th open unit.  The
    block takes items [b W / G, (b + 1) W / G) of all W."""
    total = work.starts[-1]
    item, end = block * total // grid, (block + 1) * total // grid
    spans = []
    m = int(np.searchsorted(work.starts, item, side="right")) - 1
    while item < end:
        s0, s1 = work.starts[m], work.starts[m + 1]
        upto = min(end, s1) - s0
        spans.append((m, work.units[m], item - s0, upto))
        item, m = s0 + upto, m + 1
    return tuple(spans)


def _spread_refill(keys: torch.Tensor, plan: LensPlan, ceiling: torch.Tensor,
                   top_k: int, grid: int) -> torch.Tensor:
    """A refill's lists ([S, N, top_k] keys) from the call's keys [N, V] as
    the kernels deal it over ``grid`` blocks: a span that is a whole unit
    lists its pairs; a piece of a unit lists into slot m + b, and the
    unit's pieces are merged; the closed units list nothing."""
    s, n = ceiling.shape
    rows, tile_rows, cols = _refill_geometry(plan, n)
    work = refill_work(ceiling, plan)
    out = torch.full((s, n, top_k), EMPTY_KEY, dtype=torch.int64,
                     device=keys.device)
    pieces: Dict[int, torch.Tensor] = {}

    def listed(c, r0, r1, lo, hi):
        block = keys[r0:r1, lo:hi]
        block = torch.where(block < ceiling[c, r0:r1, None], block, EMPTY_KEY)
        pad = torch.full((r1 - r0, top_k), EMPTY_KEY, dtype=torch.int64,
                         device=keys.device)
        return torch.topk(torch.cat([block, pad], dim=1), top_k, dim=1).values

    for b in range(grid):
        for m, u, first, upto in refill_spans(work, b, grid):
            c, r0 = u // rows, (u % rows) * tile_rows
            r1 = min(n, r0 + tile_rows)
            lo = plan.bounds[c] + first * cols
            hi = min(plan.bounds[c + 1], plan.bounds[c] + upto * cols)
            if first == 0 and upto == work.items[u]:
                out[c, r0:r1] = listed(c, r0, r1, lo, hi)
            else:
                if m + b in pieces:
                    raise AssertionError(f"refill slot {m + b} written twice")
                pieces[m + b] = listed(c, r0, r1, lo, hi)
    total = work.starts[-1]
    for m, u in enumerate(work.units):
        b0 = refill_block_of(work.starts[m], total, grid)
        b1 = refill_block_of(work.starts[m + 1] - 1, total, grid)
        if b0 == b1:
            continue
        c, r0 = u // rows, (u % rows) * tile_rows
        r1 = min(n, r0 + tile_rows)
        # A block that took no item (fewer items than blocks) wrote none.
        merged = torch.cat([pieces.pop(m + b) for b in range(b0, b1 + 1)
                            if b * total // grid < (b + 1) * total // grid],
                           dim=1)
        out[c, r0:r1] = torch.topk(merged, top_k, dim=1).values
    if pieces:
        raise AssertionError(f"refill slots {sorted(pieces)} never merged")
    return out


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
    """Shapes a call takes; ``tiled`` also asks for a vocabulary of whole
    :data:`BLOCK_V` tiles."""
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
    if not 1 <= top_k <= min(TOP_K_MAX, v):
        raise ValueError(f"top_k must be in [1, {min(TOP_K_MAX, v)}] (vocab "
                         f"{v}), got {top_k}")


def plain_logits(x: torch.Tensor, embed: torch.Tensor,
                 logit_cap: Optional[float] = None, *,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f32 ``x @ E^T`` with the product in ``dtype`` (f32 by default: upcast
    before the product, as the kernels accumulate in f32), capped when
    ``logit_cap`` is set."""
    # tbx: f32-ok — the plain version forms the [N, V] logits by definition
    # (the kernels' oracle and CPU path; on the card the kernel never does)
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
    ceiling: Optional[torch.Tensor] = None,   # [S, N] int64 keys
    grid: Optional[int] = None,
) -> LensPartials:
    """The plain version of the partials a kernel writes for ``plan``: the
    same statistics as :func:`lens_stats_reference`, per chunk of the
    vocabulary.  The plan's chunks need not be whole kernel tiles
    (:func:`whole_plan` is one chunk over any vocabulary).  Each list holds
    its chunk's ``top_k`` largest keys (:func:`_keys`; below ``ceiling[s,
    r]`` when given, a refill pass of :func:`certify_top_k`), padded with
    the empty key (-inf, id 2**31 - 1) where the chunk has fewer.  A refill
    with a ``grid`` lists as the kernels deal it over that many blocks
    (:func:`refill_spans`: whole units and merged pieces); its statistics
    are the first pass's (no caller reads them)."""
    _check_shapes(x, embed, top_k, tiled=False)
    if plan.bounds[-1] != embed.shape[0]:
        raise ValueError(f"plan cut for vocab {plan.bounds[-1]}, embed has "
                         f"{embed.shape[0]} rows")
    logits = plain_logits(x, embed, logit_cap)
    n = x.shape[0]
    targets = _targets(target_id, n, x.device).long()
    tgt = torch.gather(logits, 1, targets.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    empty = torch.full((n, top_k), EMPTY_KEY, dtype=torch.int64, device=x.device)
    spread = None
    if ceiling is not None and grid is not None:
        ids = torch.arange(logits.shape[1], device=x.device).expand(n, -1)
        spread = _spread_refill(_keys(logits, ids), plan, ceiling, top_k, grid)
    parts = []
    for s, (lo, hi) in enumerate(zip(plan.bounds[:-1], plan.bounds[1:])):
        block = logits[:, lo:hi]
        m = block.max(dim=1).values
        inside = (targets >= lo) & (targets < hi)
        if spread is not None:
            keys = spread[s]
        else:
            keys = _keys(block,
                         torch.arange(lo, hi, device=x.device).expand(n, -1))
            if ceiling is not None:
                keys = torch.where(keys < ceiling[s, :, None], keys, EMPTY_KEY)
            keys = torch.topk(torch.cat([keys, empty], dim=1), top_k,
                              dim=1).values
        parts.append((m, torch.exp(block - m[:, None]).sum(dim=1),
                      torch.where(inside, tgt, torch.full_like(tgt, NEG_INF)),
                      *_unkey(keys)))
    return LensPartials(*(torch.stack(p) for p in zip(*parts)))


def merge_partials(parts: LensPartials) -> LensStats:
    """The epilogue of every route: global logsumexp from the chunks' (max,
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
    """Build each route's library unless a build of the same source and
    flags exists: one ``nvcc -c`` per unit (:data:`UNITS`), every unit of
    every library started together, then one link per library.  Returns
    {route: (path of the shared library, compiler output)}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    built, running = {}, {}
    headers = b"".join(open(h, "rb").read() for h in HEADERS)
    for route, source in SOURCES.items():
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read() + headers + repr(
                (NVCC_FLAGS, UNITS[route])).encode())
        stem = os.path.splitext(os.path.basename(source))[0]
        out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
        if os.path.exists(out):
            built[route] = (out, "")
            continue
        units = []
        for i, defines in enumerate(UNITS[route]):
            obj = f"{out}.{i}.{os.getpid()}.o"
            proc = subprocess.Popen(
                [_nvcc(), *COMPILE_FLAGS, *(f"-D{d}" for d in defines), "-o",
                 obj, source], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            units.append((proc, obj))
        running[route] = (units, source, out)
    failed = []
    for route, (units, source, out) in running.items():
        logs = []
        for proc, _ in units:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source}:\n{log}")
        if failed:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        link = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", tmp,
                               *(obj for _, obj in units)],
                              capture_output=True, text=True)
        for _, obj in units:
            os.remove(obj)
        if link.returncode != 0:
            failed.append(f"nvcc failed to link {out}:\n{link.stdout}"
                          f"{link.stderr}")
            continue
        os.replace(tmp, out)
        built[route] = (out, "".join(logs))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def bind_library(route: str, path: str) -> ctypes.CDLL:
    """Load a built library of ``route`` and declare its C interface.  Its
    ``list_lengths`` are the top-k list lengths it instantiates, shortest
    first, its ``dtypes`` the input types (of bf16, f32 and f16) and
    (split-V) its ``merge_max``
    the largest top-k its last block certifies, as the library exports
    them."""
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    i = ctypes.c_int
    if route == "splitv":
        for name in ("tbx_splitv_tile_rows", "tbx_splitv_kmax",
                     "tbx_splitv_kmax_wide", "tbx_splitv_max_rows",
                     "tbx_splitv_dtypes", "tbx_splitv_merge_max"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        for name in ("tbx_splitv_smem_bytes", "tbx_splitv_f32_smem_bytes"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = i
        lib.tbx_splitv_error_string.argtypes = [i]
        lib.tbx_splitv_error_string.restype = ctypes.c_char_p
        lib.tbx_lens_splitv.argtypes = ([p] * 14 + [i] * 8 + [ctypes.c_float, p]
                                        + [p, p, i] + [p] * 4 + [i])
        lib.tbx_lens_splitv.restype = i
        tile, rows = lib.tbx_splitv_tile_rows(), lib.tbx_splitv_max_rows()
        if tile != SPLITV_TILE or rows < SPLITV_MAX_ROWS:
            raise RuntimeError(f"{path} has tile {tile} and holds {rows} rows, "
                               f"expected {SPLITV_TILE} and {SPLITV_MAX_ROWS}")
        lib.list_lengths = (lib.tbx_splitv_kmax(), lib.tbx_splitv_kmax_wide())
        lib.dtypes = _dtypes(lib.tbx_splitv_dtypes())
        lib.merge_max = lib.tbx_splitv_merge_max()
        return lib
    if route != "wgmma":
        raise ValueError(f"unknown route {route!r}")
    for name in ("tbx_wgmma_block_rows", "tbx_wgmma_block_cols",
                 "tbx_wgmma_kmax", "tbx_wgmma_kmax_wide",
                 "tbx_wgmma_smem_bytes", "tbx_wgmma_f32_smem_bytes",
                 "tbx_wgmma_dtypes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.tbx_wgmma_error_string.argtypes = [i]
    lib.tbx_wgmma_error_string.restype = ctypes.c_char_p
    lib.tbx_lens_wgmma.argtypes = ([p] * 9 + [i] * 8 + [ctypes.c_float, p, p]
                                   + [p] * 4 + [i])
    lib.tbx_lens_wgmma.restype = i
    geometry = (lib.tbx_wgmma_block_rows(), lib.tbx_wgmma_block_cols())
    if geometry != (WGMMA_ROWS, WGMMA_COLS):
        raise RuntimeError(f"{path} has tiles {geometry}, expected "
                           f"{(WGMMA_ROWS, WGMMA_COLS)}")
    lib.list_lengths = (lib.tbx_wgmma_kmax(), lib.tbx_wgmma_kmax_wide())
    lib.dtypes = _dtypes(lib.tbx_wgmma_dtypes())
    return lib


def _dtypes(bits: int) -> Tuple[torch.dtype, ...]:
    """The input types of a library's exported bit mask (:data:`DTYPE_BITS`)."""
    return tuple(t for t, bit in DTYPE_BITS.items() if bits & bit)


def list_length(lib, route: str, top_k: int) -> int:
    """The shortest top-k list ``lib`` instantiates that holds ``top_k``;
    raises when none does."""
    for length in lib.list_lengths:
        if top_k <= length:
            return length
    raise ValueError(f"the {route} library keeps top-k lists of "
                     f"{lib.list_lengths} entries, not {top_k}")


@functools.lru_cache(maxsize=None)
def _library(route: str) -> ctypes.CDLL:
    return bind_library(route, build_library()[route][0])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _Certify(NamedTuple):
    """Where a pass of the split-V kernel's certified merge (top-k
    ``KMAX_WIDE + 1`` to :data:`MERGE_MAX`) writes: the call's statistics
    (its top-k carried from pass to pass), the ceilings its last block sets
    for the next pass ([S, N] int64), the next pass's work list
    ([3 + 3 S] int32, ``csrc/refill_work.cuh``; a refill reads the one the
    pass before wrote) and the pass's ticket (one int, 0)."""
    stats: LensStats
    next_ceiling: torch.Tensor
    work: torch.Tensor
    ticket: torch.Tensor


def _launch(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
            plan: LensPlan, top_k: int, logit_cap: Optional[float], *,
            merged: bool = False, ceiling: Optional[torch.Tensor] = None,
            certify: Optional[_Certify] = None
            ) -> Union[LensPartials, LensStats]:
    """One kernel launch of ``plan``'s route; returns its partials, or with
    ``merged`` (the split-V route only) the :class:`LensStats` its last block
    merges them into.  ``ceiling`` ([S, N] int64 keys, the long list only)
    makes it a refill pass of :func:`certify_top_k`; ``certify`` (split-V,
    merged) a pass of the kernel's own certified merge."""
    if embed.device != x.device or targets.device != x.device:
        raise ValueError(f"x is on {x.device} but embed on {embed.device} and "
                         f"targets on {targets.device}")
    if x.dtype not in DTYPE_BITS or embed.dtype != x.dtype:
        raise ValueError(f"the lens kernels take bf16, f16 or f32 x and embed "
                         f"of one dtype, got {x.dtype} and {embed.dtype}")
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
    if top_k > KMAX_WIDE:
        raise ValueError(f"one launch lists top_k <= {KMAX_WIDE}, got {top_k} "
                         "(longer top-k: certify_top_k)")
    if plan.route == "splitv":
        if n > SPLITV_MAX_ROWS:
            raise ValueError(f"the splitv route takes N <= {SPLITV_MAX_ROWS}, "
                             f"got {n}")
        tiles = _cdiv(v, SPLITV_TILE)
        if not 1 <= plan.chunks <= tiles:
            raise ValueError(f"plan {plan[:4]} does not cut V={v}")
        expected = (1, tiles, _tile_bounds(v, SPLITV_TILE, plan.chunks))
    elif plan.route == "wgmma":
        expected = (_cdiv(n, WGMMA_ROWS), _cdiv(v, WGMMA_COLS),
                    _tile_bounds(v, WGMMA_COLS, plan.chunks))
    else:
        raise ValueError(f"unknown route {plan.route!r}")
    if merged and plan.route != "splitv":
        raise ValueError(f"the {plan.route} kernel writes partials only")
    if (plan.row_tiles, plan.vocab_tiles, plan.bounds) != expected:
        raise ValueError(f"plan {plan[:4]} does not cut N={n}, V={v}")
    s = plan.chunks
    for keys in (ceiling, None if certify is None else certify.next_ceiling):
        if keys is not None and (
                keys.dtype != torch.int64 or tuple(keys.shape) != (s, n)
                or keys.device != x.device or not keys.is_contiguous()):
            raise ValueError(f"ceilings are contiguous [{s}, {n}] int64 keys "
                             f"on {x.device}")
    if (ceiling is not None or certify is not None) and top_k != KMAX_WIDE:
        raise ValueError(f"a pass of a longer top-k lists {KMAX_WIDE}, got "
                         f"{top_k}")
    if certify is not None and not merged:
        raise ValueError("the certified merge is the split-V kernel's merge")
    if certify is not None and (
            certify.work.dtype != torch.int32
            or tuple(certify.work.shape) != (3 + 3 * s,)
            or certify.work.device != x.device):
        raise ValueError(f"a certified pass's work list is [{3 + 3 * s}] "
                         f"int32 on {x.device}")

    lib = _library(plan.route)
    length = list_length(lib, plan.route, top_k)
    if x.dtype not in lib.dtypes:
        raise ValueError(f"the {plan.route} library instantiates "
                         f"{lib.dtypes}, not {x.dtype}")
    k_merge = top_k
    if certify is not None:
        k_merge = certify.stats.topk_vals.shape[1]
        if not KMAX_WIDE < k_merge <= lib.merge_max:
            raise ValueError(f"the split-V kernel certifies top_k "
                             f"{KMAX_WIDE + 1}-{lib.merge_max}, not {k_merge}")
    f32 = dict(dtype=torch.float32, device=x.device)
    parts = LensPartials(
        chunk_max=torch.empty((s, n), **f32),
        chunk_sumexp=torch.empty((s, n), **f32),
        chunk_tgt=torch.empty((s, n), **f32),
        cand_vals=torch.empty((s, n, top_k), **f32),
        cand_ids=torch.empty((s, n, top_k), dtype=torch.int32, device=x.device))
    ptrs = [t.data_ptr() for t in (x, embed, targets, *parts)]
    has_cap, cap = int(logit_cap is not None), float(logit_cap or 0.0)
    code = DTYPE_BITS[x.dtype]
    # The f32 instantiations split x into hi and lo here; the tensor lives
    # until the launch is enqueued on this stream.
    split_buf = (torch.empty((2, n, d), **f32) if x.dtype == torch.float32
                 else None)
    split = None if split_buf is None else split_buf.data_ptr()
    ceiling_ptr = None if ceiling is None else ceiling.data_ptr()
    # A refill's scratch (csrc/refill_work.cuh): the work list (a certified
    # pass's, written by the pass before), the pieces' lists (a slot per
    # open unit and per block of the fixed grid) and the units' tickets;
    # the tensors live until the launch is enqueued.
    refill, grid = [None] * 4, 0
    work = None if certify is None else certify.work
    if ceiling is not None:
        grid = _sm_count(x.device)
        rows, tile_rows, _ = _refill_geometry(plan, n)
        units = s * rows
        if work is None:
            work = torch.empty((3 + 3 * units,), dtype=torch.int32,
                               device=x.device)
        scratch = (work,
                   torch.empty((units + grid, tile_rows, KMAX_WIDE), **f32),
                   torch.empty((units + grid, tile_rows, KMAX_WIDE),
                               dtype=torch.int32, device=x.device),
                   torch.zeros((units,), dtype=torch.int32, device=x.device))
        refill = [t.data_ptr() for t in scratch]
    elif work is not None:
        refill[0] = work.data_ptr()
    stats, ticket, next_ptr = None, None, None
    if certify is not None:
        stats, ticket = certify.stats, certify.ticket
        next_ptr = certify.next_ceiling.data_ptr()
    elif merged:
        stats = LensStats(
            logsumexp=torch.empty((n,), **f32),
            target_logit=torch.empty((n,), **f32),
            topk_vals=torch.empty((n, top_k), **f32),
            topk_ids=torch.empty((n, top_k), dtype=torch.int32, device=x.device))
        ticket = torch.zeros((1,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route == "splitv":
            merge_ptrs = ([t.data_ptr() for t in (*stats, ticket)] if merged
                          else [None] * 5)
            rc = lib.tbx_lens_splitv(*ptrs[:2], split, *ptrs[2:], *merge_ptrs,
                                     n, d, v, top_k, length, s, has_cap,
                                     code, cap, stream, ceiling_ptr,
                                     next_ptr, k_merge, *refill, grid)
            why = lib.tbx_splitv_error_string
        else:
            rc = lib.tbx_lens_wgmma(*ptrs[:2], split, *ptrs[2:], n, d, v,
                                    top_k, length, s, has_cap, code, cap,
                                    stream, ceiling_ptr, *refill, grid)
            why = lib.tbx_wgmma_error_string
    if rc != 0:
        raise RuntimeError(f"lens_stats {plan.route} kernel launch failed "
                           f"({rc}): {why(rc).decode()}")
    lens_stats.launches += 1
    lens_stats.route_launches[plan.route if ceiling is None
                              else f"{plan.route}_refill"] += 1
    return stats if merged else parts


def _kernel_pass(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                 plan: LensPlan, logit_cap: Optional[float]) -> PassFn:
    """One pass of the long list through ``plan``'s kernel, for
    :func:`certify_top_k`."""
    return lambda ceiling: _launch(x, embed, targets, plan, KMAX_WIDE,
                                   logit_cap, ceiling=ceiling)


def _plain_pass(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                plan: LensPlan, logit_cap: Optional[float],
                grid: int = H100_SMS) -> PassFn:
    """The same pass through :func:`lens_stats_partials_reference`, its
    refills dealt over ``grid`` blocks as the kernels deal them."""
    return lambda ceiling: lens_stats_partials_reference(
        x, embed, targets, plan, top_k=KMAX_WIDE, logit_cap=logit_cap,
        ceiling=ceiling, grid=grid)


def _splitv_certified(x: torch.Tensor, embed: torch.Tensor,
                      targets: torch.Tensor, plan: LensPlan, top_k: int,
                      logit_cap: Optional[float]) -> LensStats:
    """A split-V call of top-k ``KMAX_WIDE + 1`` to :data:`MERGE_MAX`:
    :func:`certify_top_k`'s passes with the certificate in each launch's
    last block, which carries the top-k and the ceilings on the card."""
    n, s = x.shape[0], plan.chunks
    f32 = dict(dtype=torch.float32, device=x.device)
    stats = LensStats(
        logsumexp=torch.empty((n,), **f32),
        target_logit=torch.empty((n,), **f32),
        topk_vals=torch.empty((n, top_k), **f32),
        topk_ids=torch.empty((n, top_k), dtype=torch.int32, device=x.device))
    ceiling = torch.empty((s, n), dtype=torch.int64, device=x.device)
    work = torch.empty((3 + 3 * s,), dtype=torch.int32, device=x.device)
    passes = _cdiv(top_k, KMAX_WIDE)
    tickets = torch.zeros((passes,), dtype=torch.int32, device=x.device)
    for p in range(passes):
        _launch(x, embed, targets, plan, KMAX_WIDE, logit_cap, merged=True,
                ceiling=ceiling if p else None,
                certify=_Certify(stats, ceiling, work, tickets[p:p + 1]))
    return stats


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
    :func:`lens_stats_partials_reference` for CPU tensors.  A top-k above
    :data:`KMAX_WIDE` gives the call as one certified chunk
    (:func:`certify_top_k` over the same passes)."""
    _check_shapes(x, embed, top_k)
    n, v = x.shape[0], embed.shape[0]
    targets = _targets(target_id, n, x.device)
    if x.device.type == "cpu" and embed.device.type == "cpu":
        plan = lens_plan(n, v, top_k, x.dtype)
        if top_k > KMAX_WIDE:
            return certify_top_k(
                _plain_pass(x, embed, targets, plan, logit_cap), top_k)
        return lens_stats_partials_reference(
            x, embed, targets, plan, top_k=top_k, logit_cap=logit_cap)
    plan = _device_plan(x, embed, top_k)
    if top_k > KMAX_WIDE:
        return certify_top_k(
            _kernel_pass(x, embed, targets, plan, logit_cap), top_k)
    return _launch(x, embed, targets, plan, top_k, logit_cap)


def _device_plan(x: torch.Tensor, embed: torch.Tensor, top_k: int) -> LensPlan:
    """:func:`lens_plan` for CUDA inputs on their card."""
    if x.device.type != "cuda":
        raise ValueError(f"lens_stats runs on CUDA or CPU tensors, got "
                         f"{x.device} and {embed.device}")
    return lens_plan(x.shape[0], embed.shape[0], top_k, x.dtype,
                     sm_count=_sm_count(x.device))


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
    multiple of :data:`BLOCK_V` (256000 = 2000 x 128), ``top_k`` at most
    :data:`TOP_K_MAX` and V.  ``target_id`` is one id for every row or one
    per row; ``-1`` gives :data:`NEG_INF`.  ``logit_cap=None`` is the
    reference lens (bare logits).

    CUDA tensors run a kernel (:func:`lens_plan` picks which): the split-V
    kernel merges its own chunks in the same launch, the wgmma kernel's
    partials go through :func:`merge_partials`; a top-k above
    :data:`KMAX_WIDE` takes ``ceil(top_k / KMAX_WIDE)`` launches
    (:func:`certify_top_k`; the split-V kernel's last blocks certify up to
    :data:`MERGE_MAX`).  CPU tensors run :func:`lens_stats_reference`.
    """
    _check_shapes(x, embed, top_k)
    if x.device.type == "cpu" and embed.device.type == "cpu":
        return lens_stats_reference(x, embed, target_id, top_k=top_k,
                                    logit_cap=logit_cap)
    targets = _targets(target_id, x.shape[0], x.device)
    plan = _device_plan(x, embed, top_k)
    if top_k > KMAX_WIDE:
        if plan.route == "splitv" and top_k <= MERGE_MAX:
            return _splitv_certified(x, embed, targets, plan, top_k, logit_cap)
        return merge_partials(certify_top_k(
            _kernel_pass(x, embed, targets, plan, logit_cap), top_k))
    if plan.route == "splitv":
        return _launch(x, embed, targets, plan, top_k, logit_cap, merged=True)
    return merge_partials(_launch(x, embed, targets, plan, top_k, logit_cap))


#: Kernel launches since the count was last set to 0, in all and by route
#: (a refill pass of a longer top-k apart from the first).
lens_stats.launches = 0
lens_stats.route_launches = {"splitv": 0, "wgmma": 0, "splitv_refill": 0,
                             "wgmma_refill": 0}
