"""Fused logit-lens readout: the CUDA kernel's wrapper and its plain version.

The counterpart of the JAX package's ``ops/pallas_lens.py``.  Per layer the
lens reads ``softmax(norm(h) @ E^T)`` over the whole vocabulary and keeps only
a few statistics of it: the logsumexp, the target token's logit and the top-k
logits with their ids.  The kernel (``csrc/lens_stats.cu``) streams the
embedding in vocab tiles of :data:`BLOCK_V` columns and writes per-tile
partials; a small torch epilogue here merges them, so the ``[N, V]`` logits
never reach device memory.

- :func:`lens_stats` dispatches on the device of its inputs: CUDA tensors go
  to the kernel (or raise when the kernel cannot take them), CPU tensors go
  to :func:`lens_stats_reference`.  There is no fallback from one to the
  other.  ``lens_stats.launches`` counts kernel launches.
- :func:`lens_stats_reference` is the plain version: the full f32 logits,
  ``logsumexp`` and a top-k.  It is the CPU path and the kernel's oracle.

Both prefer the lower vocab id among equal values, as ``lax.top_k`` does
(:func:`topk_lowest_id`).

The kernel is built from the checkout at first use: ``nvcc`` compiles
``csrc/lens_stats.cu`` for ``sm_90a`` into ``csrc/build/`` (listed in
``.gitignore``), and the shared library is loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

#: Logit of a target that is absent (``-1``) or outside the vocabulary.
NEG_INF = -1e30

#: Vocab columns per kernel tile; the vocabulary must be a multiple of it.
BLOCK_V = 128

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "lens_stats.cu")
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
# The plain version.
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


def _check_shapes(x: torch.Tensor, embed: torch.Tensor, top_k: int) -> None:
    if x.dim() != 2 or embed.dim() != 2:
        raise ValueError(f"x must be [N, D] and embed [V, D], got "
                         f"{tuple(x.shape)} and {tuple(embed.shape)}")
    if x.shape[1] != embed.shape[1]:
        raise ValueError(f"width mismatch: x {tuple(x.shape)} vs embed "
                         f"{tuple(embed.shape)}")
    v = embed.shape[0]
    if v % BLOCK_V:
        raise ValueError(f"vocab {v} not divisible by the kernel's tile "
                         f"width {BLOCK_V}")
    if not 1 <= top_k <= BLOCK_V:
        raise ValueError(f"top_k must be in [1, {BLOCK_V}], got {top_k}")


def lens_stats_reference(
    x: torch.Tensor,            # [N, D]
    embed: torch.Tensor,        # [V, D]
    target_id: TargetLike,      # [] or [N]; -1 = no target
    *,
    top_k: int = 5,
    logit_cap: Optional[float] = None,
) -> LensStats:
    """The plain version: f32 logits ``x @ E^T`` (upcast before the product,
    as the kernel accumulates in f32), optional cap, logsumexp, target logit
    and top-k."""
    _check_shapes(x, embed, top_k)
    logits = x.float() @ embed.float().T
    if logit_cap is not None:
        logits = torch.tanh(logits / logit_cap) * logit_cap
    lse = torch.logsumexp(logits, dim=-1)
    targets = _targets(target_id, x.shape[0], x.device).long()
    tgt = torch.gather(logits, 1, targets.clamp(min=0)[:, None])[:, 0]
    tgt = torch.where(targets >= 0, tgt, torch.full_like(tgt, NEG_INF))
    vals, ids = topk_lowest_id(logits, top_k)
    return LensStats(logsumexp=lse, target_logit=tgt, topk_vals=vals,
                     topk_ids=ids)


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default home ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the lens kernel "
                           "is built from csrc/lens_stats.cu at first use")
    return found


def build_library() -> Tuple[str, str]:
    """Compile ``csrc/lens_stats.cu`` unless a build of the same source and
    flags exists.  Returns (path of the shared library, compiler output)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lens_stats-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    lib.tbx_lens_block_v.argtypes = []
    lib.tbx_lens_block_v.restype = ctypes.c_int
    lib.tbx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tbx_cuda_error_string.restype = ctypes.c_char_p
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.tbx_lens_stats.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   ctypes.c_float, i, p]
    lib.tbx_lens_stats.restype = ctypes.c_int
    if lib.tbx_lens_block_v() != BLOCK_V:
        raise RuntimeError(f"{path} tiles the vocab by "
                           f"{lib.tbx_lens_block_v()}, expected {BLOCK_V}")
    return lib


def _launch(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
            top_k: int, logit_cap: Optional[float]) -> LensStats:
    if embed.device != x.device:
        raise ValueError(f"x is on {x.device} but embed on {embed.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or embed.dtype != x.dtype:
        raise ValueError(f"the lens kernel takes bf16 or f32 x and embed of one "
                         f"dtype, got {x.dtype} and {embed.dtype}")
    if not (x.is_contiguous() and embed.is_contiguous()):
        raise ValueError("the lens kernel takes contiguous x and embed")
    n, d = x.shape
    v = embed.shape[0]
    vec = 16 // x.element_size()
    if d % vec or x.data_ptr() % 16 or embed.data_ptr() % 16:
        raise ValueError(f"the lens kernel reads 16-byte vectors: D={d} must "
                         f"be a multiple of {vec} and both inputs 16-byte "
                         "aligned")
    nt = v // BLOCK_V
    if n == 0 or nt > 65535:
        raise ValueError(f"the lens kernel takes 1 <= N and V <= "
                         f"{65535 * BLOCK_V}, got N={n}, V={v}")
    lib = _library()
    f32 = dict(dtype=torch.float32, device=x.device)
    tile_max = torch.empty((nt, n), **f32)
    tile_sumexp = torch.empty((nt, n), **f32)
    tile_tgt = torch.empty((nt, n), **f32)
    cand_vals = torch.empty((nt, n, top_k), **f32)
    cand_ids = torch.empty((nt, n, top_k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tbx_lens_stats(
            x.data_ptr(), embed.data_ptr(), targets.data_ptr(),
            tile_max.data_ptr(), tile_sumexp.data_ptr(), tile_tgt.data_ptr(),
            cand_vals.data_ptr(), cand_ids.data_ptr(),
            n, d, v, top_k, int(logit_cap is not None),
            float(logit_cap or 0.0), int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("lens_stats kernel launch failed: "
                           + lib.tbx_cuda_error_string(rc).decode())
    lens_stats.launches += 1

    # Epilogue over the [NT, N] partials.
    gmax = tile_max.max(dim=0).values
    lse = gmax + torch.log((tile_sumexp * torch.exp(tile_max - gmax)).sum(dim=0))
    target_logit = tile_tgt.max(dim=0).values
    flat_vals = cand_vals.permute(1, 0, 2).reshape(n, nt * top_k)
    flat_ids = cand_ids.permute(1, 0, 2).reshape(n, nt * top_k)
    top_vals, top_ids = topk_lowest_id(flat_vals, top_k, ids=flat_ids)
    return LensStats(logsumexp=lse, target_logit=target_logit,
                     topk_vals=top_vals, topk_ids=top_ids)


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

    CUDA tensors run the kernel; CPU tensors run :func:`lens_stats_reference`.
    """
    _check_shapes(x, embed, top_k)
    targets = _targets(target_id, x.shape[0], x.device)
    if x.device.type == "cpu" and embed.device.type == "cpu":
        return lens_stats_reference(x, embed, targets, top_k=top_k,
                                    logit_cap=logit_cap)
    if x.device.type != "cuda":
        raise ValueError(f"lens_stats runs on CUDA or CPU tensors, got "
                         f"{x.device} and {embed.device}")
    return _launch(x, embed, targets, top_k, logit_cap)


#: Kernel launches since the count was last set to 0.
lens_stats.launches = 0
