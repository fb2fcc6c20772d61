"""Gemma-2 in PyTorch, as plain functions over a dict of tensors.

The counterpart of the JAX package's ``models/gemma2.py``, with the same names
and the same parameter layout: ``{"embed", "final_norm", "layers": {...}}``
where every layer leaf is stacked on a leading ``[num_layers, ...]`` axis and
projections are stored ``[in, out]`` (the model computes ``x @ W``).  The JAX
forward is one ``lax.scan`` over the stacked layers; here it is a Python loop
over slices of the same stacks.

Activation taps are returned values, as in the JAX package:

- ``per_layer_fn(resid_post, layer_idx)`` runs after every layer and its
  results come back stacked on a leading layer axis;
- ``carry_tap = (init, update)`` folds ``acc = update(acc, resid_post,
  layer_idx)`` through the layers and only the final ``acc`` survives;
- ``edit_fn(resid_post, layer_idx) -> resid_post`` rewrites the residual
  stream (the intervention hook point).

Gemma-2 numerics follow the JAX reference step for step: RMSNorm in f32 with
``(1 + w)`` scale, cast back to the input dtype; GQA with the attention
logits formed in the compute dtype, then cast to f32, scaled, softcapped
(50.0), masked with ``-2.3819763e38`` and soft-maxed in f32 before the cast
back; even layers slide (window 4096); GeGLU MLP with tanh gelu; sandwich
norms; tied embeddings scaled by ``sqrt(hidden)`` rounded in the compute
dtype; RoPE in the rotate-half layout; final logits softcapped (30.0) in f32.

The KV cache is written in place: ``forward`` with a ``cache`` stores the new
chunk's keys and values into ``cache.k`` / ``cache.v`` and returns a cache
that shares those tensors (JAX threads a new array through the scan carry
instead; the values are the same).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from taboo_brittleness_tpu_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

#: Fill value of masked attention logits (the f32 value HF and the JAX
#: package use; finite, so a fully masked row soft-maxes to uniform).
ATTN_MASK_FILL = -2.3819763e38


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(_DTYPES)}")


@dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256_000
    hidden_size: int = 3584
    num_layers: int = 42
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 256
    intermediate_size: int = 14336
    sliding_window: int = 4096
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0
    query_pre_attn_scalar: float = 256.0
    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "bfloat16"  # weight storage dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def is_sliding(self, layer_idx: int) -> bool:
        """Even layers use sliding-window attention, odd layers global."""
        return layer_idx % 2 == 0

    def replace(self, **kw) -> "Gemma2Config":
        return dataclasses.replace(self, **kw)


# Architecture presets (the JAX package's, unchanged).  gemma2_9b matches
# `bcywinski/gemma-2-9b-it-taboo-*` (42 layers / hidden 3584 / vocab 256000).
PRESETS: Dict[str, Gemma2Config] = {
    "gemma2_9b": Gemma2Config(),
    "gemma2_2b": Gemma2Config(
        hidden_size=2304, num_layers=26, num_heads=8, num_kv_heads=4,
        intermediate_size=9216,
    ),
    "gemma2_bench": Gemma2Config(
        hidden_size=2304, num_layers=26, num_heads=8, num_kv_heads=4,
        intermediate_size=9216, vocab_size=256_000,
    ),
    # Tiny config for unit tests (sliding_window < seq to exercise local masking).
    "gemma2_tiny": Gemma2Config(
        vocab_size=199, hidden_size=32, num_layers=4, num_heads=4, num_kv_heads=2,
        head_dim=8, intermediate_size=64, sliding_window=3,
        query_pre_attn_scalar=8.0, dtype="float32", param_dtype="float32",
    ),
}


# ---------------------------------------------------------------------------
# Parameter init (random — real checkpoints come through models/params.py).
# ---------------------------------------------------------------------------

def init_params(cfg: Gemma2Config, generator: torch.Generator, *,
                device: DeviceLike = None, mesh: Any = None) -> Params:
    """Random-normal params in the stacked layout, drawn from ``generator``.

    ``generator`` must live on ``device`` (``torch.Generator(device=...)``).
    Each layer's slice is drawn in f32 and cast to the storage dtype on its
    own, so the f32 staging never exceeds one layer of one leaf (the 9B's
    stacked MLP leaves are 4.3 GB in bf16 and twice that in f32).  The
    scales are the JAX package's; the numbers are not (the two generators
    differ — carry JAX weights across with ``params.from_jax_params``).

    With a ``mesh`` (``parallel.mesh``) every leaf is drawn whole, in the
    same order, and only this rank's shard of it is kept
    (``parallel.mesh.shard_leaf``), layer by layer: the shards of the same
    seed's params, with no rank holding the whole model.
    """
    device = resolve_device(device)
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, K, Dh, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    sd = cfg.storage_dtype

    if mesh is not None:
        from taboo_brittleness_tpu_torch.parallel.mesh import check_tp

        check_tp(cfg, mesh)

    def keep(name: str, t: torch.Tensor, stacked: bool = True) -> torch.Tensor:
        if mesh is None:
            return t
        from taboo_brittleness_tpu_torch.parallel.mesh import shard_leaf

        return shard_leaf(name, t, cfg, mesh, stacked=stacked)

    def w(shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(sd)

    def stacked(name: str, shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        first = keep(f"layers.{name}", w(shape, scale), stacked=False)
        out = torch.empty((L,) + tuple(first.shape), dtype=sd, device=device)
        out[0] = first
        for i in range(1, L):
            out[i] = keep(f"layers.{name}", w(shape, scale), stacked=False)
        return out

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=sd, device=device)

    return {
        "embed": keep("embed", w((cfg.vocab_size, D), D ** -0.5)),
        "final_norm": zeros(D),
        "layers": {
            "input_norm": zeros(L, D),
            "post_attn_norm": zeros(L, D),
            "pre_ffn_norm": zeros(L, D),
            "post_ffn_norm": zeros(L, D),
            "q": stacked("q", (D, H * Dh), D ** -0.5),
            "k": stacked("k", (D, K * Dh), D ** -0.5),
            "v": stacked("v", (D, K * Dh), D ** -0.5),
            "o": stacked("o", (H * Dh, D), (H * Dh) ** -0.5),
            "gate": stacked("gate", (D, F), D ** -0.5),
            "up": stacked("up", (D, F), D ** -0.5),
            "down": stacked("down", (F, D), F ** -0.5),
        },
    }


def num_params(params: Params) -> int:
    total = 0
    for v in params.values():
        total += num_params(v) if isinstance(v, dict) else v.numel()
    return total


# ---------------------------------------------------------------------------
# Building blocks (f32 where HF computes in f32).
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma-style RMSNorm: normalize and scale by (1 + w) in f32, cast back."""
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., T, head_dim] in f32, rotate-half layout."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, Dh]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def attend(
    q: torch.Tensor,              # [B, T, H, Dh]
    k: torch.Tensor,              # [B, S, K, Dh]
    v: torch.Tensor,              # [B, S, K, Dh]
    mask: torch.Tensor,           # [B, T, S] bool (True = attend)
    *,
    scaling: float,
    logit_cap: float,
) -> torch.Tensor:
    """GQA attention with logit softcapping; softmax in f32 (HF eager path).

    Stays eager: ``scaled_dot_product_attention`` has no logit softcap, and
    the JAX package has no attention kernel to port."""
    B, T, H, Dh = q.shape
    K = k.shape[2]
    groups = H // K
    qg = q.reshape(B, T, K, groups, Dh)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scaling
    logits = softcap(logits, logit_cap)
    logits = logits.masked_fill(~mask[:, None, None, :, :], ATTN_MASK_FILL)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", weights, v)
    return out.reshape(B, T, H * Dh)


def causal_mask(positions_q: torch.Tensor, positions_kv: torch.Tensor,
                valid_kv: torch.Tensor,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """[B, T, S] bool mask: causal (kv pos <= q pos), optionally sliding-window
    (q_pos - kv_pos < window), AND kv validity (padding)."""
    diff = positions_q[:, :, None] - positions_kv[:, None, :]
    mask = diff >= 0
    if sliding_window is not None:
        mask = mask & (diff < sliding_window)
    return mask & valid_kv[:, None, :]


# ---------------------------------------------------------------------------
# KV cache and the decoder stack.
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Per-layer KV cache stacked on a leading layer axis: [L, B, S, K, Dh].

    ``valid`` marks which slots hold real (non-pad) tokens per batch row;
    with left-padded prompts the pad slots stay invalid forever.  ``length``
    is the slot write pointer shared by every row (rows are padded to align).
    ``k`` and ``v`` are written in place by :func:`forward`.
    """

    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor   # [B, S] bool
    length: int           # number of occupied slots

    @classmethod
    def zeros(cls, cfg: Gemma2Config, batch: int, max_len: int, *,
              device: torch.device,
              kv_heads: Optional[int] = None) -> "KVCache":
        """An empty cache of ``kv_heads`` heads (default all of ``cfg``'s;
        a tp rank's params hold fewer: :func:`local_kv_heads`)."""
        heads = cfg.num_kv_heads if kv_heads is None else kv_heads
        shape = (cfg.num_layers, batch, max_len, heads, cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
            length=0,
        )


def local_kv_heads(params: Params, cfg: Gemma2Config) -> int:
    """The kv heads ``params`` hold: all of ``cfg``'s, or K/tp on a tp
    rank (``parallel.mesh.shard_params`` splits ``k`` by heads)."""
    return params["layers"]["k"].shape[-1] // cfg.head_dim


def _layer(
    h: torch.Tensor,              # [B, T, D]
    lp: Params,                   # this layer's params (leading L axis sliced away)
    layer_idx: int,
    cfg: Gemma2Config,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,           # [B, T, S] for this layer's attention kind
    cache_k: Optional[torch.Tensor],  # [B, S, K, Dh] this layer's cache slab
    cache_v: Optional[torch.Tensor],
    cache_index: int,             # slot at which the chunk is written
    cache_cols: Optional[torch.Tensor] = None,  # [B, T] per-row columns
    mesh: Any = None,             # tp mesh of sharded params (None: whole)
    attend_fn: Optional[Callable] = None,  # (q, k, v, layer_idx) -> [B, T, H*Dh]
) -> torch.Tensor:
    B, T, _ = h.shape
    Dh = cfg.head_dim
    # Heads from the weights: a tp rank holds H/tp query and K/tp kv heads.
    H, K = lp["q"].shape[-1] // Dh, lp["k"].shape[-1] // Dh
    cdt = cfg.compute_dtype
    eps = cfg.rms_norm_eps

    residual = h
    x = rms_norm(h, lp["input_norm"], eps)
    q = (x @ lp["q"].to(cdt)).reshape(B, T, H, Dh)
    k = (x @ lp["k"].to(cdt)).reshape(B, T, K, Dh)
    v = (x @ lp["v"].to(cdt)).reshape(B, T, K, Dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache_k is not None and cache_cols is not None:
        # Each row's chunk at its own columns.  Finished rows of a
        # speculative block all write the trash column, so one index_put
        # may hold a repeated (row, col) pair whose winner is undefined:
        # harmless only because the trash column never becomes valid.
        rows = torch.arange(B, device=h.device)[:, None]
        cache_k[rows, cache_cols] = k
        cache_v[rows, cache_cols] = v
        k_all, v_all = cache_k, cache_v
    elif cache_k is not None:
        cache_k[:, cache_index:cache_index + T] = k
        cache_v[:, cache_index:cache_index + T] = v
        k_all, v_all = cache_k, cache_v
    else:
        k_all, v_all = k, v

    if attend_fn is not None:
        attn = attend_fn(q, k_all, v_all, layer_idx)
    else:
        attn = attend(q, k_all, v_all, mask,
                      scaling=cfg.query_pre_attn_scalar ** -0.5,
                      logit_cap=cfg.attn_logit_softcap)
    attn = attn @ lp["o"].to(cdt)
    if mesh is not None:           # row-parallel o: sum the partial products
        attn = mesh.all_reduce(attn, "tp")
    attn = rms_norm(attn, lp["post_attn_norm"], eps)
    h = residual + attn

    residual = h
    x = rms_norm(h, lp["pre_ffn_norm"], eps)
    gate = torch.nn.functional.gelu(x @ lp["gate"].to(cdt), approximate="tanh")
    up = x @ lp["up"].to(cdt)
    mlp = (gate * up) @ lp["down"].to(cdt)
    if mesh is not None:           # row-parallel down
        mlp = mesh.all_reduce(mlp, "tp")
    mlp = rms_norm(mlp, lp["post_ffn_norm"], eps)
    return residual + mlp


class ForwardResult(NamedTuple):
    logits: Optional[torch.Tensor]     # [B, T, V] (final-layer, softcapped, f32)
    last_hidden: torch.Tensor          # [B, T, D] (pre-final-norm resid_post of last layer)
    taps: Any                          # per_layer_fn outputs stacked [L, ...]; None if unused
    cache: Optional[KVCache]
    carry_tap: Any = None              # final accumulator from carry_tap, if given


def stack_layers(items: List[Any]) -> Any:
    """Stack per-layer tap outputs on a new leading axis, through tuples
    and NamedTuples (the result mirrors the JAX scan's stacked outputs)."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):
        fields = [stack_layers([it[i] for it in items]) for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    raise TypeError(f"cannot stack per-layer outputs of type {type(first)}")


@functools.lru_cache(maxsize=None)
def _rounded_sqrt(hidden: int, dtype: torch.dtype) -> float:
    return float(torch.tensor(hidden ** 0.5, dtype=dtype))


def embed_scale(cfg: Gemma2Config) -> float:
    """``sqrt(hidden)`` rounded to the compute dtype, as a Python float.

    A Python scalar multiplies without a host-to-device copy (which a CUDA
    graph cannot capture), and the product is the same as with the
    rounded scalar as a tensor: both widen the operands to f32, multiply
    and round once.  The unrounded ``sqrt`` would change the embedding's
    bits."""
    return _rounded_sqrt(cfg.hidden_size, cfg.compute_dtype)


def _vocab_mesh(params: Params, cfg: Gemma2Config) -> Any:
    """The tp mesh of vocab-sharded params, None for whole ones."""
    if params["embed"].shape[0] == cfg.vocab_size:
        return None
    from taboo_brittleness_tpu_torch.parallel import mesh as meshlib

    return meshlib.vocab_mesh(params, cfg)


def embed_rows(params: Params, cfg: Gemma2Config,
               ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``ids`` in the storage dtype.  Over vocab-sharded
    params each rank looks up the ids its rows hold (zero elsewhere) and
    the tp group sums them: exact, one row is nonzero."""
    mesh = _vocab_mesh(params, cfg)
    embed = params["embed"]
    if mesh is None:
        return embed[ids]
    v_local = embed.shape[0]
    local = ids - mesh.axis_index("tp") * v_local
    inside = (local >= 0) & (local < v_local)
    rows = embed[local.clamp(0, v_local - 1)] * inside[..., None]
    return mesh.all_reduce(rows, "tp")


def embed_lookup(params: Params, cfg: Gemma2Config,
                 input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``input_ids`` in the compute dtype
    (:func:`embed_rows`)."""
    return embed_rows(params, cfg, input_ids).to(cfg.compute_dtype)


def unembed(params: Params, cfg: Gemma2Config, h: torch.Tensor) -> torch.Tensor:
    """final_norm -> tied-embedding lm_head -> final logit softcap, in f32.
    Over vocab-sharded params the tp group's logits are gathered (JAX's
    GSPMD gathers the sharded product the same way)."""
    x = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    logits = x @ params["embed"].to(cfg.compute_dtype).T
    # tbx: f32-ok — the final softcap and the greedy/NLL readouts run in f32
    # (the JAX package's unembed); the slab is one step's [B, T, V].
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    mesh = _vocab_mesh(params, cfg)
    return logits if mesh is None else mesh.all_gather(logits, "tp", dim=-1)


@torch.no_grad()
def forward(
    params: Params,
    cfg: Gemma2Config,
    input_ids: torch.Tensor,                  # [B, T]
    *,
    positions: Optional[torch.Tensor] = None,  # [B, T] (default arange)
    attn_validity: Optional[torch.Tensor] = None,  # [B, T] bool, False = pad
    cache: Optional[KVCache] = None,          # decode mode if given
    per_layer_fn: Optional[Callable[[torch.Tensor, int], Any]] = None,
    edit_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
    carry_tap: Optional[Tuple[Any, Callable[[Any, torch.Tensor, int], Any]]] = None,
    compute_logits: bool = True,
    cache_positions: Optional[torch.Tensor] = None,  # [B] or [B, T] columns
    valid_in_place: bool = False,
    attend_fn: Optional[Callable] = None,
) -> ForwardResult:
    """One forward pass over the whole stack (see the module docstring for
    the hooks).

    With ``cache``, [B, T] is the *new* chunk (T=1 for decode steps): its
    keys/values are written at ``cache.length`` and attention spans the
    whole cache.  KV positions for masking are rebuilt from the validity
    cumsum, not from ``cache.length``, so left-padded rows mask correctly.

    ``cache_positions`` (requires ``cache``) writes each row's new keys,
    values and validity at its OWN columns instead of at ``cache.length``:
    a ``[B]`` tensor with T = 1 (one column per row), or a ``[B, T]`` tensor
    mapping every chunk position to its column (the speculative verify
    block writes G + 1 columns at per-row offsets).  Columns must grow
    along each row (masking rebuilds KV positions from the validity
    cumsum).  ``cache.length`` is not advanced in this mode.

    ``valid_in_place`` writes the chunk's validity into ``cache.valid``
    itself instead of a copy (the returned cache shares it): a decode step
    replayed from a CUDA graph keeps its validity in a resident buffer.
    The default copies, for callers that reuse one ``valid`` for several
    forwards (the speculative blocks) or keep the prefill's.

    ``attend_fn(q, k, v, layer_idx) -> [B, T, H*Dh]`` replaces the dense
    attention and owns its masking (the sequence-parallel ring,
    ``parallel.sp``); it does not take the KV-cache path.

    Params sharded by ``parallel.mesh.shard_params`` run the tensor-parallel
    forward over the process's tp mesh: local heads ``H/tp`` and ``K/tp``
    (the cache holds the local kv heads), column-parallel ``q``/``k``/``v``/
    ``gate``/``up``, row-parallel ``o``/``down`` followed by an
    ``all_reduce``, and the vocab-sharded embedding (:func:`embed_lookup`,
    :func:`unembed`).
    """
    if attend_fn is not None and cache is not None:
        raise ValueError("attend_fn does not support the KV-cache decode path")
    if cache_positions is not None and cache is None:
        raise ValueError("cache_positions requires the KV-cache decode path")
    if (cache_positions is not None and cache_positions.ndim == 1
            and input_ids.shape[1] != 1):
        raise ValueError("[B] cache_positions supports single-token chunks "
                         f"only (got T={input_ids.shape[1]}); pass a [B, T] "
                         "column map for multi-token chunks")
    if (cache_positions is not None and cache_positions.ndim == 2
            and tuple(cache_positions.shape) != tuple(input_ids.shape)):
        raise ValueError(
            f"[B, T] cache_positions {tuple(cache_positions.shape)} must match "
            f"input_ids {tuple(input_ids.shape)}")
    B, T = input_ids.shape
    device = input_ids.device
    cdt = cfg.compute_dtype

    if positions is None:
        if cache is not None:
            # Per-row count of real tokens so far — NOT cache.length, which
            # counts pad slots of a left-padded prefill.
            base = cache.valid.sum(dim=1, keepdim=True)
        else:
            base = torch.zeros((B, 1), dtype=torch.long, device=device)
        positions = torch.arange(T, device=device)[None, :] + base
    if attn_validity is None:
        attn_validity = torch.ones((B, T), dtype=torch.bool, device=device)

    # Embed + sqrt(D) scale, rounded in compute dtype exactly as HF does.
    h = embed_lookup(params, cfg, input_ids)
    h = h * embed_scale(cfg)
    mesh = _vocab_mesh(params, cfg)

    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    cols = (cache_positions.long().reshape(B, T)
            if cache_positions is not None else None)
    if attend_fn is not None:
        mask_global = mask_sliding = None      # attend_fn owns masking
    elif cache is not None:
        new_valid = cache.valid if valid_in_place else cache.valid.clone()
        if cols is not None:
            new_valid[torch.arange(B, device=device)[:, None], cols] = attn_validity
        else:
            new_valid[:, cache.length:cache.length + T] = attn_validity
        # Slot i of row b holds a token whose RoPE position is the count of
        # real slots before it: pads carry a junk position but are masked
        # out by `valid`, and real slots are written in order.
        kv_positions = torch.cumsum(new_valid.long(), dim=1) - 1
        mask_global = causal_mask(positions, kv_positions, new_valid)
        mask_sliding = causal_mask(positions, kv_positions, new_valid,
                                   cfg.sliding_window)
    else:
        mask_global = causal_mask(positions, positions, attn_validity)
        mask_sliding = causal_mask(positions, positions, attn_validity,
                                   cfg.sliding_window)

    layers = params["layers"]
    acc = carry_tap[0] if carry_tap is not None else None
    taps: List[Any] = []
    for idx in range(cfg.num_layers):
        lp = {name: leaf[idx] for name, leaf in layers.items()}
        mask = mask_sliding if cfg.is_sliding(idx) else mask_global
        h = _layer(
            h, lp, idx, cfg, cos, sin, mask,
            cache.k[idx] if cache is not None else None,
            cache.v[idx] if cache is not None else None,
            cache.length if cache is not None else 0,
            cols, mesh, attend_fn,
        )
        if edit_fn is not None:
            h = edit_fn(h, idx)
        if carry_tap is not None:
            acc = carry_tap[1](acc, h, idx)
        if per_layer_fn is not None:
            taps.append(per_layer_fn(h, idx))

    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, valid=new_valid,
                            length=cache.length + (0 if cols is not None else T))
    logits = unembed(params, cfg, h) if compute_logits else None
    return ForwardResult(
        logits=logits, last_hidden=h,
        taps=stack_layers(taps) if per_layer_fn is not None else None,
        cache=new_cache, carry_tap=acc if carry_tap is not None else None)
