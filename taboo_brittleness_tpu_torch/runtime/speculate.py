"""Self-speculative greedy decoding: the logit-lens head as a free draft model.

The counterpart of the JAX package's ``runtime/speculate.py``.  An early
layer's unembedded residual is a draft model inside the target network whose
weights are a prefix of the target's.  Per block:

1. **Draft** G tokens autoregressively from the layer-k lens head
   (:func:`draft_step`: single-token forwards over layers 0..k with the
   draft's OWN KV cache, each next token ``ops.lens.lens_argmax`` of the
   layer-k residual).
2. **Verify** the block in ONE full-depth forward over the G + 1
   teacher-forced positions ``[last emitted, draft_1..draft_G]``
   (:func:`verify_block`, ``gemma2.forward(cache_positions=[B, G+1])``,
   since rows accept different draft counts).  The longest prefix where
   draft == target argmax is accepted, plus one bonus token from the verify
   pass itself, so every active row advances by at least one token.
3. Every emitted token is the full model's argmax at its position: the
   stream is the vanilla greedy stream, up to rounding that depends on the
   forward's shape (the verify runs G + 1 columns where vanilla runs one).

The block loop is driven from the host and pulls one small tensor per block
(the all-done flag and 4 stats counters); the G draft steps and the verify
bookkeeping run without a host sync.  ``speculate.verify`` (the fault site
of ``runtime.resilience``) fires before each verify, and a drain notice
(``runtime.supervise``) seen between blocks is recorded as a
``speculate.drain_observed`` event (the decode still finishes: drain is
word-granular).  Unlike the JAX package there is no ``obs`` span, profiler
annotation or ``decode_edit`` switch: the edit runs in the prefill, the
draft and the verify alike.

Draft depth k and block size G come from the env (``TBX_SPEC_DRAFT_LAYER``,
``TBX_SPEC_BLOCK``), then the ``TBX_SPEC_CALIBRATION`` artifact of
``perf.spec_calibrate``, then a default; ``TBX_SPECULATE=1`` routes
``decode.generate`` and the token-forcing decodes through this module.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from taboo_brittleness_tpu_torch.models.gemma2 import (
    Gemma2Config,
    KVCache,
    Params,
    forward,
    unembed,
)
from taboo_brittleness_tpu_torch.ops.lens import (
    _lens_logits,
    lens_argmax,
    residual_carry_tap,
)
from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.runtime import chat, resilience, supervise
from taboo_brittleness_tpu_torch.runtime.decode import (
    STOP_IDS,
    DecodeResult,
    with_chunk_positions,
)

#: Default draft block size when neither env nor calibration pins one.
DEFAULT_BLOCK = 3


def enabled() -> bool:
    """Opt-in gate: ``TBX_SPECULATE=1`` routes ``decode.generate`` launches
    through the speculative decoder.  Off by default."""
    return os.environ.get("TBX_SPECULATE", "0") == "1"


def capture_extension_enabled() -> bool:
    """Whether speculation also covers residual-CAPTURING decodes
    (``TBX_SPECULATE_CAPTURE=1``).  Tokens stay the greedy stream, but the
    captured f32 residual comes from forwards of other shapes and agrees
    with vanilla's only to rounding, so by default the study's capture
    launches stay vanilla and every study JSON is unchanged."""
    return os.environ.get("TBX_SPECULATE_CAPTURE", "0") == "1"


def should_speculate(*, capture: bool) -> bool:
    """The routing predicate of ``decode.generate`` and the forcing
    decodes: on, and for capture launches only under the extension."""
    if not enabled():
        return False
    return not capture or capture_extension_enabled()


# ---------------------------------------------------------------------------
# Plan resolution: env override -> calibration artifact -> default.
# ---------------------------------------------------------------------------

class SpecPlan(NamedTuple):
    """One word's schedule: draft depth k (the lens head's layer) and block
    size G (drafted tokens per verify)."""

    draft_layer: int
    block_size: int
    source: str = "default"


_WORD_LOCK = threading.Lock()
_ACTIVE_WORD: Optional[str] = None
_CALIBRATION_CACHE: Dict[str, Tuple[float, Dict[str, Any]]] = {}


def set_active_word(word: Optional[str]) -> None:
    """Tell the dispatcher which word's calibration entry applies (the
    sweeps call this as each word loads; ``decode.generate`` has no word
    argument)."""
    global _ACTIVE_WORD
    with _WORD_LOCK:
        _ACTIVE_WORD = word


def active_word() -> Optional[str]:
    with _WORD_LOCK:
        return _ACTIVE_WORD


def _load_calibration(path: str) -> Optional[Dict[str, Any]]:
    """The calibration artifact, memoized on mtime; an unreadable or absent
    one gives None (the default plan), never an error."""
    try:
        mtime = os.path.getmtime(path)
        hit = _CALIBRATION_CACHE.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        with open(path) as f:
            data = json.load(f)
        _CALIBRATION_CACHE[path] = (mtime, data)
        return data
    except (OSError, ValueError):
        return None


def default_draft_layer(cfg: Gemma2Config) -> int:
    """Uncalibrated fallback: two thirds of the stack, leaving at least one
    target-only layer."""
    return max(0, min((2 * cfg.num_layers) // 3, cfg.num_layers - 2))


def resolve_plan(cfg: Gemma2Config, word: Optional[str] = None) -> SpecPlan:
    """(k, G) for the next speculative launch.  Priority:
    ``TBX_SPEC_DRAFT_LAYER`` / ``TBX_SPEC_BLOCK``, then the
    ``TBX_SPEC_CALIBRATION`` artifact's entry for ``word`` (default: the
    active word) or its ``default`` block, then :func:`default_draft_layer`
    and :data:`DEFAULT_BLOCK`; k is clamped to [0, L - 2], G to >= 1."""
    k = g = None
    source = "default"
    env_k = os.environ.get("TBX_SPEC_DRAFT_LAYER")
    env_g = os.environ.get("TBX_SPEC_BLOCK")
    if env_k:
        k, source = int(env_k), "env"
    if env_g:
        g, source = int(env_g), "env"
    if k is None or g is None:
        path = os.environ.get("TBX_SPEC_CALIBRATION")
        data = _load_calibration(path) if path else None
        if data is not None:
            w = word if word is not None else active_word()
            entry = (data.get("words", {}).get(w)
                     or data.get("default")) if isinstance(data, dict) else None
            if isinstance(entry, dict):
                if k is None and entry.get("draft_layer") is not None:
                    k, source = int(entry["draft_layer"]), "calibration"
                if g is None and entry.get("block_size") is not None:
                    g, source = int(entry["block_size"]), "calibration"
    if k is None:
        k = default_draft_layer(cfg)
    if g is None:
        g = DEFAULT_BLOCK
    k = max(0, min(int(k), cfg.num_layers - 2))
    g = max(1, int(g))
    return SpecPlan(draft_layer=k, block_size=g, source=source)


# ---------------------------------------------------------------------------
# Per-decode stats (host side).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecStats:
    """Host-side accounting of one speculative decode."""

    blocks: int = 0          # verify launches
    drafted: int = 0         # draft tokens proposed (G x active rows, summed)
    accepted: int = 0        # drafted tokens whose emission was accepted
    emitted: int = 0         # tokens emitted by verify passes (incl. bonus)
    rows: int = 0
    # sum over blocks of that block's active rows (denominator of the mean)
    blocks_rows: int = 0

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_verify(self) -> float:
        """Mean tokens emitted per verify per active row (1.0: speculation
        won nothing; G + 1: every draft accepted)."""
        return self.emitted / self.blocks_rows if self.blocks_rows else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "blocks": self.blocks, "drafted": self.drafted,
            "accepted": self.accepted, "emitted": self.emitted,
            "rows": self.rows,
            "accept_rate": round(self.accept_rate, 4),
            "tokens_per_verify": round(self.tokens_per_verify, 4),
        }


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------

def _valid_cols(prompt_valid: torch.Tensor, n_emit: torch.Tensor,
                width: int) -> torch.Tensor:
    """[B, width] KV-column validity implied by the counters: the prompt's
    own validity plus generated columns ``[Tp, Tp + n_emit - 1)``.
    Recomputed per block, so a rejected draft's column simply never becomes
    valid."""
    B, Tp = prompt_valid.shape
    col = torch.arange(width, device=prompt_valid.device)[None, :]
    valid = torch.zeros((B, width), dtype=torch.bool, device=prompt_valid.device)
    valid[:, :Tp] = prompt_valid
    return valid | ((col >= Tp) & (col < (Tp + n_emit - 1)[:, None]))


def _bind_edit(edit_fn: Optional[Callable], edit_params: Any,
               chunk_positions: torch.Tensor) -> Optional[Callable]:
    """The edit as ``greedy_decode`` binds it: a dict of edit params gains
    the chunk's RoPE positions (``chunk_positions``)."""
    if edit_fn is None or edit_params is None:
        return edit_fn
    ep = with_chunk_positions(edit_params, chunk_positions)
    return lambda h, idx: edit_fn(h, idx, ep)


def _is_stop(tok: torch.Tensor, stop: Any) -> torch.Tensor:
    """Whether each token is a stop id: ``stop`` a tensor of ids on
    ``tok``'s device (what a captured step needs), or a tuple of them."""
    if not isinstance(stop, torch.Tensor):
        stop = torch.tensor(stop, dtype=tok.dtype, device=tok.device)
    return (tok[..., None] == stop).any(dim=-1)


def _draft_view(params: Params, draft_layer: int) -> Params:
    """The draft model: layers 0..k plus the shared embedding and final
    norm (the lens head) — views, no copy."""
    return {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "layers": {n: leaf[:draft_layer + 1]
                   for n, leaf in params["layers"].items()},
    }


def lens_pick(params: Params, cfg: Gemma2Config, last_hidden: torch.Tensor,
              *, with_margin: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The draft head's token pick, shared by the block decoder and the
    serve engine's draft program: the lens argmax over the layer-k
    residual, optionally with the top1 - top2 lens-LOGIT gap per position
    (the confidence the adaptive-depth serve scenario thresholds on).
    Returns ``(tok, margin)``, ``margin`` None unless requested.  With the
    margin the pick is a top-2 over the f32 lens logits with ties to the
    lowest id (``ops.lens_kernel.topk_lowest_id``), as JAX's ``lax.top_k``
    breaks them, so the token is the same as :func:`lens_argmax`'s."""
    if not with_margin:
        return lens_argmax(params, cfg, last_hidden), None
    from taboo_brittleness_tpu_torch.ops.lens_kernel import topk_lowest_id

    top2, idx = topk_lowest_id(_lens_logits(params, cfg, last_hidden), 2)
    return idx[..., 0].long(), (top2[..., 0] - top2[..., 1]).float()


def accept_counts(drafts: torch.Tensor, y: torch.Tensor, *,
                  limit: Optional[torch.Tensor] = None,
                  extra: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speculation accept rule, shared by :func:`verify_block` and the
    serve engine's verify step: ``match[b, j]`` = draft j equals the full
    model's argmax at its position (``y[:, :G]``); ``m[b]`` = length of the
    accepted prefix.  ``extra`` widens acceptance per position (the
    adaptive-depth margin override); ``limit`` cuts each row's acceptance
    at its own draft budget (per-slot G as data).  Returns
    ``(match [B, G] bool, m [B])``."""
    G = drafts.shape[-1]
    match = drafts == y[..., :G]
    accept = match if extra is None else (match | extra)
    if limit is not None:
        accept = accept & (torch.arange(G, device=drafts.device)[None, :]
                           < limit[:, None])
    m = torch.cumprod(accept.long(), dim=-1).sum(dim=-1)
    return match, m


def stop_free_mask(toks: torch.Tensor, stop: Any) -> torch.Tensor:
    """[B, W] emission gate: position i is emittable iff no stop id (as
    :func:`_is_stop` takes them) precedes it (the stop token itself is
    kept, as in ``greedy_decode``)."""
    st = _is_stop(toks, stop)
    head = torch.ones_like(st[:, :1])
    return torch.cat([head, torch.cumprod((~st[:, :-1]).long(), dim=1).bool()],
                     dim=1)


# ---------------------------------------------------------------------------
# The block programs and the capture flush.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecBuffers:
    """The device state the block loop steps over in place (pooled by launch
    shape, so the draft and the verify program share it)."""

    main_k: torch.Tensor       # [L, B, S, Kh, Dh] full-depth KV
    main_v: torch.Tensor
    draft_k: torch.Tensor      # [k+1, B, S, Kh, Dh] the draft's own KV
    draft_v: torch.Tensor
    prompt_valid: torch.Tensor  # [B, Tp] bool
    toks: torch.Tensor         # [B, N+1] emitted tokens (slot N = trash)
    emit: torch.Tensor         # [B, N+1] bool
    resid: Optional[torch.Tensor]  # [B, S, D] f32 captured residual
    last_tok: torch.Tensor     # [B] last emitted token (next block's first)
    n_emit: torch.Tensor       # [B] tokens emitted so far
    done: torch.Tensor         # [B] row finished (stop emitted or budget out)
    plen: torch.Tensor         # [B] real prompt lengths (RoPE base)
    drafts: torch.Tensor       # [B, G] the block's drafted tokens
    stats: torch.Tensor        # [5] all-done, emitted, accepted, drafted, active
    stop: torch.Tensor         # [S_ids] stop ids


def _spec_buffers(cfg: Gemma2Config, B: int, Tp: int, N: int, G: int,
                  draft_layer: int, stop_ids: Tuple[int, ...],
                  capture: bool, device: torch.device,
                  registry: bool) -> SpecBuffers:
    """The launch shape's buffers: pooled when the registry is on (the main
    KV cache in the shared KV pool of its width), else fresh."""
    from taboo_brittleness_tpu_torch.runtime import aot

    S = Tp + N + G + 1
    kvd = (cfg.num_kv_heads, cfg.head_dim)

    specs = {"draft_k": ((draft_layer + 1, B, S) + kvd, cfg.compute_dtype),
             "draft_v": ((draft_layer + 1, B, S) + kvd, cfg.compute_dtype),
             "prompt_valid": ((B, Tp), torch.bool),
             "toks": ((B, N + 1), torch.long), "emit": ((B, N + 1), torch.bool),
             "last_tok": ((B,), torch.long), "n_emit": ((B,), torch.long),
             "done": ((B,), torch.bool), "plen": ((B,), torch.long),
             "drafts": ((B, G), torch.long), "stats": ((5,), torch.long),
             "stop": ((len(stop_ids),), torch.long)}
    if capture:
        specs["resid"] = ((B, S, cfg.hidden_size), torch.float32)
    if registry:
        kv = aot.pooled_kv(cfg, B, S, device)
        t = aot.pooled(spec_pool_key(cfg, B, Tp, N, G, draft_layer, stop_ids,
                                     capture, device), specs, device)
    else:
        kv = aot.fresh_kv(cfg, B, S, device)
        t = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name, (shape, dtype) in specs.items()}
    t["stop"].copy_(torch.tensor(stop_ids, dtype=torch.long))
    return SpecBuffers(main_k=kv["k"], main_v=kv["v"], resid=t.get("resid"),
                       **{k: v for k, v in t.items() if k != "resid"})


def spec_pool_key(cfg: Gemma2Config, B: int, Tp: int, N: int, G: int,
                  draft_layer: int, stop_ids: Tuple[int, ...], capture: bool,
                  device: torch.device) -> Tuple:
    return ("spec", str(device), str(cfg.compute_dtype), cfg.num_layers,
            cfg.hidden_size, B, Tp, N, G, draft_layer, stop_ids, capture)


@torch.no_grad()
def spec_prefill(
    params: Params,
    cfg: Gemma2Config,
    st: SpecBuffers,
    prompt_ids: torch.Tensor,        # [B, Tp] left-padded
    prompt_valid: torch.Tensor,      # [B, Tp] bool
    prompt_positions: torch.Tensor,  # [B, Tp]
    edit_params: Any = None,
    *,
    draft_layer: int,
    edit_fn: Optional[Callable] = None,
    capture_residual_layer: Optional[int] = None,
) -> None:
    """Full-depth prefill into the speculative cache, the first token (slot
    0, as ``greedy_decode`` records it), and the draft cache: the prefill's
    KV at layers 0..k copied into the draft's own (the draft would compute
    the same K/V for the prompt), zero beyond the prompt.  Resets every
    counter of ``st``.

    Cache width is ``Tp + N + G + 1``: room for the deepest verify chunk a
    last block can write, plus one never-valid TRASH column at the end where
    finished rows' writes go.  The prefill writes through a view of the
    first ``Tp + N`` columns, the width ``greedy_decode`` gives it, so its
    attention has vanilla's shape and rounding."""
    B, Tp = prompt_ids.shape
    N = st.toks.shape[1] - 1
    device = prompt_ids.device
    st.prompt_valid.copy_(prompt_valid)
    # Past the prompt both caches start zero, as fresh ones: a pooled
    # cache's stale K/V would reach a finished row whose query has run out
    # of its sliding window (it attends uniformly over every column).
    st.main_k[:, :, Tp:] = 0
    st.main_v[:, :, Tp:] = 0
    prefill = forward(
        params, cfg, prompt_ids,
        positions=prompt_positions,
        attn_validity=prompt_valid,
        cache=KVCache(k=st.main_k[:, :, :Tp + N], v=st.main_v[:, :, :Tp + N],
                      valid=torch.zeros((B, Tp + N), dtype=torch.bool,
                                        device=device), length=0),
        edit_fn=_bind_edit(edit_fn, edit_params, prompt_positions),
        carry_tap=_carry(capture_residual_layer, B, Tp, cfg.hidden_size, device),
        compute_logits=False,
    )
    first_tok = torch.argmax(
        unembed(params, cfg, prefill.last_hidden[:, -1:])[:, 0], dim=-1)

    st.toks.fill_(chat.PAD_ID)
    st.emit.zero_()
    st.toks[:, 0] = first_tok
    st.emit[:, 0] = True
    st.done.copy_(_is_stop(first_tok, st.stop) | (N <= 1))
    if st.resid is not None:
        st.resid.zero_()
        st.resid[:, :Tp] = prefill.carry_tap
    st.draft_k[:, :, :Tp] = st.main_k[:draft_layer + 1, :, :Tp]
    st.draft_v[:, :, :Tp] = st.main_v[:draft_layer + 1, :, :Tp]
    st.draft_k[:, :, Tp:] = 0
    st.draft_v[:, :, Tp:] = 0
    st.last_tok.copy_(first_tok)
    st.n_emit.fill_(1)
    st.plen.copy_(prompt_valid.sum(dim=1))


def _carry(capture_layer: Optional[int], B: int, T: int, D: int, device):
    if capture_layer is None:
        return None
    return residual_carry_tap(B, T, D, capture_layer, device=device)


@torch.no_grad()
def draft_step(
    params: Params,
    cfg: Gemma2Config,
    st: SpecBuffers,
    edit_params: Any = None,
    *,
    draft_layer: int,
    edit_fn: Optional[Callable] = None,
) -> None:
    """Draft G tokens autoregressively from the layer-k lens head into
    ``st.drafts``: G single-token forwards over layers 0..k writing the
    draft's own KV (in place), each next token the lens argmax.  No host
    value or sync (a CUDA graph captures it).

    The draft only picks WHICH tokens are verified together; nothing it
    computes reaches an emitted token.  It feeds ``last_tok, d_1 ..
    d_{G-1}``: when a block accepts all G drafts, ``d_G``'s column of the
    draft cache is valid in the next block but never written (zeros), as
    in the JAX package — this moves the acceptance rate only."""
    Tp = st.prompt_valid.shape[1]
    S = st.draft_k.shape[2]
    trash = S - 1
    dcfg = cfg.replace(num_layers=draft_layer + 1)
    dparams = _draft_view(params, draft_layer)
    active = ~st.done
    pad = torch.full_like(st.last_tok, chat.PAD_ID)

    valid = _valid_cols(st.prompt_valid, st.n_emit, S)
    col = Tp + st.n_emit - 1
    pos = st.plen + st.n_emit - 1
    tok = st.last_tok
    drafts = []
    for _ in range(st.drafts.shape[1]):
        res = forward(
            dparams, dcfg, tok[:, None],
            positions=pos[:, None],
            attn_validity=active[:, None],
            cache=KVCache(k=st.draft_k, v=st.draft_v, valid=valid, length=0),
            edit_fn=_bind_edit(edit_fn, edit_params, pos[:, None]),
            compute_logits=False,
            cache_positions=torch.where(active, col, trash),
        )
        nxt = lens_argmax(params, cfg, res.last_hidden)
        tok = torch.where(active, nxt[:, 0], pad)
        drafts.append(tok)
        valid, col, pos = res.cache.valid, col + 1, pos + 1
    st.drafts.copy_(torch.stack(drafts, dim=1))


@torch.no_grad()
def verify_block(
    params: Params,
    cfg: Gemma2Config,
    st: SpecBuffers,
    edit_params: Any = None,
    *,
    edit_fn: Optional[Callable] = None,
    capture_residual_layer: Optional[int] = None,
) -> None:
    """ONE full-depth forward over the G+1 chunk ``[last_emitted, draft_1 ..
    draft_G]``, each row at its own columns, then the acceptance / emission
    / stop bookkeeping on the device, all written into ``st`` (no host
    value or sync).

    Emission follows ``greedy_decode``: every emitted token is the full
    model's argmax at its position, a stop token is kept and ends the row,
    and the budget truncates at ``max_new_tokens``.  ``st.stats`` gets the
    all-done flag and ``[emitted, accepted, drafted, active_rows]``."""
    B, Tp = st.prompt_valid.shape
    N = st.toks.shape[1] - 1
    G = st.drafts.shape[1]
    S = st.main_k.shape[2]
    device = st.drafts.device
    drafts, last_tok, n_emit, done = st.drafts, st.last_tok, st.n_emit, st.done
    active = ~done
    rows = torch.arange(B, device=device)[:, None]
    i = torch.arange(G + 1, device=device)[None, :]
    pad = torch.full_like(drafts[:, :1], chat.PAD_ID)

    chunk = torch.where(active[:, None],
                        torch.cat([last_tok[:, None], drafts], dim=1), pad)
    cols = (Tp + n_emit - 1)[:, None] + i
    safe_cols = torch.where(active[:, None], cols, S - 1)
    pos = (st.plen + n_emit - 1)[:, None] + i

    res = forward(
        params, cfg, chunk,
        positions=pos,
        attn_validity=active[:, None].expand(B, G + 1),
        cache=KVCache(k=st.main_k, v=st.main_v,
                      valid=_valid_cols(st.prompt_valid, n_emit, S), length=0),
        edit_fn=_bind_edit(edit_fn, edit_params, pos),
        carry_tap=_carry(capture_residual_layer, B, G + 1, cfg.hidden_size,
                         device),
        cache_positions=safe_cols,
        compute_logits=True,
    )
    y = torch.argmax(res.logits, dim=-1)                       # [B, G+1]

    _, m = accept_counts(drafts, y)                            # [B] accepted
    emit_i = (active[:, None] & (i <= m[:, None])
              & ((n_emit[:, None] + i) < N) & stop_free_mask(y, st.stop))
    count = emit_i.sum(dim=1)

    # Non-emitted positions all write the trash slot N (cut from the output).
    slot_cols = torch.where(emit_i, n_emit[:, None] + i, N)
    st.toks[rows, slot_cols] = torch.where(emit_i, y, pad)
    st.emit[rows, slot_cols] = emit_i
    if st.resid is not None:
        st.resid[rows, safe_cols] = res.carry_tap

    n_new = n_emit + count
    stop_emitted = (emit_i & _is_stop(y, st.stop)).any(dim=1)
    done_new = done | (active & (stop_emitted | (n_new >= N)))
    last_new = torch.gather(y, 1, (count - 1).clamp(0, G)[:, None])[:, 0]

    zero = torch.zeros_like(count)
    st.stats.copy_(torch.stack([
        done_new.all().long(),
        torch.where(active, count, zero).sum(),                    # emitted
        torch.where(active, (count - 1).clamp(min=0), zero).sum(),  # accepted
        active.long().sum() * G,                                   # drafted
        active.long().sum(),                                       # active rows
    ]))
    st.last_tok.copy_(torch.where(active & (count > 0), last_new, last_tok))
    st.n_emit.copy_(n_new)
    st.done.copy_(done_new)


@torch.no_grad()
def spec_flush(
    params: Params,
    cfg: Gemma2Config,
    st: SpecBuffers,
    edit_params: Any = None,
    *,
    edit_fn: Optional[Callable] = None,
    capture_residual_layer: int = 0,
) -> None:
    """Residual-capture tail: feed every row's FINAL emitted token once at
    full depth and capture its residual into ``st.resid``.  Vanilla feeds
    every token it records; speculation emits the bonus token without
    feeding it, so a row ending on one would miss its column.  For a row
    whose last token was fed, the re-feed recomputes the same column."""
    B, Tp = st.prompt_valid.shape
    S = st.main_k.shape[2]
    device = st.last_tok.device
    col = Tp + st.n_emit - 1
    pos = st.plen + st.n_emit - 1
    res = forward(
        params, cfg, st.last_tok[:, None],
        positions=pos[:, None],
        attn_validity=torch.ones((B, 1), dtype=torch.bool, device=device),
        cache=KVCache(k=st.main_k, v=st.main_v,
                      valid=_valid_cols(st.prompt_valid, st.n_emit, S), length=0),
        edit_fn=_bind_edit(edit_fn, edit_params, pos[:, None]),
        carry_tap=_carry(capture_residual_layer, B, 1, cfg.hidden_size, device),
        cache_positions=col,
        compute_logits=False,
    )
    st.resid[torch.arange(B, device=device), col] = res.carry_tap[:, 0]


# ---------------------------------------------------------------------------
# Host orchestration.
# ---------------------------------------------------------------------------

@torch.no_grad()
def speculative_decode(
    params: Params,
    cfg: Gemma2Config,
    prompt_ids: torch.Tensor,
    prompt_valid: torch.Tensor,
    prompt_positions: torch.Tensor,
    *,
    max_new_tokens: int,
    draft_layer: int,
    block_size: int,
    edit_fn: Optional[Callable] = None,
    edit_params: Any = None,
    stop_ids: Tuple[int, ...] = STOP_IDS,
    capture_residual_layer: Optional[int] = None,
    return_prefill_cache: bool = False,
):
    """Greedy decode by lens-head speculation, a drop-in for
    ``decode.greedy_decode`` (the same :class:`~.decode.DecodeResult`
    fields, ``prefill_cache`` as copies of their own), with a
    :class:`SpecStats`.  Prefill once (eagerly), then per block one
    :func:`draft_step` and one :func:`verify_block` until every row is done
    (each block advances every active row, so at most N blocks), then with
    a capture the :func:`spec_flush`.  The draft and the verify are
    :class:`runtime.aot.Program` s (entries ``"speculate.draft"`` and
    ``"speculate.verify"``, one CUDA graph each on the card) over one
    :class:`SpecBuffers`; the host pulls ``stats`` [5] once per block.
    Runs on the prompts' device.  Returns ``(DecodeResult, SpecStats)``."""
    from taboo_brittleness_tpu_torch.runtime import aot

    if not 0 <= draft_layer <= cfg.num_layers - 2:
        raise ValueError(
            f"draft_layer {draft_layer} must leave at least one target-only "
            f"layer (0 <= k <= {cfg.num_layers - 2})")
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")

    prompt_valid = prompt_valid.bool()
    B, Tp = prompt_ids.shape
    N, G = max_new_tokens, block_size
    device = prompt_ids.device
    capture = capture_residual_layer is not None
    stats = SpecStats(rows=B)
    registry = aot.enabled()
    st = _spec_buffers(cfg, B, Tp, N, G, draft_layer, stop_ids, capture,
                       device, registry)
    pool_keys = ((aot.kv_pool_key(cfg, B, Tp + N + G + 1, device),
                  spec_pool_key(cfg, B, Tp, N, G, draft_layer, stop_ids,
                                capture, device)) if registry else ())
    dynamic = dict(params=params, prompt_ids=prompt_ids,
                   prompt_valid=prompt_valid, prompt_positions=prompt_positions,
                   edit_params=edit_params)
    static = dict(cfg=cfg, max_new_tokens=N, draft_layer=draft_layer,
                  block_size=G, edit_fn=edit_fn, stop_ids=stop_ids,
                  capture_residual_layer=capture_residual_layer)

    def program(name: str, step: Callable) -> "aot.Program":
        def make() -> "aot.Program":
            ep = aot.static_copy(edit_params)
            return aot.Program(lambda p: step(p, ep), ep, pool_keys)

        prog = aot.lookup(name, speculative_decode, dynamic, static,
                          params=params, device=device, make=make)
        aot.copy_into(prog.state, edit_params)
        return prog

    # A capture's warm-up blocks run over whatever the state holds (every
    # index stays in range); the prefill lays the launch's state down after.
    draft = program("speculate.draft", lambda p, ep: draft_step(
        p, cfg, st, ep, draft_layer=draft_layer, edit_fn=edit_fn))
    verify = program("speculate.verify", lambda p, ep: verify_block(
        p, cfg, st, ep, edit_fn=edit_fn,
        capture_residual_layer=capture_residual_layer))
    spec_prefill(params, cfg, st, prompt_ids, prompt_valid, prompt_positions,
                 edit_params, draft_layer=draft_layer, edit_fn=edit_fn,
                 capture_residual_layer=capture_residual_layer)
    drain_seen = False
    for block in range(N):
        if not drain_seen and supervise.drain_requested():
            # Drain is word-granular: this decode finishes exactly and the
            # sweep's between-word poll exits 75; the event marks where the
            # notice landed.
            drain_seen = True
            obs.event("speculate.drain_observed", block=block)
        draft.run(params)
        resilience.fire("speculate.verify", block=block, rows=B)
        verify.run(params)
        # The block's one host pull: the all-done flag and the 4 counters.
        flag, emitted, accepted, drafted, active_rows = st.stats.tolist()
        stats.blocks += 1
        stats.emitted += emitted
        stats.accepted += accepted
        stats.drafted += drafted
        stats.blocks_rows += active_rows
        if flag:
            break

    if capture:
        spec_flush(params, cfg, st, edit_params, edit_fn=edit_fn,
                   capture_residual_layer=capture_residual_layer)

    tokens = st.toks[:, :N].clone()
    emitted = st.emit[:, :N].clone()
    prefill_cache = None
    if return_prefill_cache:
        keep = max(Tp - 1, 0)
        prefill_cache = (st.main_k[:, :, :keep].clone(),
                         st.main_v[:, :, :keep].clone(),
                         prompt_valid[:, :keep].clone())
    result = DecodeResult(
        tokens=tokens,
        lengths=emitted.sum(dim=1),
        sequences=torch.cat([prompt_ids.long(), tokens], dim=1),
        sequence_valid=torch.cat([prompt_valid, emitted], dim=1),
        residual=st.resid[:, :Tp + N].clone() if capture else None,
        prefill_cache=prefill_cache,
    )
    return result, stats
