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
of ``runtime.resilience``) fires before each verify.  Unlike the JAX
package there is no AOT registry, drain poll, ``obs`` span, profiler
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
from taboo_brittleness_tpu_torch.ops.lens import lens_argmax, residual_carry_tap
from taboo_brittleness_tpu_torch.runtime import chat, resilience
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


def _is_stop(tok: torch.Tensor, stop_ids: Tuple[int, ...]) -> torch.Tensor:
    stop = torch.tensor(stop_ids, dtype=tok.dtype, device=tok.device)
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


def accept_counts(drafts: torch.Tensor,
                  y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``match[b, j]`` = draft j equals the full model's argmax at its
    position (``y[:, :G]``); ``m[b]`` = length of the accepted prefix.
    Returns ``(match [B, G], m [B])``."""
    match = drafts == y[..., :drafts.shape[-1]]
    m = torch.cumprod(match.long(), dim=-1).sum(dim=-1)
    return match, m


def stop_free_mask(toks: torch.Tensor,
                   stop_ids: Tuple[int, ...]) -> torch.Tensor:
    """[B, W] emission gate: position i is emittable iff no stop id precedes
    it (the stop token itself is kept, as in ``greedy_decode``)."""
    st = _is_stop(toks, stop_ids)
    head = torch.ones_like(st[:, :1])
    return torch.cat([head, torch.cumprod((~st[:, :-1]).long(), dim=1).bool()],
                     dim=1)


# ---------------------------------------------------------------------------
# The block programs and the capture flush.
# ---------------------------------------------------------------------------

class SpecState(NamedTuple):
    """Device state threaded through the block loop."""

    main_k: torch.Tensor    # [L, B, S, Kh, Dh] full-depth KV
    main_v: torch.Tensor
    draft_k: torch.Tensor   # [k+1, B, S, Kh, Dh] the draft's own KV
    draft_v: torch.Tensor
    toks: torch.Tensor      # [B, N+1] emitted tokens (slot N = trash)
    emit: torch.Tensor      # [B, N+1] bool
    resid: Optional[torch.Tensor]  # [B, S, D] f32 captured residual
    last_tok: torch.Tensor  # [B] last emitted token (next block's first)
    n_emit: torch.Tensor    # [B] tokens emitted so far
    done: torch.Tensor      # [B] row finished (stop emitted or budget out)
    plen: torch.Tensor      # [B] real prompt lengths (RoPE base)


def _carry(capture_layer: Optional[int], B: int, T: int, D: int, device):
    if capture_layer is None:
        return None
    return residual_carry_tap(B, T, D, capture_layer, device=device)


@torch.no_grad()
def spec_prefill(
    params: Params,
    cfg: Gemma2Config,
    prompt_ids: torch.Tensor,        # [B, Tp] left-padded
    prompt_valid: torch.Tensor,      # [B, Tp] bool
    prompt_positions: torch.Tensor,  # [B, Tp]
    edit_params: Any = None,
    *,
    max_new_tokens: int,
    block_size: int,
    draft_layer: int,
    edit_fn: Optional[Callable] = None,
    stop_ids: Tuple[int, ...] = STOP_IDS,
    capture_residual_layer: Optional[int] = None,
) -> SpecState:
    """Full-depth prefill into the speculative cache, the first token (slot
    0, as ``greedy_decode`` records it), and the draft cache: a CLONE of the
    prefill KV at layers 0..k (the draft would compute the same K/V for the
    prompt; a view would share storage with the main cache, which forwards
    write in place).

    Cache width is ``Tp + N + G + 1``: room for the deepest verify chunk a
    last block can write, plus one never-valid TRASH column at the end where
    finished rows' writes go.  The prefill writes through a view of the
    first ``Tp + N`` columns, the width ``greedy_decode`` gives it, so its
    attention has vanilla's shape and rounding."""
    B, Tp = prompt_ids.shape
    N, G = max_new_tokens, block_size
    S = Tp + N + G + 1
    device = prompt_ids.device
    cache = KVCache.zeros(cfg, B, S, device=device)
    prefill = forward(
        params, cfg, prompt_ids,
        positions=prompt_positions,
        attn_validity=prompt_valid,
        cache=KVCache(k=cache.k[:, :, :Tp + N], v=cache.v[:, :, :Tp + N],
                      valid=cache.valid[:, :Tp + N], length=0),
        edit_fn=_bind_edit(edit_fn, edit_params, prompt_positions),
        carry_tap=_carry(capture_residual_layer, B, Tp, cfg.hidden_size, device),
        compute_logits=False,
    )
    first_tok = torch.argmax(
        unembed(params, cfg, prefill.last_hidden[:, -1:])[:, 0], dim=-1)

    toks = torch.full((B, N + 1), chat.PAD_ID, dtype=torch.long, device=device)
    emit = torch.zeros((B, N + 1), dtype=torch.bool, device=device)
    toks[:, 0] = first_tok
    emit[:, 0] = True
    done = _is_stop(first_tok, stop_ids) | (N <= 1)

    resid = None
    if capture_residual_layer is not None:
        resid = torch.zeros((B, S, cfg.hidden_size), dtype=torch.float32,
                            device=device)
        resid[:, :Tp] = prefill.carry_tap

    return SpecState(
        main_k=cache.k, main_v=cache.v,
        draft_k=cache.k[:draft_layer + 1].clone(),
        draft_v=cache.v[:draft_layer + 1].clone(),
        toks=toks, emit=emit, resid=resid,
        last_tok=first_tok,
        n_emit=torch.ones((B,), dtype=torch.long, device=device),
        done=done,
        plen=prompt_valid.sum(dim=1),
    )


@torch.no_grad()
def draft_step(
    params: Params,
    cfg: Gemma2Config,
    draft_k: torch.Tensor,
    draft_v: torch.Tensor,
    prompt_valid: torch.Tensor,
    last_tok: torch.Tensor,
    n_emit: torch.Tensor,
    done: torch.Tensor,
    plen: torch.Tensor,
    edit_params: Any = None,
    *,
    draft_layer: int,
    block_size: int,
    edit_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draft G tokens autoregressively from the layer-k lens head: G
    single-token forwards over layers 0..k writing the draft's own KV (in
    place), each next token the lens argmax.  No host sync.  Returns
    ``(draft_k, draft_v, drafts [B, G])``.

    The draft only picks WHICH tokens are verified together; nothing it
    computes reaches an emitted token.  It feeds ``last_tok, d_1 ..
    d_{G-1}``: when a block accepts all G drafts, ``d_G``'s column of the
    draft cache is valid in the next block but never written (zeros), as
    in the JAX package — this moves the acceptance rate only."""
    Tp = prompt_valid.shape[1]
    S = draft_k.shape[2]
    trash = S - 1
    dcfg = cfg.replace(num_layers=draft_layer + 1)
    dparams = _draft_view(params, draft_layer)
    active = ~done
    pad = torch.full_like(last_tok, chat.PAD_ID)

    valid = _valid_cols(prompt_valid, n_emit, S)
    col = Tp + n_emit - 1
    pos = plen + n_emit - 1
    tok = last_tok
    drafts = []
    for _ in range(block_size):
        res = forward(
            dparams, dcfg, tok[:, None],
            positions=pos[:, None],
            attn_validity=active[:, None],
            cache=KVCache(k=draft_k, v=draft_v, valid=valid, length=0),
            edit_fn=_bind_edit(edit_fn, edit_params, pos[:, None]),
            compute_logits=False,
            cache_positions=torch.where(active, col, trash),
        )
        nxt = lens_argmax(params, cfg, res.last_hidden)
        tok = torch.where(active, nxt[:, 0], pad)
        drafts.append(tok)
        valid, col, pos = res.cache.valid, col + 1, pos + 1
    return draft_k, draft_v, torch.stack(drafts, dim=1)


@torch.no_grad()
def verify_block(
    params: Params,
    cfg: Gemma2Config,
    main_k: torch.Tensor,
    main_v: torch.Tensor,
    prompt_valid: torch.Tensor,
    toks: torch.Tensor,
    emit: torch.Tensor,
    resid: Optional[torch.Tensor],
    last_tok: torch.Tensor,
    n_emit: torch.Tensor,
    done: torch.Tensor,
    plen: torch.Tensor,
    drafts: torch.Tensor,            # [B, G]
    edit_params: Any = None,
    *,
    max_new_tokens: int,
    block_size: int,
    edit_fn: Optional[Callable] = None,
    stop_ids: Tuple[int, ...] = STOP_IDS,
    capture_residual_layer: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """ONE full-depth forward over the G+1 chunk ``[last_emitted, draft_1 ..
    draft_G]``, each row at its own columns, then the acceptance / emission
    / stop bookkeeping on the device.

    Emission follows ``greedy_decode``: every emitted token is the full
    model's argmax at its position, a stop token is kept and ends the row,
    and the budget truncates at ``max_new_tokens``.  ``main_k``, ``main_v``,
    ``toks``, ``emit`` and ``resid`` are written in place.

    Returns ``(main_k, main_v, toks, emit, resid, last_tok, n_emit, done,
    all_done, stats)``; ``stats`` is the [4] vector ``[emitted, accepted,
    drafted, active_rows]``."""
    B, Tp = prompt_valid.shape
    N, G = max_new_tokens, block_size
    S = main_k.shape[2]
    device = drafts.device
    active = ~done
    rows = torch.arange(B, device=device)[:, None]
    i = torch.arange(G + 1, device=device)[None, :]
    pad = torch.full_like(drafts[:, :1], chat.PAD_ID)

    chunk = torch.where(active[:, None],
                        torch.cat([last_tok[:, None], drafts], dim=1), pad)
    cols = (Tp + n_emit - 1)[:, None] + i
    safe_cols = torch.where(active[:, None], cols, S - 1)
    pos = (plen + n_emit - 1)[:, None] + i

    res = forward(
        params, cfg, chunk,
        positions=pos,
        attn_validity=active[:, None].expand(B, G + 1),
        cache=KVCache(k=main_k, v=main_v,
                      valid=_valid_cols(prompt_valid, n_emit, S), length=0),
        edit_fn=_bind_edit(edit_fn, edit_params, pos),
        carry_tap=_carry(capture_residual_layer, B, G + 1, cfg.hidden_size,
                         device),
        cache_positions=safe_cols,
        compute_logits=True,
    )
    y = torch.argmax(res.logits, dim=-1)                       # [B, G+1]

    _, m = accept_counts(drafts, y)                            # [B] accepted
    emit_i = (active[:, None] & (i <= m[:, None])
              & ((n_emit[:, None] + i) < N) & stop_free_mask(y, stop_ids))
    count = emit_i.sum(dim=1)

    # Non-emitted positions all write the trash slot N (cut from the output).
    slot_cols = torch.where(emit_i, n_emit[:, None] + i, N)
    toks[rows, slot_cols] = torch.where(emit_i, y, pad)
    emit[rows, slot_cols] = emit_i
    if resid is not None:
        resid[rows, safe_cols] = res.carry_tap

    n_new = n_emit + count
    stop_emitted = (emit_i & _is_stop(y, stop_ids)).any(dim=1)
    done_new = done | (active & (stop_emitted | (n_new >= N)))
    last_new = torch.gather(y, 1, (count - 1).clamp(0, G)[:, None])[:, 0]
    last_tok = torch.where(active & (count > 0), last_new, last_tok)

    zero = torch.zeros_like(count)
    stats = torch.stack([
        torch.where(active, count, zero).sum(),                    # emitted
        torch.where(active, (count - 1).clamp(min=0), zero).sum(),  # accepted
        active.long().sum() * G,                                   # drafted
        active.long().sum(),                                       # active rows
    ])
    return (main_k, main_v, toks, emit, resid, last_tok, n_new, done_new,
            done_new.all(), stats)


@torch.no_grad()
def spec_flush(
    params: Params,
    cfg: Gemma2Config,
    main_k: torch.Tensor,
    main_v: torch.Tensor,
    prompt_valid: torch.Tensor,
    resid: torch.Tensor,
    last_tok: torch.Tensor,
    n_emit: torch.Tensor,
    plen: torch.Tensor,
    edit_params: Any = None,
    *,
    edit_fn: Optional[Callable] = None,
    capture_residual_layer: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual-capture tail: feed every row's FINAL emitted token once at
    full depth and capture its residual.  Vanilla feeds every token it
    records; speculation emits the bonus token without feeding it, so a row
    ending on one would miss its column.  For a row whose last token was
    fed, the re-feed recomputes the same column."""
    B, Tp = prompt_valid.shape
    S = main_k.shape[2]
    device = last_tok.device
    col = Tp + n_emit - 1
    pos = plen + n_emit - 1
    res = forward(
        params, cfg, last_tok[:, None],
        positions=pos[:, None],
        attn_validity=torch.ones((B, 1), dtype=torch.bool, device=device),
        cache=KVCache(k=main_k, v=main_v,
                      valid=_valid_cols(prompt_valid, n_emit, S), length=0),
        edit_fn=_bind_edit(edit_fn, edit_params, pos[:, None]),
        carry_tap=_carry(capture_residual_layer, B, 1, cfg.hidden_size, device),
        cache_positions=col,
        compute_logits=False,
    )
    resid[torch.arange(B, device=device), col] = res.carry_tap[:, 0]
    return main_k, main_v, resid


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
    :class:`SpecStats`.  Prefill once, then per block one
    :func:`draft_step` and one :func:`verify_block` until every row is done
    (each block advances every active row, so at most N blocks), then with
    a capture the :func:`spec_flush`.  The host pulls one [5] tensor per
    block.  Runs on the prompts' device.  Returns ``(DecodeResult,
    SpecStats)``."""
    if not 0 <= draft_layer <= cfg.num_layers - 2:
        raise ValueError(
            f"draft_layer {draft_layer} must leave at least one target-only "
            f"layer (0 <= k <= {cfg.num_layers - 2})")
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")

    prompt_valid = prompt_valid.bool()
    B, Tp = prompt_ids.shape
    N = max_new_tokens
    edit = dict(edit_fn=edit_fn)
    stats = SpecStats(rows=B)

    st = spec_prefill(
        params, cfg, prompt_ids, prompt_valid, prompt_positions, edit_params,
        max_new_tokens=N, block_size=block_size, draft_layer=draft_layer,
        stop_ids=stop_ids, capture_residual_layer=capture_residual_layer,
        **edit)
    for block in range(N):
        draft_k, draft_v, drafts = draft_step(
            params, cfg, st.draft_k, st.draft_v, prompt_valid, st.last_tok,
            st.n_emit, st.done, st.plen, edit_params,
            draft_layer=draft_layer, block_size=block_size, **edit)
        resilience.fire("speculate.verify", block=block, rows=B)
        (main_k, main_v, toks, emit, resid, last_tok, n_emit, done,
         all_done, block_stats) = verify_block(
            params, cfg, st.main_k, st.main_v, prompt_valid, st.toks, st.emit,
            st.resid, st.last_tok, st.n_emit, st.done, st.plen, drafts,
            edit_params, max_new_tokens=N, block_size=block_size,
            stop_ids=stop_ids, capture_residual_layer=capture_residual_layer,
            **edit)
        st = SpecState(main_k=main_k, main_v=main_v, draft_k=draft_k,
                       draft_v=draft_v, toks=toks, emit=emit, resid=resid,
                       last_tok=last_tok, n_emit=n_emit, done=done,
                       plen=st.plen)
        # The block's one host pull: the all-done flag and the 4 counters.
        flag, emitted, accepted, drafted, active_rows = torch.cat(
            [all_done.long()[None], block_stats]).tolist()
        stats.blocks += 1
        stats.emitted += emitted
        stats.accepted += accepted
        stats.drafted += drafted
        stats.blocks_rows += active_rows
        if flag:
            break

    if capture_residual_layer is not None:
        spec_flush(params, cfg, st.main_k, st.main_v, prompt_valid, st.resid,
                   st.last_tok, st.n_emit, st.plen, edit_params,
                   capture_residual_layer=capture_residual_layer, **edit)

    tokens = st.toks[:, :N]
    emitted = st.emit[:, :N]
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
        residual=(st.resid[:, :Tp + N]
                  if capture_residual_layer is not None else None),
        prefill_cache=prefill_cache,
    )
    return result, stats
