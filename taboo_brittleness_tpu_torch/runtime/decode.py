"""Batched greedy decoding with a KV cache.

The counterpart of the JAX package's ``runtime/decode.py``.  All prompts of a
word decode together: left-padded into one ``[B, T]`` block, one prefill, then
single-token steps over a shared KV cache until every row has emitted a stop
token or the budget is spent (finished rows emit pad, so the outputs equal
those of running out the budget).  JAX runs the steps as one compiled
``while_loop``.  Here the prefill runs eagerly and each step is one
:func:`decode_step` over static buffers, which on the card is a CUDA graph
captured once per launch key (``runtime.aot``) and replayed from a host
loop that reads the all-done flag one step late.  :func:`generate` can
route a launch through the speculative decoder (``runtime.speculate``)
instead.

Greedy argmax (first index among equal logits, as ``jnp.argmax``) makes the
token streams the JAX package's for the same weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.models.gemma2 import (
    Gemma2Config,
    KVCache,
    Params,
    forward,
    local_kv_heads,
    unembed,
)
from taboo_brittleness_tpu_torch.ops.lens import (
    residual_carry_tap,
    residual_multi_tap,
)
from taboo_brittleness_tpu_torch.parallel.mesh import vocab_mesh
from taboo_brittleness_tpu_torch.runtime import chat

STOP_IDS: Tuple[int, ...] = (chat.EOS_ID, chat.END_OF_TURN_ID)


class DecodeResult(NamedTuple):
    tokens: torch.Tensor          # [B, N] generated ids (pad after stop)
    lengths: torch.Tensor         # [B] number of real generated tokens
    # Full sequence view (prompt + generation), left-padded:
    sequences: torch.Tensor       # [B, T_prompt + N]
    sequence_valid: torch.Tensor  # [B, T_prompt + N] bool
    # With capture_residual_layer: resid_post at that layer for every
    # sequence position, f32, captured as the decode computes it.  An int
    # tap gives [B, T, D]; a tuple of taps (the grid's capture-once decode)
    # gives [K, B, T, D], slot k at layer taps[k].
    residual: Optional[torch.Tensor] = None   # [B, T_prompt + N, D] | [K, ...]
    # With return_prefill_cache: (k, v, valid) of KV columns [0, T_prompt - 1),
    # copies of their own that no later write reaches (the ΔNLL
    # continuation recomputes the last prompt column itself).
    prefill_cache: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    # With return_cache: the launch's whole KV cache (the pooled one under
    # the registry; the fused study continues its NLL over it).
    cache: Optional[KVCache] = None
    # With return_margins: top-1 minus top-2 logit behind each generated
    # token, from the decode's own logits (inf after the last step run).
    margins: Optional[torch.Tensor] = None   # [B, N] f32


def pad_prompts(
    prompt_ids: Sequence[Sequence[int]],
    *,
    pad_id: int = chat.PAD_ID,
    pad_to_multiple: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Left-pad variable-length prompts into [B, T] (ids, validity, positions).

    Left padding keeps every row's *last* prompt token in the same column,
    so each decode step reads ``logits[:, -1]`` for every row.
    ``pad_to_multiple`` rounds T up to a bucket boundary (pad columns are
    masked out of attention, so results are unchanged).
    """
    B = len(prompt_ids)
    T = max(len(p) for p in prompt_ids)
    if pad_to_multiple:
        T = -(-T // pad_to_multiple) * pad_to_multiple
    ids = np.full((B, T), pad_id, np.int32)
    valid = np.zeros((B, T), bool)
    positions = np.zeros((B, T), np.int32)
    for b, p in enumerate(prompt_ids):
        L = len(p)
        ids[b, T - L:] = p
        valid[b, T - L:] = True
        positions[b, T - L:] = np.arange(L)
    return ids, valid, positions


@dataclasses.dataclass
class StepBuffers:
    """The static buffers a decode launch steps over in place (one set per
    program; the KV cache is the launch shape's pooled one)."""

    cache: KVCache            # [L, B, T + N, Kh, Dh] k / v, [B, T + N] valid
    tok: torch.Tensor         # [B] the step's input token
    pos: torch.Tensor         # [B] its RoPE position
    done: torch.Tensor        # [B] bool: the row has emitted a stop token
    i: torch.Tensor           # [1] step counter (the device's, not the host's)
    tokens: torch.Tensor      # [B, N] generated ids
    emitted: torch.Tensor     # [B, N] bool
    all_done: torch.Tensor    # [] bool: every row done after the last step
    stop: torch.Tensor        # [S] stop ids
    # [B, N, D] f32 captured residual, or a tuple of K of them (multi-tap)
    gen_resid: Optional[Any] = None
    margins: Optional[torch.Tensor] = None    # [B, N + 1] f32 top-1 - top-2


def _step_buffers(cfg: Gemma2Config, kv: Dict[str, torch.Tensor], T: int,
                  N: int, stop_ids: Tuple[int, ...], *, capture: Any,
                  margins: bool) -> StepBuffers:
    """``capture``: None, an int tap or a tuple of K taps (K buffers)."""
    B = kv["valid"].shape[0]
    device = kv["valid"].device

    def resid() -> torch.Tensor:
        return torch.zeros((B, N, cfg.hidden_size), dtype=torch.float32,
                           device=device)

    return StepBuffers(
        cache=KVCache(k=kv["k"], v=kv["v"], valid=kv["valid"], length=T),
        tok=torch.zeros((B,), dtype=torch.long, device=device),
        pos=torch.zeros((B,), dtype=torch.long, device=device),
        done=torch.zeros((B,), dtype=torch.bool, device=device),
        i=torch.zeros((1,), dtype=torch.long, device=device),
        tokens=torch.zeros((B, N), dtype=torch.long, device=device),
        emitted=torch.zeros((B, N), dtype=torch.bool, device=device),
        all_done=torch.zeros((), dtype=torch.bool, device=device),
        stop=torch.tensor(stop_ids, dtype=torch.long, device=device),
        gen_resid=(None if capture is None
                   else tuple(resid() for _ in capture)
                   if isinstance(capture, tuple) else resid()),
        margins=(torch.zeros((B, N + 1), dtype=torch.float32, device=device)
                 if margins else None),
    )


def _carry_tap(capture: Any, B: int, T: int, D: int, device: torch.device):
    """The forward's carry tap for ``capture`` (None, an int layer or a
    tuple of layers)."""
    if capture is None:
        return None
    if isinstance(capture, tuple):
        return residual_multi_tap(B, T, D, capture, device=device)
    return residual_carry_tap(B, T, D, capture, device=device)


def normalize_capture(capture: Any) -> Any:
    """A list or tuple of tap layers as a tuple of ints (hashable: it keys
    the graph registry, where the int ``31`` and ``(31,)`` are two
    programs); duplicates raise.  An int or None passes through."""
    if isinstance(capture, (list, tuple)):
        taps = tuple(int(x) for x in capture)
        if len(set(taps)) != len(taps):
            raise ValueError(f"duplicate tap layers {taps}; each grid layer "
                             "captures exactly one slot")
        return taps
    return capture


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    """Top-1 minus top-2 of the f32 ``logits`` (``unembed``'s) per row."""
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def decode_step(params: Params, cfg: Gemma2Config, b: StepBuffers,
                edit_fn: Optional[Callable], edit_params: Any,
                capture_residual_layer: Any) -> None:
    """One greedy step over ``b``, written in place: the forward of each
    row's token at column ``T + i``, the next token, the stop latch, and
    the outputs at column ``i``.  No host value, no host sync, nothing
    sliced at a host integer: the same code runs eagerly and under CUDA
    graph capture.

    A step after every row stopped (the host reads the all-done flag one
    step late) writes pad and ``emitted=False`` where those already are,
    and leaves the residual and margin columns untouched: they stay zero
    (inf), as when the loop exits at once."""
    B, N = b.tokens.shape
    T = b.cache.length
    # The counter saturates at the last column: a capture's warm-up steps
    # run past it on a program's fresh buffers when N is 1.
    i = b.i.clamp(max=N - 1)
    active_any = ~b.done.all()
    pos = b.pos[:, None]
    res = forward(
        params, cfg, b.tok[:, None],
        positions=pos,
        attn_validity=(~b.done)[:, None],
        cache=b.cache,
        edit_fn=_bind(edit_fn, edit_params, pos),
        carry_tap=_carry_tap(capture_residual_layer, B, 1, cfg.hidden_size,
                             b.tok.device),
        cache_positions=(i + T).expand(B),
        valid_in_place=True,
    )
    logits = res.logits[:, 0]
    pad = torch.full_like(b.tok, chat.PAD_ID)
    next_done = b.done | (b.tok[:, None] == b.stop).any(dim=-1)
    next_tok = torch.where(next_done, pad, torch.argmax(logits, dim=-1))
    emitted_now = ~b.done
    b.tokens.index_copy_(1, i, torch.where(emitted_now, b.tok, pad)[:, None])
    b.emitted.index_copy_(1, i, emitted_now[:, None])
    if b.gen_resid is not None:
        multi = isinstance(b.gen_resid, tuple)
        for buf, tap in zip(b.gen_resid if multi else (b.gen_resid,),
                            res.carry_tap if multi else (res.carry_tap,)):
            buf.index_copy_(1, i, torch.where(
                active_any, tap, buf.index_select(1, i)))
    if b.margins is not None:
        col = i + 1
        b.margins.index_copy_(1, col, torch.where(
            active_any, _top2_gap(logits)[:, None], b.margins.index_select(1, col)))
    b.tok.copy_(next_tok)
    b.done.copy_(next_done)
    b.pos.add_(1)
    b.i.add_(1)
    b.all_done.copy_(next_done.all())


class _LaggedFlag:
    """The all-done flag as the host reads it: on the card, copied to
    pinned memory after each step and read one step late (the host never
    waits on the step in flight); on the CPU, read at once."""

    def __init__(self, flag: torch.Tensor) -> None:
        self.flag = flag
        self.cuda = flag.device.type == "cuda"
        if self.cuda:
            self.host = torch.zeros((2,), dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event(), torch.cuda.Event()]

    def after_step(self, i: int) -> None:
        if self.cuda:
            self.host[i % 2].copy_(self.flag, non_blocking=True)
            self.events[i % 2].record()

    def stop_before(self, i: int) -> bool:
        """Whether step ``i`` can be skipped: every row was done after step
        ``i - 2`` (card) or ``i - 1`` (CPU)."""
        if not self.cuda:
            return i >= 1 and bool(self.flag)
        if i < 2:
            return False
        self.events[i % 2].synchronize()
        return bool(self.host[i % 2])


@torch.no_grad()
def greedy_decode(
    params: Params,
    cfg: Gemma2Config,
    prompt_ids: torch.Tensor,        # [B, T] left-padded
    prompt_valid: torch.Tensor,      # [B, T] bool
    prompt_positions: torch.Tensor,  # [B, T]
    *,
    max_new_tokens: int,
    edit_fn: Optional[Callable] = None,
    edit_params: Any = None,
    stop_ids: Tuple[int, ...] = STOP_IDS,
    capture_residual_layer: Any = None,
    return_prefill_cache: bool = False,
    return_cache: bool = False,
    return_margins: bool = False,
) -> DecodeResult:
    """Prefill + up to ``max_new_tokens`` greedy steps.

    A row that emits any of ``stop_ids`` keeps that token and emits pad
    afterwards.  ``capture_residual_layer`` captures that layer's
    (post-edit) resid_post for every position as the decode computes it:
    prefill columns from the prefill's carry tap, each generated column from
    its step (columns of steps after every row stopped stay zero).  A
    list or tuple of layers captures each (``ops.lens.residual_multi_tap``)
    into a ``[K, B, T, D]`` residual, slot k at ``taps[k]`` and bit-equal to
    a single-tap capture there (each of its K buffers follows the same
    rule); the tuple is a static of the program's key.

    ``edit_fn(h, layer_idx)`` rewrites the residual stream in the prefill
    and in every step.  With ``edit_params`` it is called as ``edit_fn(h,
    layer_idx, edit_params)``; a dict of edit params gains
    ``chunk_positions``, the current chunk's RoPE positions (the prompt
    positions in the prefill, ``pos[:, None]`` in each step), which
    spike-masked edits match against.
    ``return_prefill_cache`` returns KV columns ``[0, T - 1)`` as
    :attr:`DecodeResult.prefill_cache`.  ``return_margins`` returns each
    generated token's top-1 minus top-2 logit (inf after the last step run)
    as :attr:`DecodeResult.margins`.

    The prefill runs eagerly; the steps are a :class:`runtime.aot.Program`
    (entry ``"decode"``): on the card a CUDA graph replayed once per step,
    on the CPU or with ``TBX_AOT=0`` the same :func:`decode_step` called
    eagerly.  The host reads the all-done flag one step late, so at most
    one step more than needed runs; its writes change nothing.  With the
    registry on, a launch recycles its shape's pooled KV block, which it
    first resets to decode exactly as over a fresh one.  Every returned
    tensor is the caller's own, except ``cache`` (``return_cache``: the
    launch's whole KV cache, which the next launch of this shape
    overwrites).
    """
    from taboo_brittleness_tpu_torch.runtime import aot

    B, T = prompt_ids.shape
    device = prompt_ids.device
    N = max_new_tokens
    width = T + N
    capture_residual_layer = normalize_capture(capture_residual_layer)
    capture = capture_residual_layer is not None
    multi_tap = isinstance(capture_residual_layer, tuple)

    heads = local_kv_heads(params, cfg)

    def make() -> "aot.Program":
        kv = (aot.pooled_kv if aot.enabled() else aot.fresh_kv)(
            cfg, B, width, device, heads=heads)
        bufs = _step_buffers(cfg, kv, T, N, stop_ids,
                             capture=capture_residual_layer,
                             margins=return_margins)
        ep = aot.static_copy(edit_params)
        return aot.Program(
            lambda p: decode_step(p, cfg, bufs, edit_fn, ep,
                                  capture_residual_layer),
            (bufs, ep), (aot.kv_pool_key(cfg, B, width, device, heads=heads),))

    # No step to run (or capture) without a budget.
    prog = make() if N == 0 else aot.lookup(
        "decode", greedy_decode,
        dict(params=params, prompt_ids=prompt_ids, prompt_valid=prompt_valid,
             prompt_positions=prompt_positions, edit_params=edit_params),
        dict(cfg=cfg, max_new_tokens=N, edit_fn=edit_fn, stop_ids=stop_ids,
             capture_residual_layer=capture_residual_layer,
             return_margins=return_margins),
        params=params, device=device, make=make,
        mesh=vocab_mesh(params, cfg))
    b, ep = prog.state
    aot.copy_into(ep, edit_params)

    # The prefill writes columns [0, T) of the cache.  A recycled cache's
    # stale occupancy goes first, and its K/V past the prompt are zeroed: a
    # finished row's query can run out of its sliding window, attend
    # uniformly over every column, and so read them.
    b.cache.valid.zero_()
    b.cache.k[:, :, T:] = 0
    b.cache.v[:, :, T:] = 0
    prefill = forward(
        params, cfg, prompt_ids,
        positions=prompt_positions,
        attn_validity=prompt_valid,
        cache=KVCache(k=b.cache.k, v=b.cache.v, valid=b.cache.valid, length=0),
        edit_fn=_bind(edit_fn, edit_params, prompt_positions),
        carry_tap=_carry_tap(capture_residual_layer, B, T, cfg.hidden_size,
                             device),
        compute_logits=False,  # only the last column is sampled
        valid_in_place=True,
    )
    last_logits = unembed(params, cfg, prefill.last_hidden[:, -1:])[:, 0]
    b.tok.copy_(torch.argmax(last_logits, dim=-1))
    b.pos.copy_(prompt_valid.sum(dim=1))
    b.done.zero_()
    b.i.zero_()
    b.tokens.fill_(chat.PAD_ID)
    b.emitted.zero_()
    b.all_done.zero_()
    for buf in (b.gen_resid if multi_tap else (b.gen_resid,) if capture
                else ()):
        buf.zero_()
    if return_margins:
        b.margins.fill_(float("inf"))
        b.margins[:, 0] = _top2_gap(last_logits)

    flag = _LaggedFlag(b.all_done)
    for i in range(N):
        if flag.stop_before(i):
            break
        prog.run(params)
        flag.after_step(i)

    prefill_cache = None
    if return_prefill_cache:
        # Steps wrote columns >= T only; the caller gets copies of its own
        # (the next launch of this shape writes the cache again).
        keep = max(T - 1, 0)
        prefill_cache = (b.cache.k[:, :, :keep].clone(),
                         b.cache.v[:, :, :keep].clone(),
                         b.cache.valid[:, :keep].clone())

    residual = None
    if multi_tap:
        # [K, B, T + N, D]: each slot's prompt and generated columns, stacked
        # (copies of the bits, so each slot equals the int form's capture).
        residual = torch.stack([torch.cat([p, g], dim=1) for p, g in
                                zip(prefill.carry_tap, b.gen_resid)])
    elif capture:
        # Column T + i holds step i's input token, where `sequences` puts it.
        residual = torch.cat([prefill.carry_tap, b.gen_resid], dim=1)
    tokens = b.tokens.clone()
    emitted = b.emitted.clone()
    return DecodeResult(
        tokens=tokens,
        lengths=emitted.sum(dim=1),
        sequences=torch.cat([prompt_ids.long(), tokens], dim=1),
        sequence_valid=torch.cat([prompt_valid, emitted], dim=1),
        residual=residual,
        prefill_cache=prefill_cache,
        cache=b.cache if return_cache else None,
        margins=b.margins[:, :N].clone() if return_margins else None,
    )


def _bind(edit_fn: Optional[Callable], edit_params: Any,
          chunk_positions: torch.Tensor) -> Optional[Callable]:
    """The edit as the forward calls it: ``edit_fn(h, idx, ep)`` with a dict
    of edit params given the chunk's RoPE positions."""
    if edit_fn is None or edit_params is None:
        return edit_fn
    ep = with_chunk_positions(edit_params, chunk_positions)
    return lambda h, idx: edit_fn(h, idx, ep)


def with_chunk_positions(edit_params: Any, chunk_positions: torch.Tensor) -> Any:
    """A dict of edit params with ``chunk_positions`` set (position-aware
    edits read the current chunk's RoPE positions there); anything else
    passes through."""
    if isinstance(edit_params, dict):
        return {**edit_params, "chunk_positions": chunk_positions}
    return edit_params


class ResponseLayout(NamedTuple):
    """View of a batched decode used by every analysis pipeline.  Arrays are
    numpy (:func:`response_layout`) or torch tensors on the decode's device
    (:func:`response_layout_device`) — same fields."""

    sequences: Any             # [B, T] full ids (left-padded prompt + generation)
    valid: Any                 # [B, T] bool: real tokens (prompt or generated)
    positions: Any             # [B, T] RoPE positions (cumsum of valid - 1)
    prompt_len: int            # number of prompt columns (T - max_new_tokens)
    response_mask: Any         # [B, T] generated tokens, stop ids excluded


def response_layout(result: DecodeResult) -> ResponseLayout:
    """(positions, response mask, ...) of a DecodeResult as host numpy."""
    seqs = result.sequences.cpu().numpy().astype(np.int32)
    valid = result.sequence_valid.cpu().numpy()
    toks = result.tokens.cpu().numpy()
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    prompt_len = seqs.shape[1] - toks.shape[1]
    resp = np.zeros_like(valid)
    resp[:, prompt_len:] = (toks != chat.PAD_ID) & ~np.isin(toks, STOP_IDS)
    return ResponseLayout(sequences=seqs, valid=valid, positions=positions,
                          prompt_len=prompt_len, response_mask=resp)


def response_layout_device(result: DecodeResult) -> ResponseLayout:
    """:func:`response_layout` in torch ops on the decode's device, so the
    lens pass can follow the decode without a copy to the host."""
    seqs, valid, toks = result.sequences, result.sequence_valid, result.tokens
    positions = (torch.cumsum(valid.long(), dim=1) - 1).clamp(min=0)
    prompt_len = seqs.shape[1] - toks.shape[1]
    stop = torch.tensor(STOP_IDS, dtype=toks.dtype, device=toks.device)
    resp = torch.zeros_like(valid)
    resp[:, prompt_len:] = (toks != chat.PAD_ID) & ~torch.isin(toks, stop)
    return ResponseLayout(sequences=seqs, valid=valid, positions=positions,
                          prompt_len=prompt_len, response_mask=resp)


def texts_from_tokens(tok, tokens: np.ndarray, lengths: np.ndarray) -> List[str]:
    """Decode generated ids to text (stop token included, as the reference's
    ``<end_of_turn>``-terminated response_text)."""
    rows = [tokens[b, : lengths[b]].tolist() for b in range(tokens.shape[0])]
    bd = getattr(tok, "batch_decode", None)
    return bd(rows) if bd is not None else [tok.decode(r) for r in rows]


def decode_texts(tok, result: DecodeResult) -> List[str]:
    """:func:`texts_from_tokens` over a DecodeResult."""
    return texts_from_tokens(tok, result.tokens.cpu().numpy(),
                             result.lengths.cpu().numpy())


def encode_prompts(
    tok,
    prompts: Sequence[str],
    *,
    prefills: Optional[Sequence[Optional[str]]] = None,
    pad_to_multiple: Optional[int] = None,
    rendered: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[List[int]]]:
    """Chat-format + tokenize + left-pad a prompt batch.  Returns (ids,
    valid, positions, per-row token id lists).

    Each prompt becomes one user turn; ``prefills[b]``, when set, opens the
    model turn of row b with that text.  ``rendered=True`` takes ``prompts``
    as already chat-templated strings (multi-turn dialogues, forcing
    prefills) and formats nothing; it refuses ``prefills``."""
    if rendered:
        if prefills is not None:
            raise ValueError(
                "prefills are a chat-formatting feature; with rendered=True "
                "bake the prefill into the rendered string instead")
        rendered_rows = list(prompts)
    else:
        rendered_rows = []
        for i, p in enumerate(prompts):
            prefill = prefills[i] if prefills is not None else None
            rendered_rows.append(
                chat.render_chat([chat.Turn("user", p)], prefill=prefill)
                if prefill is not None
                else chat.user_prompt(p))
    ids = [tok.encode(r) for r in rendered_rows]
    padded, valid, positions = pad_prompts(ids, pad_to_multiple=pad_to_multiple)
    return padded, valid, positions, ids


def generate(
    params: Params,
    cfg: Gemma2Config,
    tok,
    prompts: Sequence[str],
    *,
    max_new_tokens: int = 50,
    edit_fn: Optional[Callable] = None,
    edit_params: Any = None,
    prefills: Optional[Sequence[Optional[str]]] = None,
    pad_to_multiple: Optional[int] = None,
    capture_residual_layer: Any = None,
    return_texts: bool = True,
    return_prefill_cache: bool = False,
    rendered: bool = False,
) -> Tuple[DecodeResult, Optional[List[str]], List[List[int]]]:
    """Chat-format, tokenize, batch-decode on the params' device.  Returns
    (result, response_texts or None, per-row prompt ids); the response text
    is the generation only (``full_text`` gives the reference's form).
    ``prefills`` and ``rendered`` go to :func:`encode_prompts`; the edit and
    prefill-cache arguments to :func:`greedy_decode`.

    Fires the ``decode.launch`` fault site; decodes through
    :func:`dispatch_decode`, counted in the ``decode.launches`` and
    ``decode.rows`` obs counters.  A greedy launch rides a ``decode``
    program span (host-side enqueue, and the all-done flag reads; device
    time shows up in whichever span later blocks) whose id the launch's
    profiler annotation carries; a speculative one the speculative
    decoder's own."""
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
    from taboo_brittleness_tpu_torch.runtime import resilience

    resilience.fire("decode.launch", rows=len(prompts))
    capture_residual_layer = normalize_capture(capture_residual_layer)
    padded, valid, positions, ids = encode_prompts(
        tok, prompts, prefills=prefills, pad_to_multiple=pad_to_multiple,
        rendered=rendered)
    obs_metrics.counter("decode.launches").inc()
    obs_metrics.counter("decode.rows").inc(len(prompts))
    span = (contextlib.nullcontext() if speculates(capture_residual_layer)
            else obs.span("decode", kind="program", rows=len(prompts),
                          cols=int(padded.shape[1]),
                          new_tokens=max_new_tokens, fn="greedy_decode"))
    with span:
        result = dispatch_decode(
            params, cfg, padded, valid, positions,
            max_new_tokens=max_new_tokens, edit_fn=edit_fn,
            edit_params=edit_params,
            capture_residual_layer=capture_residual_layer,
            return_prefill_cache=return_prefill_cache)
    texts = decode_texts(tok, result) if return_texts else None
    return result, texts, ids


def dispatch_decode(params: Params, cfg: Gemma2Config, padded: np.ndarray,
                    valid: np.ndarray, positions: np.ndarray,
                    **kw) -> DecodeResult:
    """One batched decode of host-padded prompts on the params' device:
    :func:`greedy_decode`, or with ``TBX_SPECULATE=1``
    ``runtime.speculate.speculative_decode`` at ``resolve_plan(cfg)`` (the
    same greedy stream; a residual-capturing launch only with
    ``TBX_SPECULATE_CAPTURE=1`` as well, and a multi-tap one never: the
    speculative decoder captures one layer).  ``kw`` goes to the decoder.
    Either steps through its graphs in ``runtime.aot``; a greedy launch
    under the profiler annotation ``decode`` (the caller's span's id)."""
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.runtime import speculate

    device = params["embed"].device
    args = (torch.from_numpy(padded).long().to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(positions).long().to(device))
    if speculates(kw.get("capture_residual_layer")):
        plan = speculate.resolve_plan(cfg)
        result, _stats = speculate.speculative_decode(
            params, cfg, *args, draft_layer=plan.draft_layer,
            block_size=plan.block_size, **kw)
        return result
    with obs.profile.annotate("decode", fn=greedy_decode):
        return greedy_decode(params, cfg, *args, **kw)


def speculates(capture: Any) -> bool:
    """Whether :func:`dispatch_decode` takes the speculative decoder for a
    launch capturing ``capture`` (never for a multi-tap one)."""
    from taboo_brittleness_tpu_torch.runtime import speculate

    from taboo_brittleness_tpu_torch.parallel.mesh import active

    mesh = active()
    return (not isinstance(capture, (list, tuple))
            and speculate.should_speculate(
                capture=capture is not None,
                mesh_sharded=mesh is not None and mesh.size > 1))


def full_text(tok, prompt_ids: Sequence[int], result: DecodeResult, row: int) -> str:
    """Reference-shaped full output: decode(prompt + generation), truncated
    at the second <end_of_turn> (reference src/models.py:81-92)."""
    n = int(result.lengths[row])
    gen = result.tokens[row, :n].cpu().tolist()
    return chat.truncate_second_end_of_turn(tok.decode(list(prompt_ids) + gen))
