"""Batched greedy decoding with a KV cache.

The counterpart of the JAX package's ``runtime/decode.py``.  All prompts of a
word decode together: left-padded into one ``[B, T]`` block, one prefill, then
single-token steps over a shared KV cache until every row has emitted a stop
token or the budget is spent (finished rows emit pad, so the outputs equal
those of running out the budget).  JAX runs the steps as one compiled
``while_loop``; here it is a Python loop that checks ``done.all()`` once per
step.  :func:`generate` can route a launch through the speculative decoder
(``runtime.speculate``) instead.

Greedy argmax (first index among equal logits, as ``jnp.argmax``) makes the
token streams the JAX package's for the same weights.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.models.gemma2 import (
    Gemma2Config,
    KVCache,
    Params,
    forward,
    unembed,
)
from taboo_brittleness_tpu_torch.ops.lens import residual_carry_tap
from taboo_brittleness_tpu_torch.runtime import chat

STOP_IDS: Tuple[int, ...] = (chat.EOS_ID, chat.END_OF_TURN_ID)


class DecodeResult(NamedTuple):
    tokens: torch.Tensor          # [B, N] generated ids (pad after stop)
    lengths: torch.Tensor         # [B] number of real generated tokens
    # Full sequence view (prompt + generation), left-padded:
    sequences: torch.Tensor       # [B, T_prompt + N]
    sequence_valid: torch.Tensor  # [B, T_prompt + N] bool
    # With capture_residual_layer: resid_post at that layer for every
    # sequence position, f32, captured as the decode computes it.
    residual: Optional[torch.Tensor] = None   # [B, T_prompt + N, D]
    # With return_prefill_cache: (k, v, valid) of KV columns [0, T_prompt - 1),
    # copies of their own that no later write reaches (the ΔNLL
    # continuation recomputes the last prompt column itself).
    prefill_cache: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


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
    capture_residual_layer: Optional[int] = None,
    return_prefill_cache: bool = False,
) -> DecodeResult:
    """Prefill + up to ``max_new_tokens`` greedy steps.

    A row that emits any of ``stop_ids`` keeps that token and emits pad
    afterwards.  ``capture_residual_layer`` captures that layer's
    (post-edit) resid_post for every position as the decode computes it:
    prefill columns from the prefill's carry tap, each generated column from
    its step (columns of steps skipped by the early exit stay zero).

    ``edit_fn(h, layer_idx)`` rewrites the residual stream in the prefill
    and in every step.  With ``edit_params`` it is called as ``edit_fn(h,
    layer_idx, edit_params)``; a dict of edit params gains
    ``chunk_positions``, the current chunk's RoPE positions (the prompt
    positions in the prefill, ``pos[:, None]`` in each step), which
    spike-masked edits match against.
    ``return_prefill_cache`` returns KV columns ``[0, T - 1)`` as
    :attr:`DecodeResult.prefill_cache`.
    """
    B, T = prompt_ids.shape
    device = prompt_ids.device
    D = cfg.hidden_size
    N = max_new_tokens
    capture = capture_residual_layer is not None

    def carry(chunk: int):
        if not capture:
            return None
        return residual_carry_tap(B, chunk, D, capture_residual_layer,
                                  device=device)

    def bound_edit(chunk_positions: torch.Tensor):
        if edit_fn is None or edit_params is None:
            return edit_fn
        ep = with_chunk_positions(edit_params, chunk_positions)
        return lambda h, idx: edit_fn(h, idx, ep)

    cache = KVCache.zeros(cfg, B, T + N, device=device)
    prefill = forward(
        params, cfg, prompt_ids,
        positions=prompt_positions,
        attn_validity=prompt_valid,
        cache=cache,
        edit_fn=bound_edit(prompt_positions),
        carry_tap=carry(T),
        compute_logits=False,  # only the last column is sampled
    )

    last_logits = unembed(params, cfg, prefill.last_hidden[:, -1:])[:, 0]
    tok = torch.argmax(last_logits, dim=-1)
    stop = torch.tensor(stop_ids, dtype=tok.dtype, device=device)
    pad = torch.full_like(tok, chat.PAD_ID)

    tokens = torch.full((B, N), chat.PAD_ID, dtype=torch.long, device=device)
    emitted = torch.zeros((B, N), dtype=torch.bool, device=device)
    gen_resid = (torch.zeros((B, N, D), dtype=torch.float32, device=device)
                 if capture else None)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    pos = prompt_valid.sum(dim=1)
    cache = prefill.cache
    for i in range(N):
        if bool(done.all()):
            break
        res = forward(
            params, cfg, tok[:, None],
            positions=pos[:, None],
            attn_validity=(~done)[:, None],
            cache=cache,
            edit_fn=bound_edit(pos[:, None]),
            carry_tap=carry(1),
        )
        next_tok = torch.argmax(res.logits[:, 0], dim=-1)
        next_done = done | torch.isin(tok, stop)
        next_tok = torch.where(next_done, pad, next_tok)
        emitted_now = ~done
        tokens[:, i] = torch.where(emitted_now, tok, pad)
        emitted[:, i] = emitted_now
        if capture:
            gen_resid[:, i] = res.carry_tap[:, 0]
        cache, tok, done, pos = res.cache, next_tok, next_done, pos + 1

    prefill_cache = None
    if return_prefill_cache:
        # Steps wrote columns >= T only, but the cache is written in place:
        # hand over copies, so the caller owns columns nobody else writes
        # and the full cache frees on return.
        keep = max(T - 1, 0)
        prefill_cache = (cache.k[:, :, :keep].clone(),
                         cache.v[:, :, :keep].clone(),
                         cache.valid[:, :keep].clone())

    residual = None
    if capture:
        # Column T + i holds step i's input token, where `sequences` puts it.
        residual = torch.cat([prefill.carry_tap, gen_resid], dim=1)
    return DecodeResult(
        tokens=tokens,
        lengths=emitted.sum(dim=1),
        sequences=torch.cat([prompt_ids.long(), tokens], dim=1),
        sequence_valid=torch.cat([prompt_valid, emitted], dim=1),
        residual=residual,
        prefill_cache=prefill_cache,
    )


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
    capture_residual_layer: Optional[int] = None,
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
    :func:`dispatch_decode`."""
    from taboo_brittleness_tpu_torch.runtime import resilience

    resilience.fire("decode.launch", rows=len(prompts))
    padded, valid, positions, ids = encode_prompts(
        tok, prompts, prefills=prefills, pad_to_multiple=pad_to_multiple,
        rendered=rendered)
    result = dispatch_decode(
        params, cfg, padded, valid, positions, max_new_tokens=max_new_tokens,
        edit_fn=edit_fn, edit_params=edit_params,
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
    ``TBX_SPECULATE_CAPTURE=1`` as well).  ``kw`` goes to the decoder."""
    from taboo_brittleness_tpu_torch.runtime import speculate

    device = params["embed"].device
    args = (torch.from_numpy(padded).long().to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(positions).long().to(device))
    capture = kw.get("capture_residual_layer") is not None
    if speculate.should_speculate(capture=capture):
        plan = speculate.resolve_plan(cfg)
        result, _stats = speculate.speculative_decode(
            params, cfg, *args, draft_layer=plan.draft_layer,
            block_size=plan.block_size, **kw)
        return result
    return greedy_decode(params, cfg, *args, **kw)


def full_text(tok, prompt_ids: Sequence[int], result: DecodeResult, row: int) -> str:
    """Reference-shaped full output: decode(prompt + generation), truncated
    at the second <end_of_turn> (reference src/models.py:81-92)."""
    n = int(result.lengths[row])
    gen = result.tokens[row, :n].cpu().tolist()
    return chat.truncate_second_end_of_turn(tok.decode(list(prompt_ids) + gen))
