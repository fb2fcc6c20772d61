"""Speculative serving: per-slot draft and verify inside the continuous batch.

The counterpart of the JAX package's ``serve/spec_engine.py``.  The vanilla
engine advances one token per slot per step; here one step is a draft
launch and a verify launch, and a slot can emit up to G + 1 tokens:

- **Draft** (``serve.spec.draft``): ONE program running G single-token
  forwards over layers 0..k (``speculate._draft_view``: the draft model is
  a prefix of the target) for every decode-phase slot at once.  Each
  step's token is the layer-k lens argmax and its top1 - top2 lens-logit
  gap rides out as the adaptive-depth margin (``speculate.lens_pick``).
  The draft keeps no KV of its own: layers 0..k of the main cache already
  hold the K/V of every verified column.
- **Verify** (``serve.spec.verify``): ONE full-depth forward over the
  ``[S, G+1]`` chunk ``[input_tok, d_1..d_G]``, each slot at its own
  columns (``gemma2.forward(cache_positions=[B, T])``), then the accept /
  emit / stop bookkeeping (``speculate.accept_counts`` /
  ``stop_free_mask``).  A slot still inside its prompt feeds chunk column
  0 only (its draft budget masks to zero), which is the vanilla
  single-token prefill step.  KV validity is recomputed per launch as
  ``col < pos``, so a rejected draft's column never becomes valid; the
  cache is widened by G + 1 columns past ``max_context`` to take the chunk
  writes of frozen slots and rejected drafts.  The readout is P(target)
  at the tap layer for every chunk position, through ``serve.engine``'s
  ``lens_readout``: on the card one ``lens_stats`` launch over
  N = S (G + 1) rows with K = 1, inside the graph; always run and masked
  by ``lens_on`` (a graph cannot branch on device data, where JAX skips
  the readout with ``lax.cond``).
- **Lossless contract**: with every slot's ``exit_margin`` below 0 (off),
  every emitted token is the full model's verify-pass argmax, so token
  streams equal the vanilla engine's, up to rounding that depends on the
  forward's shape (the verify runs G + 1 columns where vanilla runs one;
  in f32 on the CPU the streams are equal).
- **Adaptive depth** (per request, the ``adaptive_depth`` scenario): a
  drafted token whose margin clears the slot's threshold is accepted
  without argmax agreement; the verify's argmax there is kept only as the
  agreement diagnostic (``early_agree``).
- **Per-slot (k, G) plans**: G rides as per-slot data (``SpecSlots.block``,
  set at admission from the word's ``speculate.resolve_plan``); k selects
  which layers the draft runs, a shape, so it is one engine-wide value
  (the deepest resident word's plan).

**The draft writes into the main cache.**  JAX slices ``main_k[:k+1]``
into a per-launch copy and drops it; here the slice is a view, so the
draft's K/V writes land in layers 0..k of the main cache.  They land at
columns ``pos .. pos + G - 1`` of every row (prompt-phase and frozen rows
included), which the same step's verify rewrites at full depth before
any of them is valid: the verify writes columns ``pos .. pos + G`` of
every row, and validity is ``col < pos`` until then.  So nothing the
draft writes is ever read by a later launch, the draft needs no copy of
the cache, and both graphs read the same storage at every replay
(``tests/test_torch_serve_spec.py`` holds the cache after a verify
bit-equal to a verify over the pre-draft cache).

Both programs are ``runtime.aot`` programs over the engine's buffers, one
CUDA graph each on the card, captured at :meth:`SpecServeEngine.warm_start`
after the cache is widened; the gate is zero misses for both entries.
Host syncs: one ``[S, 3 (G+1) + 5]`` pull per step (tokens, emit flags,
lens probabilities, finished, accepted, drafted, early exits, early
agreements).

Under a tp mesh (``serve.engine``'s tensor-parallel forms) the programs
are ``serve.spec.draft[tp]`` (the draft head through
``parallel.mesh.tp_lens_pick``) and ``serve.spec.verify[tp]`` (tokens
through ``tp_argmax``, the readout through per-shard ``lens_stats``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from taboo_brittleness_tpu_torch.ops import sae as sae_ops
from taboo_brittleness_tpu_torch.ops.lens import residual_carry_tap
from taboo_brittleness_tpu_torch.parallel.mesh import vocab_mesh
from taboo_brittleness_tpu_torch.runtime import chat, speculate
from taboo_brittleness_tpu_torch.serve.engine import (
    EngineConfig,
    ServeEngine,
    SlotState,
    _serve_edit,
    greedy_tokens,
    lens_readout,
)


def enabled() -> bool:
    """``TBX_SERVE_SPECULATE=1`` routes serving through the speculative
    engine.  Off by default, as in the JAX package."""
    return os.environ.get("TBX_SERVE_SPECULATE", "0") == "1"


class SpecSlots(NamedTuple):
    """Per-slot speculation plan, set at admission (data, never shape)."""

    block: torch.Tensor    # [S] int64 — draft budget g_s (<= engine G)
    margin: torch.Tensor   # [S] f32 — adaptive-depth margin; < 0 = lossless

    @classmethod
    def zeros(cls, slots: int, block: int, *,
              device: torch.device) -> "SpecSlots":
        return cls(block=torch.full((slots,), block, dtype=torch.long,
                                    device=device),
                   margin=torch.full((slots,), -1.0, dtype=torch.float32,
                                     device=device))


class SpecStepOut(NamedTuple):
    """One speculative step's host view: up to G + 1 emissions per slot in
    chunk order (``emit`` marks the real ones), plus the per-slot accept
    accounting the scheduler folds into responses."""

    toks: np.ndarray        # [S, G+1] int64 — emitted tokens (PAD elsewhere)
    emit: np.ndarray        # [S, G+1] bool
    finished: np.ndarray    # [S] bool — session completed THIS step
    lens_prob: np.ndarray   # [S, G+1] f32 — P(lens_target) per emission
    accepted: np.ndarray    # [S] int64 — drafted tokens emitted this step
    drafted: np.ndarray     # [S] int64 — drafts offered (the slot's g_s)
    early: np.ndarray       # [S] int64 — emissions accepted via the margin
    early_agree: np.ndarray  # [S] int64 — of those, equal to the full argmax


#: Per-slot scalar columns after the three [G+1]-wide blocks of the output.
_SCALARS = ("finished", "accepted", "drafted", "early", "early_agree")


# ---------------------------------------------------------------------------
# Draft program: G lens-head steps for the whole batch, one launch.
# ---------------------------------------------------------------------------

def _edit_binding(state: SlotState, sae: Optional[sae_ops.SAEParams],
                  sae_layer: int, proj_layer: int):
    ep: Dict[str, Any] = {"latent_ids": state.latent_ids,
                          "basis": state.basis, "proj_layer": proj_layer}
    if sae is not None:
        ep["sae"] = sae
        ep["sae_layer"] = sae_layer
    return lambda h, idx: _serve_edit(h, idx, ep)


def _draft_core(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    cache: KVCache,
    state: SlotState,
    active: torch.Tensor,
    *,
    draft_layer: int,
    block_size: int,
    sae_layer: int,
    proj_layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G autoregressive lens-head steps over layers 0..k for rows
    ``active`` -> ``(drafts [S, G], margins [S, G])``.  The draft's K/V go
    to layers 0..k of ``cache`` itself, at columns >= each row's ``pos``,
    which the verify rewrites before they are valid (module docstring)."""
    dcfg = cfg.replace(num_layers=draft_layer + 1)
    dparams = speculate._draft_view(params, draft_layer)
    dk, dv = cache.k[:draft_layer + 1], cache.v[:draft_layer + 1]
    C = cache.k.shape[2]
    valid = (torch.arange(C, device=state.pos.device)[None, :]
             < state.pos[:, None])
    bound = _edit_binding(state, sae, sae_layer, proj_layer)
    pad = torch.full_like(state.input_tok, chat.PAD_ID)
    tok, c = state.input_tok, state.pos
    drafts: List[torch.Tensor] = []
    margins: List[torch.Tensor] = []
    for _ in range(block_size):
        res = forward(
            dparams, dcfg, tok[:, None],
            positions=c[:, None],
            attn_validity=active[:, None],
            cache=KVCache(k=dk, v=dv, valid=valid, length=0),
            edit_fn=bound,
            cache_positions=c,
            compute_logits=False,
        )
        nxt, margin = speculate.lens_pick(params, cfg, res.last_hidden,
                                          with_margin=True)
        tok = torch.where(active, nxt[:, 0], pad)
        drafts.append(tok)
        margins.append(margin[:, 0])
        valid, c = res.cache.valid, c + 1
    return torch.stack(drafts, dim=1), torch.stack(margins, dim=1)


def _draft_active(state: SlotState) -> torch.Tensor:
    """Rows worth drafting for: live AND past their prompt (prompt-phase
    slots feed chunk column 0 only)."""
    in_prompt = state.pos + 1 < state.prompt_len
    return state.active & ~state.done & ~in_prompt


def serve_spec_draft(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    cache: KVCache,
    state: SlotState,
    drafts: torch.Tensor,
    margins: torch.Tensor,
    *,
    draft_layer: int,
    block_size: int,
    sae_layer: int,
    proj_layer: int,
) -> None:
    """The single-word draft program (``serve.spec.draft``): writes
    ``drafts`` [S, G] and ``margins`` [S, G] in place."""
    d, m = _draft_core(params, cfg, sae, cache, state, _draft_active(state),
                       draft_layer=draft_layer, block_size=block_size,
                       sae_layer=sae_layer, proj_layer=proj_layer)
    drafts.copy_(d)
    margins.copy_(m)


def serve_spec_draft_multi(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    bank: Dict[str, Dict[str, torch.Tensor]],
    cache: KVCache,
    state: SlotState,
    drafts: torch.Tensor,
    margins: torch.Tensor,
    *,
    codecs: Tuple[Tuple[str, str], ...],
    draft_layer: int,
    block_size: int,
    sae_layer: int,
    proj_layer: int,
) -> None:
    """Mixed-word drafting: a host loop over the delta bank rebuilds word
    ``w``'s params (``runtime.delta.reconstruct_params``) and drafts for
    that word's slots alone, merged by mask (W x the draft compute, the
    price the multi-word step pays).  Each word's draft writes the same
    columns of every row, and none of them is valid before the verify
    rewrites it, so the words need no cache merge here.  A bank whose
    every leaf is ``zero`` drafts once over the base."""
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    base_active = _draft_active(state)
    core = dict(draft_layer=draft_layer, block_size=block_size,
                sae_layer=sae_layer, proj_layer=proj_layer)
    if not any(codec != "zero" for _, codec in codecs):
        d, m = _draft_core(params, cfg, sae, cache, state, base_active,
                           **core)
        drafts.copy_(d)
        margins.copy_(m)
        return
    d_acc = torch.full_like(drafts, chat.PAD_ID)
    m_acc = torch.zeros_like(margins)
    for w in range(deltalib.bank_words(bank)):
        sel = base_active & (state.word_id == w)
        payload = {name: {f: a[w] for f, a in fields.items()}
                   for name, fields in bank.items()}
        params_w = deltalib.reconstruct_params(params, payload, codecs)
        d, m = _draft_core(params_w, cfg, sae, cache, state, sel, **core)
        del params_w
        d_acc = torch.where(sel[:, None], d, d_acc)
        m_acc = torch.where(sel[:, None], m, m_acc)
    drafts.copy_(d_acc)
    margins.copy_(m_acc)


# ---------------------------------------------------------------------------
# Verify program: one full-depth chunk forward + accept/advance bookkeeping.
# ---------------------------------------------------------------------------

def _chunk_inputs(state: SlotState, spec: SpecSlots, drafts: torch.Tensor,
                  alive: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot teacher-forced chunk ``[input_tok, d_1..d_G]`` at columns
    ``pos..pos+G``, masked to each slot's phase and draft budget: a
    prompt-phase slot feeds column 0 only (the vanilla step), a decode slot
    ``1 + g_s`` columns, frozen slots nothing.  Returns
    ``(feed_valid, chunk, cols)``, each [S, G+1]."""
    S, G = drafts.shape
    in_prompt = state.pos + 1 < state.prompt_len
    decode = alive & ~in_prompt
    g_eff = torch.where(decode, spec.block.clamp(max=G),
                        torch.zeros_like(spec.block))
    i = torch.arange(G + 1, device=drafts.device)[None, :]
    feed_valid = alive[:, None] & (i <= g_eff[:, None])
    chunk = torch.cat([state.input_tok[:, None], drafts], dim=1)
    chunk = torch.where(feed_valid, chunk, torch.full_like(chunk, chat.PAD_ID))
    return feed_valid, chunk, state.pos[:, None] + i


def _verify_forward(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    cache: KVCache,
    state: SlotState,
    chunk: torch.Tensor,
    feed_valid: torch.Tensor,
    cols: torch.Tensor,
    sel: torch.Tensor,
    *,
    sae_layer: int,
    proj_layer: int,
    tap_layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-shaped forward: one full-depth forward over ``[S, G+1]``
    positions, each row at its own columns, writing their K/V into
    ``cache``; returns the per-position argmax ``y [S, G+1]`` and lens prob
    ``[S, G+1]`` (0 where ``sel`` or the slot's readout is off).  Validity
    is ``col < pos`` plus the fed chunk columns, rebuilt per launch (the
    implicit rollback of rejected drafts).  Every output row depends only
    on that row's inputs and cache row, so the multi-word verify runs this
    per word under a narrowed ``sel``."""
    S, G1 = chunk.shape
    C = cache.k.shape[2]
    valid = (torch.arange(C, device=chunk.device)[None, :]
             < state.pos[:, None])
    res = forward(
        params, cfg, chunk,
        positions=cols,
        attn_validity=feed_valid,
        cache=KVCache(k=cache.k, v=cache.v, valid=valid, length=0),
        cache_positions=cols,
        edit_fn=_edit_binding(state, sae, sae_layer, proj_layer),
        carry_tap=residual_carry_tap(S, G1, cfg.hidden_size, tap_layer,
                                     device=chunk.device),
        compute_logits=False,
        valid_in_place=True,
    )
    if vocab_mesh(params, cfg) is None:
        y = torch.argmax(unembed(params, cfg, res.last_hidden), dim=-1)
    else:                          # tp: per-shard argmax, merged
        y = greedy_tokens(params, cfg, res.last_hidden)
    # Always run, masked: N = S (G + 1) rows, the slot's target on each.
    lens_on = (state.lens_target >= 0) & sel
    prob = lens_readout(
        params, cfg, res.carry_tap.reshape(S * G1, cfg.hidden_size),
        state.lens_target[:, None].expand(S, G1).reshape(-1)).reshape(S, G1)
    return y, torch.where(lens_on[:, None], prob, torch.zeros_like(prob))


def _spec_advance(state: SlotState, spec: SpecSlots, drafts: torch.Tensor,
                  margins: torch.Tensor, y: torch.Tensor,
                  lens_prob: torch.Tensor, stop: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Accept + emit + advance, [S]-wide and branch-free, in place: the
    speculative ``_advance``.  Emission index i emits the fed draft
    ``d_{i+1}`` while ``i < m`` (under plain match it equals ``y_i``; under
    a margin accept it is the depth-k early exit whose K/V the cache
    holds) and the verify pass's own ``y_m`` as the bonus at ``i == m``,
    gated by the slot's budget and the stop-free prefix.  ``out``
    [S, 3 (G+1) + 5] gets tokens, emit flags, lens probabilities and the
    :data:`_SCALARS`."""
    S, G1 = y.shape
    G = G1 - 1
    P = state.prompt_buf.shape[1]
    i = torch.arange(G1, device=y.device)[None, :]
    alive = state.active & ~state.done
    in_prompt = state.pos + 1 < state.prompt_len
    decode = alive & ~in_prompt
    g_eff = torch.where(decode, spec.block.clamp(max=G),
                        torch.zeros_like(spec.block))

    adaptive = spec.margin >= 0.0
    margin_ok = (decode[:, None] & adaptive[:, None]
                 & (margins > spec.margin[:, None]))
    match, m = speculate.accept_counts(drafts, y, limit=g_eff,
                                       extra=margin_ok)
    m = torch.where(decode, m, torch.zeros_like(m))

    pad_col = torch.full((S, 1), chat.PAD_ID, dtype=drafts.dtype,
                         device=y.device)
    stream = torch.where(i < m[:, None], torch.cat([drafts, pad_col], dim=1),
                         y)                                      # [S, G+1]
    sf = speculate.stop_free_mask(stream, stop)
    budget_ok = (state.gen_count[:, None] + i) < state.max_gen[:, None]
    emit_i = decode[:, None] & (i <= m[:, None]) & budget_ok & sf
    count = emit_i.sum(dim=1)

    stop_emitted = (emit_i & speculate._is_stop(stream, stop)).any(dim=1)
    finished = decode & (stop_emitted
                         | (state.gen_count + count >= state.max_gen))

    last_emitted = torch.gather(stream, 1,
                                (count - 1).clamp(0, G)[:, None])[:, 0]
    next_from_prompt = torch.gather(
        state.prompt_buf, 1, (state.pos + 1).clamp(0, P - 1)[:, None])[:, 0]
    alive_next = alive & ~finished
    next_tok = torch.where(in_prompt, next_from_prompt, last_emitted)
    next_tok = torch.where(alive_next, next_tok,
                           torch.full_like(next_tok, chat.PAD_ID))
    kept = torch.where(in_prompt, torch.ones_like(count), count)

    no_col = torch.zeros((S, 1), dtype=torch.bool, device=y.device)
    early_i = emit_i & (i < m[:, None]) & torch.cat([margin_ok, no_col], dim=1)
    out[:, :G1].copy_(torch.where(emit_i, stream, torch.full_like(stream,
                                                                  chat.PAD_ID)))
    out[:, G1:2 * G1].copy_(emit_i)
    out[:, 2 * G1:3 * G1].copy_(torch.where(emit_i, lens_prob,
                                            torch.zeros_like(lens_prob)))
    out[:, 3 * G1:].copy_(torch.stack([
        finished.float(),
        torch.minimum(m, count).float(),
        g_eff.float(),
        early_i.sum(dim=1).float(),
        (early_i & torch.cat([match, no_col], dim=1)).sum(dim=1).float(),
    ], dim=1))
    state.pos.copy_(torch.where(alive_next, state.pos + kept, state.pos))
    state.input_tok.copy_(next_tok)
    state.done.logical_or_(finished)
    state.gen_count.add_(count)


def serve_spec_verify(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    cache: KVCache,
    state: SlotState,
    spec: SpecSlots,
    drafts: torch.Tensor,
    margins: torch.Tensor,
    out: torch.Tensor,
    stop: torch.Tensor,
    *,
    sae_layer: int,
    proj_layer: int,
    tap_layer: int,
) -> None:
    """The single-word verify program (``serve.spec.verify``): chunk
    forward + accept bookkeeping, ``cache``, ``state`` and ``out`` written
    in place."""
    alive = state.active & ~state.done
    feed_valid, chunk, cols = _chunk_inputs(state, spec, drafts, alive)
    y, lens_prob = _verify_forward(
        params, cfg, sae, cache, state, chunk, feed_valid, cols, alive,
        sae_layer=sae_layer, proj_layer=proj_layer, tap_layer=tap_layer)
    _spec_advance(state, spec, drafts, margins, y, lens_prob, stop, out)


def serve_spec_verify_multi(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    bank: Dict[str, Dict[str, torch.Tensor]],
    cache: KVCache,
    state: SlotState,
    spec: SpecSlots,
    drafts: torch.Tensor,
    margins: torch.Tensor,
    out: torch.Tensor,
    stop: torch.Tensor,
    *,
    codecs: Tuple[Tuple[str, str], ...],
    sae_layer: int,
    proj_layer: int,
    tap_layer: int,
) -> None:
    """Mixed-word verify: per-word chunk forwards merged by word mask (the
    ``serve_step_multi`` shape), then ONE shared accept / advance over the
    merged ``y``.  Each word's forward writes columns ``pos..pos+G`` of
    every row, so those columns are gathered after it and each slot's are
    written back from its own word at the end, at the row's own offsets;
    argmax and lens prob merge by mask the same way."""
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    alive = state.active & ~state.done
    feed_valid, chunk, cols = _chunk_inputs(state, spec, drafts, alive)
    core = dict(sae_layer=sae_layer, proj_layer=proj_layer,
                tap_layer=tap_layer)
    if not any(codec != "zero" for _, codec in codecs):
        y, lens_prob = _verify_forward(params, cfg, sae, cache, state, chunk,
                                       feed_valid, cols, alive, **core)
        _spec_advance(state, spec, drafts, margins, y, lens_prob, stop, out)
        return

    rows = torch.arange(chunk.shape[0], device=chunk.device)[:, None]
    merged = None
    for w in range(deltalib.bank_words(bank)):
        sel = alive & (state.word_id == w)
        payload = {name: {f: a[w] for f, a in fields.items()}
                   for name, fields in bank.items()}
        params_w = deltalib.reconstruct_params(params, payload, codecs)
        y, prob = _verify_forward(params_w, cfg, sae, cache, state, chunk,
                                  feed_valid & sel[:, None], cols, sel,
                                  **core)
        del params_w
        kv = (cache.k[:, rows, cols], cache.v[:, rows, cols])  # [L, S, G+1, ..]
        if merged is None:
            merged = kv + (y, prob)
        else:
            k_acc, v_acc, y_acc, prob_acc = merged
            m = sel[None, :, None, None, None]
            merged = (torch.where(m, kv[0], k_acc),
                      torch.where(m, kv[1], v_acc),
                      torch.where(sel[:, None], y, y_acc),
                      torch.where(sel[:, None], prob, prob_acc))
    k_acc, v_acc, y, lens_prob = merged
    cache.k[:, rows, cols] = k_acc
    cache.v[:, rows, cols] = v_acc
    _spec_advance(state, spec, drafts, margins, y, lens_prob, stop, out)


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

class SpecServeEngine(ServeEngine):
    """:class:`ServeEngine` whose ``step()`` is a draft + verify block.

    A drop-in for the scheduler: admission, capacity, recycle and the word
    index are inherited (prefill IS the masked chunk column 0); ``step()``
    returns a :class:`SpecStepOut` whose multi-column emissions the
    scheduler iterates in order.  ``admit`` also sets the slot's draft
    budget (its word's plan, clamped to the engine's G) and the request's
    adaptive-depth margin.
    """

    speculative = True

    def __init__(self, params: Params, cfg: Gemma2Config, tok, *,
                 engine_config: Optional[EngineConfig] = None,
                 sae: Optional[sae_ops.SAEParams] = None,
                 words: Sequence[str] = (),
                 delta_bank: Optional[Tuple] = None,
                 draft_layer: Optional[int] = None,
                 block_size: Optional[int] = None,
                 tp: Optional[int] = None, mesh: Any = None):
        super().__init__(params, cfg, tok, engine_config=engine_config,
                         sae=sae, words=words, delta_bank=delta_bank, tp=tp,
                         mesh=mesh)
        # Per-word plans (env > calibration artifact > heuristic).  k is a
        # shape: one engine-wide value, the deepest resident plan; G is the
        # engine's ceiling, each slot's g_s rides below it as data.
        plan_words = self.words if self.words else (None,)
        self.plans: Dict[Optional[str], speculate.SpecPlan] = {
            w: speculate.resolve_plan(cfg, w) for w in plan_words}
        k = (int(draft_layer) if draft_layer is not None
             else max(p.draft_layer for p in self.plans.values()))
        self.draft_layer = max(0, min(k, cfg.num_layers - 2))
        g = (int(block_size) if block_size is not None
             else max(p.block_size for p in self.plans.values()))
        self.block = max(1, g)
        S, G1 = self.ec.slots, self.block + 1
        self.spec = SpecSlots.zeros(S, self.block, device=self.device)
        # Widen the KV pages by G + 1 columns: a verify chunk writes up to
        # G columns past a slot's kept prefix (rejected drafts, frozen
        # slots).  Nothing is captured before this: both programs are keyed
        # on, and replay, the widened cache.
        self.cache = KVCache.zeros(cfg, S, self.ec.max_context + G1,
                                   device=self.device,
                                   kv_heads=local_kv_heads(self.params, cfg))
        self._drafts = torch.zeros((S, self.block), dtype=torch.long,
                                   device=self.device)
        self._margins = torch.zeros((S, self.block), dtype=torch.float32,
                                    device=self.device)
        self._alloc_out((S, 3 * G1 + len(_SCALARS)))
        self.aot_draft = self._program_name(
            "serve.spec.draft.multi" if self.multi else "serve.spec.draft")
        self.aot_verify = self._program_name(
            "serve.spec.verify.multi" if self.multi else "serve.spec.verify")
        #: the serve summary's zero-miss gate reads the verify program
        self.aot_name = self.aot_verify
        self._draft_fn = (serve_spec_draft_multi if self.multi
                          else serve_spec_draft)
        self._verify_fn = (serve_spec_verify_multi if self.multi
                           else serve_spec_verify)
        # Host accumulators (the ``_serve.json`` and loadgen spec block).
        self.drafted_total = 0
        self.accepted_total = 0
        self.emitted_total = 0
        self.early_total = 0

    # -- plan resolution -----------------------------------------------------

    def plan_for(self, word_id: int) -> speculate.SpecPlan:
        w = (self.words[word_id]
             if self.words and 0 <= word_id < len(self.words) else None)
        plan = self.plans.get(w)
        return plan if plan is not None else next(iter(self.plans.values()))

    # -- program plumbing ----------------------------------------------------

    def _buffers(self) -> List[torch.Tensor]:
        return [*super()._buffers(), *self.spec, self._drafts, self._margins]

    def _static(self) -> Dict[str, Any]:
        static = super()._static()
        static.update(draft_layer=self.draft_layer, block_size=self.block)
        return static

    def _dynamic(self) -> Dict[str, Any]:
        dynamic = super()._dynamic()
        dynamic.update(spec=self.spec, drafts=self._drafts,
                       margins=self._margins)
        return dynamic

    def _lead(self) -> Tuple[Any, ...]:
        lead: Tuple[Any, ...] = (self.params, self.cfg, self.sae)
        return lead + ((self.delta_bank,) if self.multi else ())

    def _draft_args(self) -> Tuple[Any, ...]:
        kw: Dict[str, Any] = dict(
            draft_layer=self.draft_layer, block_size=self.block,
            sae_layer=self.ec.sae_layer, proj_layer=self.ec.proj_layer)
        if self.multi:
            kw["codecs"] = self.delta_codecs
        return (self._draft_fn, self._lead() + (
            self.cache, self.state, self._drafts, self._margins), kw)

    def _step_args(self) -> Tuple[Any, ...]:
        """The verify program's launch (the base engine's step slot)."""
        kw: Dict[str, Any] = dict(
            sae_layer=self.ec.sae_layer, proj_layer=self.ec.proj_layer,
            tap_layer=self.ec.tap_layer)
        if self.multi:
            kw["codecs"] = self.delta_codecs
        return (self._verify_fn, self._lead() + (
            self.cache, self.state, self.spec, self._drafts, self._margins,
            self._out, self._stop), kw)

    def warm_start(self) -> Dict[str, Any]:
        """Make (and on the card capture) BOTH programs over the widened
        cache; returns ``{entry: record}`` for the draft and the verify."""
        self._command("warm_start")
        return {self.aot_draft: self._warm(self.aot_draft, self._draft_fn,
                                           self._draft_args()),
                self.aot_verify: self._warm(self.aot_verify, self._verify_fn,
                                            self._step_args())}

    def step(self) -> SpecStepOut:
        """One draft launch + one verify launch + one ``[S, 3 (G+1) + 5]``
        pull.  The verify rides an ``obs`` span whose end carries the
        accept record (drafted / accepted / emitted / early exits), the
        ``trace_report --check`` contract for ``serve.spec.verify``, and
        each launch a profiler annotation named after its program."""
        from taboo_brittleness_tpu_torch import obs

        self._command("step")
        with obs.profile.annotate(self.aot_draft, fn=self._draft_fn):
            self._run(self.aot_draft, self._draft_fn, self._draft_args())
        with obs.span("serve.spec.verify", kind="program", step=self.steps,
                      program=self.aot_verify) as sp:
            with obs.profile.annotate(self.aot_verify, fn=self._verify_fn,
                                      span_id=getattr(sp, "span_id", None)):
                self._run(self.aot_verify, self._verify_fn,
                          self._step_args())
            self.steps += 1
            host = self._pull()
            G1 = self.block + 1
            scal = host[:, 3 * G1:].astype(np.int64)
            out = SpecStepOut(
                toks=host[:, :G1].astype(np.int64),
                emit=host[:, G1:2 * G1] != 0,
                finished=scal[:, 0] != 0,
                lens_prob=host[:, 2 * G1:3 * G1].copy(),
                accepted=scal[:, 1], drafted=scal[:, 2], early=scal[:, 3],
                early_agree=scal[:, 4])
            drafted = int(out.drafted.sum())
            accepted = int(out.accepted.sum())
            emitted = int(out.emit.sum())
            early = int(out.early.sum())
            self.drafted_total += drafted
            self.accepted_total += accepted
            self.emitted_total += emitted
            self.early_total += early
            sp.set(drafted=drafted, accepted=accepted, emitted=emitted,
                   early_exits=early)
        self._done |= out.finished
        return out

    # -- admission -----------------------------------------------------------

    def _admit(self, slot: int, prompt_ids: Sequence[int], *, max_new: int,
               latent_ids: Sequence[int] = (),
               basis: Optional[np.ndarray] = None, lens_target: int = -1,
               word_id: int = 0, exit_margin: float = -1.0) -> None:
        """Vanilla admission plus the slot's plan: g_s from the word's plan
        (clamped to the engine's G) and the request's adaptive-depth margin
        (< 0 = lossless), written in place."""
        super()._admit(slot, prompt_ids, max_new=max_new,
                       latent_ids=latent_ids, basis=basis,
                       lens_target=lens_target, word_id=word_id)
        g = min(self.plan_for(word_id).block_size, self.block)
        self.spec.block[slot].fill_(int(g))
        self.spec.margin[slot].fill_(float(exit_margin))

    def accept_stats(self) -> Dict[str, Any]:
        """Engine-level accept accounting (the ``_serve.json`` spec block)."""
        return {
            "draft_layer": self.draft_layer,
            "block_size": self.block,
            "blocks": self.steps,
            "drafted": self.drafted_total,
            "accepted": self.accepted_total,
            "emitted": self.emitted_total,
            "exited_early": self.early_total,
            "accept_rate": (round(self.accepted_total / self.drafted_total, 4)
                            if self.drafted_total else 0.0),
            "tokens_per_verify": (round(self.emitted_total / self.steps, 4)
                                  if self.steps else 0.0),
        }
