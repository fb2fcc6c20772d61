"""Fused decode -> readout -> NLL: the study's inner loop as one launch.

The counterpart of the JAX package's ``runtime/fused.py``.  There, the
study's three programs per arm chunk (``greedy_decode``, the tap-layer
readout ``interventions._residual_measure`` and the cached-NLL
continuation), plus the baseline pass's spike finding, compile into ONE XLA
program, so no host glue sits between them.  Here "one program" is one call
that enqueues the three on the card's stream and reads nothing back until
the caller collects: the graphed decode (``runtime.aot``; its host loop
reads only the all-done flag), then the readout and the NLL continuation
eagerly.  The NLL runs straight over the decode's own KV cache
(``greedy_decode(return_cache=True)``, columns ``[0, resp_start)`` hold the
prefill).  A speculative decode (``TBX_SPECULATE=1`` with
``TBX_SPECULATE_CAPTURE=1``) keeps no cache of the launch's width, so then
the continuation starts from copies of its prefill columns.

Every study launch runs :func:`fused_study`, so the study's results do not
depend on the route.  ``TBX_FUSED=1`` (off by default, as in the JAX
package) routes them through :func:`dispatch_fused`, which counts them in
``launches`` and ``rows``; the JAX package's phase table and ``obs`` spans
are not ported.

The readout and NLL tail stays eager: at a study launch (330 rows x 114
columns x 256k vocab) it is matmul-bound, not launch-bound.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional, Tuple

import torch

from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.runtime import chat

#: Sub-phase order inside one fused launch.
FUSED_PHASES: Tuple[str, ...] = ("decode", "readout", "nll")

#: Fused launches and their rows, counted by :func:`dispatch_fused`.
launches = 0
rows = 0


def enabled() -> bool:
    """``TBX_FUSED=1`` routes the study's launches through
    :func:`dispatch_fused` (counted).  Off by default."""
    return os.environ.get("TBX_FUSED", "0") == "1"


class FusedResult(NamedTuple):
    """Everything the study reads from one fused launch: the decode's
    fields, its response layout, the readout's fields, the NLL [B, T] and
    the number of steps that emitted a token.  ``residual`` is the decode's
    capture (the baseline pass scores and projects from it).  The
    ``prefill_*`` fields stay None here: the JAX package returns them to
    keep its one program's codegen equal to the legacy launches.
    ``spike_pos`` / ``spike_probs`` ride only in baseline mode."""

    tokens: torch.Tensor            # [B, N]
    lengths: torch.Tensor           # [B]
    sequences: torch.Tensor         # [B, T]
    sequence_valid: torch.Tensor    # [B, T] bool
    positions: torch.Tensor         # [B, T]
    response_mask: torch.Tensor     # [B, T] bool
    tap_prob: torch.Tensor          # [B, T]
    row_prob_sum: torch.Tensor      # [B]
    row_resp: torch.Tensor          # [B]
    agg_ids: torch.Tensor           # [B, K]
    agg_probs: torch.Tensor         # [B, K]
    nll: torch.Tensor               # [B, T]
    decode_steps: torch.Tensor      # [] int32
    residual: Optional[torch.Tensor] = None       # [B, T, D] f32
    prefill_k: Optional[torch.Tensor] = None
    prefill_v: Optional[torch.Tensor] = None
    prefill_valid: Optional[torch.Tensor] = None
    spike_pos: Optional[torch.Tensor] = None      # [B, K_spike]
    spike_probs: Optional[torch.Tensor] = None    # [B, K_spike]


@torch.no_grad()
def fused_study(
    params: Params,
    cfg: Gemma2Config,
    prompt_ids: torch.Tensor,        # [B, Tp] left-padded
    prompt_valid: torch.Tensor,      # [B, Tp] bool
    prompt_positions: torch.Tensor,  # [B, Tp]
    edit_params: Any = None,
    target_ids: Optional[torch.Tensor] = None,   # [B]
    nll_seqs: Optional[torch.Tensor] = None,       # [B, T]
    nll_valid: Optional[torch.Tensor] = None,      # [B, T] bool
    nll_positions: Optional[torch.Tensor] = None,  # [B, T]
    nll_next_mask: Optional[torch.Tensor] = None,  # [B, T] bool
    *,
    max_new_tokens: int,
    edit_fn: Any = None,
    stop_ids: Tuple[int, ...] = (chat.EOS_ID, chat.END_OF_TURN_ID),
    tap_layer: int,
    top_k: int,
    variant: str = "foldexp",
    spike_top_k: Optional[int] = None,
    nll_edit: bool = False,
) -> FusedResult:
    """Decode (prefill + graphed steps, the edit in both), the tap-layer
    lens readout, the cached-NLL continuation and (baseline mode) the spike
    finding, enqueued back to back.

    Arms mode (``nll_*`` given) re-scores that layout (the baseline
    continuation); baseline mode (all None) derives it from the decode's
    own output.  ``nll_edit`` applies the edit to the continuation too (the
    arms); baseline mode scores unedited.  The decode speculates where
    ``speculate.should_speculate(capture=True)`` says so."""
    from taboo_brittleness_tpu_torch.ops import lens
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import decode, speculate

    kw = dict(max_new_tokens=max_new_tokens, edit_fn=edit_fn,
              edit_params=edit_params, stop_ids=stop_ids,
              capture_residual_layer=tap_layer)
    args = (params, cfg, prompt_ids, prompt_valid, prompt_positions)
    if speculate.should_speculate(capture=True):
        plan = speculate.resolve_plan(cfg)
        dec, _ = speculate.speculative_decode(
            *args, draft_layer=plan.draft_layer, block_size=plan.block_size,
            return_prefill_cache=True, **kw)
    else:
        dec = decode.greedy_decode(*args, return_cache=True, **kw)
    layout = decode.response_layout_device(dec)
    s = max(layout.prompt_len - 1, 0)
    out = iv._residual_measure(
        params, cfg, dec.residual, layout.sequences, layout.response_mask,
        target_ids, top_k=top_k, resp_start=s, variant=variant)

    if nll_seqs is None:
        seqs, valid, positions = layout.sequences, layout.valid, layout.positions
        next_mask = torch.zeros_like(layout.response_mask)
        next_mask[:, :-1] = layout.response_mask[:, 1:]
    else:
        seqs, valid = nll_seqs, nll_valid
        positions, next_mask = nll_positions, nll_next_mask
    ep_nll, nll_edit_fn = None, None
    if nll_edit and edit_fn is not None:
        ep_nll = iv._with_chunk_positions(edit_params, positions[:, s:])
        nll_edit_fn = edit_fn
    if dec.cache is not None:
        nll = iv._nll_continue(params, cfg, dec.cache, seqs, valid, positions,
                               next_mask, edit_fn=nll_edit_fn,
                               edit_params=ep_nll, resp_start=s)
    else:
        nll = iv._teacher_forced_nll_cached(
            params, cfg, *dec.prefill_cache, seqs, valid, positions, next_mask,
            edit_fn=nll_edit_fn, edit_params=ep_nll, resp_start=s)

    spike_pos = spike_probs = None
    if spike_top_k is not None:
        spike_pos, spike_probs = lens.spike_positions_batch(
            out["tap_prob"], layout.response_mask, top_k=spike_top_k)
    return FusedResult(
        tokens=dec.tokens, lengths=dec.lengths,
        sequences=layout.sequences, sequence_valid=layout.valid,
        positions=layout.positions, response_mask=layout.response_mask,
        tap_prob=out["tap_prob"], row_prob_sum=out["row_prob_sum"],
        row_resp=out["row_resp"], agg_ids=out["agg_ids"],
        agg_probs=out["agg_probs"], nll=nll,
        decode_steps=dec.lengths.max().to(torch.int32),
        residual=dec.residual, spike_pos=spike_pos, spike_probs=spike_probs)


def dispatch_fused(params: Params, cfg: Gemma2Config, prompt_ids: torch.Tensor,
                   *args: Any, **kw: Any) -> FusedResult:
    """:func:`fused_study`, counted in ``launches`` and ``rows``."""
    global launches, rows
    launches += 1
    rows += int(prompt_ids.shape[0])
    return fused_study(params, cfg, prompt_ids, *args, **kw)
