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
depend on the route.  Called directly (the default) it runs the JAX
package's three program launches: ``decode``, ``readout`` and ``nll``, each
under its own ``obs`` program span and profiler annotation.
``TBX_FUSED=1`` (off by default, as in the JAX package) routes the launches
through :func:`dispatch_fused`: one ``fused`` program span and annotation
carrying the :func:`phase_table`, counted by the ``fused.launches`` /
``fused.rows`` obs counters.

The readout and NLL tail stays eager: at a study launch (330 rows x 114
columns x 256k vocab) it is matmul-bound, not launch-bound.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.runtime import chat

#: Sub-phase order inside one fused launch.
FUSED_PHASES: Tuple[str, ...] = ("decode", "readout", "nll")


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
    program_spans: bool = True,
) -> FusedResult:
    """Decode (prefill + graphed steps, the edit in both), the tap-layer
    lens readout, the cached-NLL continuation and (baseline mode) the spike
    finding, enqueued back to back.

    Arms mode (``nll_*`` given) re-scores that layout (the baseline
    continuation); baseline mode (all None) derives it from the decode's
    own output.  ``nll_edit`` applies the edit to the continuation too (the
    arms); baseline mode scores unedited.  The decode speculates where
    ``speculate.should_speculate(capture=True)`` says so.

    ``program_spans`` opens the ``decode`` / ``readout`` / ``nll`` program
    spans (the JAX package's separate launches); :func:`dispatch_fused`
    turns them off, its one ``fused`` span standing for all three."""
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.ops import lens
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import decode, speculate

    rows, cols = prompt_ids.shape

    def program(name: str, **attrs: Any):
        if not program_spans:
            return contextlib.nullcontext(None)
        return obs.span(name, kind="program", rows=int(rows), **attrs)

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
        with program("decode", cols=int(cols), new_tokens=max_new_tokens,
                     fn="greedy_decode") as sp:
            with obs.profile.annotate("decode", fn=decode.greedy_decode,
                                      span_id=getattr(sp, "span_id", None)):
                dec = decode.greedy_decode(*args, return_cache=True, **kw)
    layout = decode.response_layout_device(dec)
    s = max(layout.prompt_len - 1, 0)
    with program("readout", fn="_residual_measure") as sp:
        with obs.profile.annotate("readout", fn=iv._residual_measure,
                                  span_id=getattr(sp, "span_id", None)):
            out = iv._residual_measure(
                params, cfg, dec.residual, layout.sequences,
                layout.response_mask, target_ids, top_k=top_k,
                resp_start=s, variant=variant)

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
    with program("nll", fn="_nll_continue") as sp:
        with obs.profile.annotate("nll", fn=iv._nll_continue,
                                  span_id=getattr(sp, "span_id", None)):
            if dec.cache is not None:
                nll = iv._nll_continue(
                    params, cfg, dec.cache, seqs, valid, positions,
                    next_mask, edit_fn=nll_edit_fn, edit_params=ep_nll,
                    resp_start=s)
            else:
                nll = iv._teacher_forced_nll_cached(
                    params, cfg, *dec.prefill_cache, seqs, valid, positions,
                    next_mask, edit_fn=nll_edit_fn, edit_params=ep_nll,
                    resp_start=s)

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


def phase_table(cfg: Gemma2Config, rows: int, prompt_len: int,
                new_tokens: int, sae_width: int) -> Dict[str, float]:
    """The launch record's phase table: ordered fused phases with analytic
    device-cost WEIGHTS (normalized shares) at the exact launch shapes, from
    ``perf.roofline``.

    On a card with a known roofline spec (``roofline.device_spec`` of
    ``torch.cuda.get_device_name()``) the weight is each phase's ceiling
    time (max of compute and memory bound — the best predictor of its share
    of the launch); otherwise the analytic FLOPs share.  The table rides in
    the profiler annotation so the trace parser can split the launch's
    MEASURED device seconds per phase — fail-open to equal weights."""
    try:
        from taboo_brittleness_tpu_torch.perf import roofline

        flops = roofline.phase_flops(cfg, rows, prompt_len, new_tokens,
                                     sae_width)
        spec = roofline.device_spec(roofline.device_name())
        if spec is not None:
            bytes_ = roofline.sweep_phase_bytes(
                cfg, rows, prompt_len, new_tokens, sae_width)
            pred = {p: max(flops[p] / spec.peak_flops,
                           bytes_[p] / spec.hbm_bytes_per_s)
                    for p in FUSED_PHASES}
        else:
            pred = {p: flops[p] for p in FUSED_PHASES}
        total = sum(pred.values()) or 1.0
        return {p: round(pred[p] / total, 4) for p in FUSED_PHASES}
    except Exception:  # noqa: BLE001 — a table failure must not block dispatch
        w = round(1.0 / len(FUSED_PHASES), 4)
        return {p: w for p in FUSED_PHASES}


def _sae_width(edit_params: Any) -> int:
    """The launch's SAE width (0 without an SAE edit)."""
    sae = edit_params.get("sae") if isinstance(edit_params, dict) else None
    return int(sae.w_enc.shape[1]) if sae is not None else 0


def dispatch_fused(params: Params, cfg: Gemma2Config, prompt_ids: torch.Tensor,
                   *args: Any, **kw: Any) -> FusedResult:
    """:func:`fused_study` as one ``fused`` program launch: counted by the
    ``fused.launches`` and ``fused.rows`` obs counters, under a ``fused``
    program span and a profiler annotation carrying all three phase markers
    (:func:`phase_table`, computed only while a capture is live)."""
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics

    n, cols = prompt_ids.shape
    obs_metrics.counter("fused.launches").inc()
    obs_metrics.counter("fused.rows").inc(int(n))
    new_tokens = kw.get("max_new_tokens", 0)
    table = None
    if obs.profile.capturing():
        table = phase_table(cfg, int(n), int(cols), new_tokens,
                            _sae_width(kw.get("edit_params")))
    with obs.span("fused", kind="program", rows=int(n), cols=int(cols),
                  new_tokens=new_tokens, fn="fused_study",
                  phases=",".join(FUSED_PHASES)) as sp:
        with obs.profile.annotate("fused", fn=fused_study,
                                  span_id=getattr(sp, "span_id", None),
                                  phases=table):
            return fused_study(params, cfg, prompt_ids, *args,
                               program_spans=False, **kw)
