"""Targeted-vs-random intervention sweeps for one word (Execution Plan items
(e)/(f)).

The counterpart of the single-device, one-word path of the JAX package's
``pipelines/interventions.py``:

1. **Baseline pass**: batched decode of every hint prompt, capturing the
   tap-layer residual as it runs; the tap-layer lens readout (P(secret) and
   the LL-Top-k guesses); the baseline per-token NLL of the generated
   continuation; the spike positions (top-K response positions by
   P(secret)).
2. **SAE-latent ablation** over budgets m: the top-m latents by ``score =
   mean spike activation x max(0, relatedness to the secret)`` against R
   random draws of m latents per budget.  The edit runs inside generation
   (encode -> zero m latents -> decode splice at the tap layer, at every
   position of every forward).
3. **Low-rank projection removal** over ranks r: the rank-r principal
   subspace of the spike residuals against R random orthonormal subspaces.
4. **Measurements** per arm: mean P(secret) at the tap layer, LL-Top-k
   metrics, ΔNLL of the baseline continuation, leak rate.

Arms fold into the row axis: a sweep's arms (targeted + random controls,
every budget, ids padded to the largest budget with inert -1 and bases padded
to the largest rank with zero columns) go through ``measure_arm_sets`` in
balanced chunks of at most ``_DEFAULT_ARM_CHUNK`` arms, so one decode, one
readout and one NLL pass serve a whole chunk.  The study JSON is the JAX
package's, key for key.

``forcing=True`` adds the token-forcing attacks (pre- and postgame,
``pipelines.token_forcing``) under each targeted arm and the unedited
baseline, in batched launches of their own.  :func:`run_intervention_studies`
sweeps the word list: per-word resume, prefetch of the next word that will
run, retry then quarantine.

Each launch (the baseline and every arm chunk) is one
``runtime.fused.fused_study`` call: the decode, stepping through
``runtime.aot``'s graphs, the readout and the NLL continuation over the
decode's own cache.  :func:`warm_start_study` makes the study's programs
before its first word, and the studies driver enqueues the next word's
baseline behind the current word's arms.  Not ported here: the device mesh
and the telemetry observer.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch import metrics as metrics_mod
from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.models.gemma2 import (
    Gemma2Config,
    KVCache,
    Params,
    forward,
    rms_norm,
    unembed,
)
from taboo_brittleness_tpu_torch.ops import lens, projection
from taboo_brittleness_tpu_torch.ops import sae as sae_ops
from taboo_brittleness_tpu_torch.pipelines.word_sweep import (
    next_pending,
    sweep_words,
)
from taboo_brittleness_tpu_torch.runtime import decode, resilience, supervise
from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump
from taboo_brittleness_tpu_torch.runtime.tokenizer import (
    TokenizerLike,
    target_token_id,
)

_log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Edit functions (all state rides in edit_params).
# ---------------------------------------------------------------------------


def _at_layer(h: torch.Tensor, idx: int, ep: Dict[str, Any],
              apply: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Run ``apply`` only at layer ``ep['layer']``, optionally position-masked:

    - ``ep['positions']``: an explicit [B, T] bool mask over the chunk;
    - ``ep['spike_positions']``: [B, K] absolute RoPE positions of the
      baseline spikes, matched against ``ep['chunk_positions']`` ([B, T],
      the current chunk's positions, which ``decode.greedy_decode`` and the
      NLL pass inject).  This is what makes spike-localized editing work
      during generation, where the chunk is one token wide.

    The other layers return ``h`` untouched (a Python branch: the JAX
    package needs ``lax.cond`` inside its scan)."""
    if idx != int(ep["layer"]):
        return h
    edited = apply(h)
    mask = ep.get("positions")
    if mask is None and "spike_positions" in ep:
        if "chunk_positions" not in ep:
            # An every-position edit here would run the wrong experimental
            # arm under the spike-masked label.
            raise ValueError(
                "edit_params has spike_positions but no chunk_positions; "
                "route the forward through greedy_decode / measure_arm "
                "(which inject the current chunk's positions) or add "
                "chunk_positions yourself")
        cp = ep["chunk_positions"]                          # [B, T]
        spk = ep["spike_positions"]                         # [B, K]
        mask = (cp[:, :, None] == spk[:, None, :]).any(dim=-1)
    if mask is not None:
        edited = torch.where(mask[:, :, None], edited, h)
    return edited


def sae_ablation_edit(h: torch.Tensor, idx: int, ep: Dict[str, Any]) -> torch.Tensor:
    """Zero ``ep['latent_ids']`` in the SAE basis at layer ``ep['layer']``."""
    return _at_layer(
        h, idx, ep, lambda x: sae_ops.ablate_latents(ep["sae"], x, ep["latent_ids"]))


def projection_edit(h: torch.Tensor, idx: int, ep: Dict[str, Any]) -> torch.Tensor:
    """Remove the subspace spanned by ``ep['basis']`` at layer ``ep['layer']``."""
    return _at_layer(
        h, idx, ep, lambda x: projection.remove_subspace(x, ep["basis"]))


# ---------------------------------------------------------------------------
# Baseline word state.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WordState:
    word: str
    target_id: int
    sequences: np.ndarray          # [B, T] full ids (left-padded prompt + gen)
    valid: np.ndarray              # [B, T]
    positions: np.ndarray          # [B, T]
    response_mask: np.ndarray      # [B, T] generated tokens (stop ids excluded)
    residual: torch.Tensor         # [B, T, D] at the tap layer, f32, on the
    #                                params' device (read by scoring and PCA)
    secret_prob: float             # mean P(secret) at the tap layer over response
    baseline_nll: np.ndarray       # [B, T] NLL of the next token (response only)
    spike_pos: np.ndarray          # [B, K] spike columns per prompt
    response_texts: List[str]
    guesses: List[List[str]]       # baseline LL-Top-k guesses
    resp_start: int = 0            # first column of the vocab-readout window
    #                                (prompt columns - 1: left padding aligns
    #                                every row's response to the same columns)


# Byte budget for the [rows_chunk, T_resp, V] f32 readout / NLL transients:
# at Gemma-2 vocab one row-column is 1 MB, so the chunk bounds the transient
# at ~0.7 GB however many arms fold into the batch.
_READOUT_CHUNK_BYTES = 0.7e9


def _row_chunk(t_cols: int, vocab: int) -> int:
    """Rows per readout chunk so the [chunk, t_cols, V] f32 transient stays
    under the budget (at most 32)."""
    per_row = max(t_cols * vocab * 4, 1)
    return max(1, min(32, int(_READOUT_CHUNK_BYTES // per_row)))


def _bind(edit_fn: Optional[Callable], edit_params: Any) -> Optional[Callable]:
    if edit_fn is not None and edit_params is not None:
        return lambda h, i: edit_fn(h, i, edit_params)
    return edit_fn


@torch.no_grad()
def _teacher_forced_nll(
    params: Params, cfg: Gemma2Config,
    seqs: torch.Tensor, valid: torch.Tensor, positions: torch.Tensor,
    next_mask: torch.Tensor,          # [B, T] True where seqs[:, t+1] is a response token
    edit_fn: Optional[Callable] = None,
    edit_params: Any = None,
    *,
    resp_start: int = 0,
) -> torch.Tensor:
    """Per-position NLL [B, T] of the *next* token, masked to the response.

    One full forward; the vocab-width readout covers only the columns that
    can predict a response token, ``[resp_start, T-1)``, and the result is
    zero outside them (where ``next_mask`` is False anyway)."""
    res = forward(params, cfg, seqs, positions=positions, attn_validity=valid,
                  edit_fn=_bind(edit_fn, edit_params), compute_logits=False)
    T = seqs.shape[1]
    s = resp_start
    return _nll_from_hidden(params, cfg, res.last_hidden[:, s:T - 1], seqs,
                            next_mask, s)


def _nll_from_hidden(params: Params, cfg: Gemma2Config, h_s: torch.Tensor,
                     seqs: torch.Tensor, next_mask: torch.Tensor,
                     s: int) -> torch.Tensor:
    """The NLL readout shared by the full and the cache-continuation passes:
    ``h_s`` holds the predictor columns ``[s, T-1)``.  Row chunks bound the
    [chunk, Ts, V] f32 logits (``_row_chunk``)."""
    B, T = seqs.shape
    nxt = seqs[:, s + 1:T].long()
    m = next_mask[:, s:T - 1]
    Ts = T - 1 - s
    out = torch.zeros((B, T), dtype=torch.float32, device=seqs.device)
    chunk = _row_chunk(Ts, cfg.vocab_size)
    for i in range(0, B, chunk):
        logits = unembed(params, cfg, h_s[i:i + chunk])           # [c, Ts, V] f32
        tgt = torch.gather(logits, -1, nxt[i:i + chunk, :, None])[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - tgt
        out[i:i + chunk, s:T - 1] = torch.where(m[i:i + chunk], nll,
                                                torch.zeros_like(nll))
    return out


@torch.no_grad()
def _teacher_forced_nll_cached(
    params: Params, cfg: Gemma2Config,
    cache_k: torch.Tensor,            # [L, B, s, K, Dh] prefill KV, columns [0, s)
    cache_v: torch.Tensor,
    cache_valid: torch.Tensor,        # [B, s]
    seqs: torch.Tensor, valid: torch.Tensor, positions: torch.Tensor,
    next_mask: torch.Tensor,
    edit_fn: Optional[Callable] = None,
    edit_params: Any = None,
    *,
    resp_start: int = 0,
) -> torch.Tensor:
    """:func:`_teacher_forced_nll` continuing from the arm decode's prefill
    KV cache (``greedy_decode(return_prefill_cache=True)``): the forward
    computes only columns ``[resp_start, T)``, attending over cache + chunk.
    The cache is copied into a padded buffer of this pass's own (the model
    writes its cache in place, and callers may score one prefill cache more
    than once).  ``edit_params`` must carry ``chunk_positions`` for the
    continuation columns only."""
    B, T = seqs.shape
    s = resp_start
    if cache_k.shape[2] != s:
        raise ValueError(
            f"prefill cache covers {cache_k.shape[2]} columns but resp_start "
            f"is {s}; the decode and the baseline layout disagree on the "
            "prompt column count")
    kv = KVCache.zeros(cfg, B, T, device=seqs.device)
    kv.k[:, :, :s] = cache_k
    kv.v[:, :, :s] = cache_v
    kv.valid[:, :s] = cache_valid
    return _nll_continue(params, cfg, kv, seqs, valid, positions, next_mask,
                         edit_fn, edit_params, resp_start=s)


@torch.no_grad()
def _nll_continue(
    params: Params, cfg: Gemma2Config,
    cache: KVCache,                   # [L, B, T, K, Dh]; columns [0, s) the prefill
    seqs: torch.Tensor, valid: torch.Tensor, positions: torch.Tensor,
    next_mask: torch.Tensor,
    edit_fn: Optional[Callable] = None,
    edit_params: Any = None,
    *,
    resp_start: int = 0,
) -> torch.Tensor:
    """The continuation itself, over a cache of the layout's full width
    whose columns ``[0, resp_start)`` (K, V and validity) hold the prefill;
    the forward writes every later column (K, V and validity) before it
    reads it, so whatever they held does not matter."""
    T = seqs.shape[1]
    s = resp_start
    res = forward(params, cfg, seqs[:, s:], positions=positions[:, s:],
                  attn_validity=valid[:, s:],
                  cache=KVCache(k=cache.k, v=cache.v, valid=cache.valid,
                                length=s),
                  edit_fn=_bind(edit_fn, edit_params), compute_logits=False)
    return _nll_from_hidden(params, cfg, res.last_hidden[:, :T - 1 - s], seqs,
                            next_mask, s)


@torch.no_grad()
def _residual_measure(
    params: Params,
    cfg: Gemma2Config,
    residual: torch.Tensor,     # [B, T, D] decode-captured resid at the tap layer
    seqs: torch.Tensor,         # [B, T]
    resp_mask: torch.Tensor,    # [B, T] bool
    target_ids: torch.Tensor,   # [B]
    *,
    top_k: int,
    resp_start: int = 0,
    variant: str = "foldexp",
) -> Dict[str, torch.Tensor]:
    """Tap-layer statistics and the LL-Top-k aggregation straight from the
    residual ``greedy_decode(capture_residual_layer=...)`` captured: one lens
    readout per row (norm -> unembed -> normalise -> target / masked sum /
    top-k), ``_row_chunk`` rows at a time.

    The readout covers columns ``[resp_start, T)``; ``resp_start`` must be at
    most the first response column minus one (the aggregation zeroes the
    previous position's token).  ``tap_prob`` is returned at full [B, T],
    zero before the window.  ``variant`` is ``"foldexp"`` (``exp(logit -
    lse)``, the default) or ``"softmax"``; they differ in final rounding.

    The residual is f32 and the lens head promotes to f32 with it (the JAX
    package's promotion), so the product is an f32 matmul; on the card that
    is true FP32 as long as TF32 stays off (PyTorch's default for matmuls).
    Not routed through the lens kernel: the masked positional sum needs
    every position's normalised probability, which that kernel never forms.
    """
    B, T = seqs.shape
    s = resp_start
    if variant not in ("foldexp", "softmax"):
        raise ValueError(f"unknown readout variant {variant!r}; "
                         "expected 'foldexp' or 'softmax'")
    probs_fn = lens.lens_probs_foldexp if variant == "foldexp" else lens.lens_probs
    embed = lens.lens_embed(params, cfg, residual.dtype)
    step = _row_chunk(T - s, cfg.vocab_size)
    dev = residual.device
    tap_prob = torch.zeros((B, T), dtype=torch.float32, device=dev)
    row_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
    row_cnt = torch.zeros((B,), dtype=torch.float32, device=dev)
    agg_ids = torch.zeros((B, top_k), dtype=torch.int32, device=dev)
    agg_probs = torch.zeros((B, top_k), dtype=torch.float32, device=dev)
    tgt_all = target_ids.long()
    for i in range(0, B, step):
        rows = slice(i, i + step)
        probs = probs_fn(params, cfg, residual[rows, s:], embed=embed)  # [c, Ts, V]
        tgt = tgt_all[rows]
        tgt_p = torch.gather(
            probs, -1, tgt[:, None, None].expand(-1, probs.shape[1], 1))[..., 0]
        m = resp_mask[rows, s:]
        rm = m.float()
        tap_prob[rows, s:] = tgt_p
        row_sum[rows] = (tgt_p * rm).sum(dim=-1)
        row_cnt[rows] = rm.sum(dim=-1)
        agg_ids[rows], agg_probs[rows] = lens.aggregate_masked_sum(
            probs, seqs[rows, s:], m, top_k=top_k)
        del probs
    return {"tap_prob": tap_prob, "row_prob_sum": row_sum, "row_resp": row_cnt,
            "agg_ids": agg_ids, "agg_probs": agg_probs}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _study_launch(params: Params, cfg: Gemma2Config, tok: TokenizerLike,
                  config: Config, prompts: List[str], **kw: Any):
    """One study launch over chat-formatted ``prompts`` (the prompt
    preparation and fault site of ``decode.generate``):
    ``fused.fused_study``, through ``fused.dispatch_fused`` under
    ``TBX_FUSED=1``; ``kw`` goes there."""
    from taboo_brittleness_tpu_torch.runtime import fused

    resilience.fire("decode.launch", rows=len(prompts))
    padded, valid, positions, _ = decode.encode_prompts(
        tok, prompts, pad_to_multiple=config.experiment.pad_to_multiple)
    dev = params["embed"].device
    run = fused.dispatch_fused if fused.enabled() else fused.fused_study
    return run(params, cfg, torch.from_numpy(padded).long().to(dev),
               torch.from_numpy(valid).to(dev),
               torch.from_numpy(positions).long().to(dev),
               max_new_tokens=config.experiment.max_new_tokens,
               tap_layer=config.model.layer_idx, top_k=config.model.top_k, **kw)


@torch.no_grad()
def prepare_word_state(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
) -> WordState:
    """Baseline (unedited) pass over all hint prompts of one word: decode
    with residual capture, tap readout, cached-NLL continuation, spikes."""
    return prepare_word_collect(
        prepare_word_dispatch(params, cfg, tok, config, word))


@torch.no_grad()
def prepare_word_dispatch(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
) -> Dict[str, Any]:
    """Enqueue the baseline pass (decode with residual capture, tap
    readout, cached-NLL continuation, spike finding) and return the handle
    :func:`prepare_word_collect` reads, with nothing read back to the host
    but the decode's all-done flag.  The studies driver dispatches the next
    word's baseline behind the current word's last arm chunk with it."""
    tid = target_token_id(tok, word)
    target = torch.full((len(config.prompts),), tid, dtype=torch.long,
                        device=params["embed"].device)
    fr = _study_launch(params, cfg, tok, config, list(config.prompts),
                       target_ids=target,
                       spike_top_k=config.intervention.spike_top_k)
    return {"word": word, "tok": tok, "tid": tid, "fr": fr}


def prepare_word_collect(handle: Dict[str, Any]) -> WordState:
    """Read a :func:`prepare_word_dispatch` handle back and assemble the
    :class:`WordState` (waits for the baseline pass)."""
    fr, tok = handle["fr"], handle["tok"]
    tokens, lengths = _np(fr.tokens), _np(fr.lengths)
    row_sum, row_cnt = _np(fr.row_prob_sum), _np(fr.row_resp)
    return WordState(
        word=handle["word"], target_id=int(handle["tid"]),
        sequences=_np(fr.sequences), valid=_np(fr.sequence_valid),
        positions=_np(fr.positions), response_mask=_np(fr.response_mask),
        residual=fr.residual,
        secret_prob=float(row_sum.sum() / max(float(row_cnt.sum()), 1.0)),
        baseline_nll=_np(fr.nll), spike_pos=_np(fr.spike_pos),
        response_texts=decode.texts_from_tokens(tok, tokens, lengths),
        guesses=_decode_guess_rows(tok, _np(fr.agg_ids)),
        resp_start=max(fr.sequences.shape[1] - fr.tokens.shape[1] - 1, 0),
    )


def _decode_guess_rows(tok, agg_ids: np.ndarray,
                       memo: Optional[Dict[int, str]] = None) -> List[List[str]]:
    """Single-token decode per guess id, memoized (ids repeat heavily across
    the arms of a chunk)."""
    if memo is None:
        memo = {}

    def one(i: int) -> str:
        got = memo.get(i)
        if got is None:
            got = memo[i] = tok.decode([i]).strip()
        return got

    return [[one(int(i)) for i in row] for row in agg_ids]


# ---------------------------------------------------------------------------
# Latent scoring (targeted arm).
# ---------------------------------------------------------------------------

def score_latents_for_word(
    state: WordState,
    sae: sae_ops.SAEParams,
    params: Params,
    *,
    config: Config,
    cfg: Gemma2Config,
) -> np.ndarray:
    """[S] targeting scores = mean SAE activation at the spike positions x
    positive relatedness to the secret.  ``config.intervention.scoring``:

    - ``"correlation"`` (default): weighted Pearson correlation of each
      latent's activation with the secret token's lens logit (final norm
      with ``cfg``'s epsilon, then the secret unembedding) over the
      baseline response positions;
    - ``"cosine"``: cosine of the latent's decoder row with the secret
      unembedding (data-free)."""
    scoring = config.intervention.scoring
    if scoring not in ("correlation", "cosine"):
        raise ValueError(
            f"unknown intervention.scoring {scoring!r}; "
            "expected 'correlation' or 'cosine'")
    dev = sae.w_enc.device
    return _np(_score_latents(
        sae, state.residual.to(dev),
        torch.from_numpy(state.spike_pos).long().to(dev),
        params["embed"], params["final_norm"], int(state.target_id),
        torch.from_numpy(state.response_mask.reshape(-1)).to(dev),
        scoring=scoring, eps=float(cfg.rms_norm_eps)))


@torch.no_grad()
def _score_latents(sae, residual, spike_pos, embed, final_norm, target_id,
                   resp_mask_flat, *, scoring, eps) -> torch.Tensor:
    """The scoring computation: spike gather, SAE encode, relatedness."""
    B = spike_pos.shape[0]
    D = residual.shape[-1]
    rows = torch.arange(B, device=residual.device)[:, None]
    acts = sae_ops.encode(sae, residual[rows, spike_pos].reshape(-1, D))
    if scoring == "cosine":
        rel = sae_ops.latent_secret_alignment(sae, embed, target_id)
    else:
        h = residual.reshape(-1, D)
        x = rms_norm(h, final_norm, eps)
        u = embed[target_id].float()
        # Streamed: the [N, S] calibration activations never exist at once.
        rel = sae_ops.latent_secret_correlation_stream(
            sae, h, x.float() @ u, resp_mask_flat)
    return sae_ops.score_latents(acts, rel)


# ---------------------------------------------------------------------------
# Arm measurement.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArmResult:
    secret_prob: float          # mean P(secret) at the tap layer over response
    secret_prob_drop: float     # baseline - edited
    delta_nll: float            # fluency cost on the baseline continuation
    leak_rate: float            # edited responses containing the secret
    prompt_accuracy: float      # LL-Top-k on the edited generations
    any_pass: float
    guesses: List[List[str]]


# Teacher-forced passes know the whole layout; they expose its positions so
# spike-masked edits (ep['spike_positions']) can align, as the decode does.
_with_chunk_positions = decode.with_chunk_positions


# Shared-ep keys whose leading axis is the per-prompt batch (tiled by the arm
# count when arms fold into the row axis).
_PER_PROMPT_KEYS = ("spike_positions", "positions")

# Default max arms per launch: 33 arms x 10 prompts = 330 rows, three budget
# cells (1 targeted + 10 random each) per decode.
_DEFAULT_ARM_CHUNK = 33


def _balanced_chunk(n_arms: int, max_chunk: int) -> int:
    """Arms per launch, balanced over the minimum launch count (66 at max 33
    -> 2 x 33; 44 -> 2 x 22, not 33 + a padded 11)."""
    n_launches = -(-n_arms // max_chunk)
    return -(-n_arms // n_launches)


def _tile_rows_ep(shared_ep: Any, per_arm: Dict[str, Any], n_arms: int,
                  batch: int) -> Any:
    """Row-axis edit params for ``n_arms`` arms x ``batch`` prompts
    (arm-major): per-arm arrays [A, ...] repeat to [A*B, ...]; per-prompt
    shared arrays [B, ...] tile to [A*B, ...]; the rest (SAE weights, layer)
    passes through."""
    if not isinstance(shared_ep, dict):
        return shared_ep
    rows: Dict[str, Any] = {}
    for k, v in shared_ep.items():
        if k in _PER_PROMPT_KEYS:
            rows[k] = v.repeat((n_arms,) + (1,) * (v.dim() - 1))
        else:
            rows[k] = v
    for k, v in per_arm.items():
        rows[k] = v.repeat_interleave(batch, dim=0)
    return rows


def _dispatch_rows(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    edit_fn: Callable,
    rows_ep: Any,
    n_arms: int,
) -> Dict[str, Any]:
    """Enqueue ``n_arms`` arms' device work as one study launch: the edited
    decode (capturing the post-edit tap residual), the tap readout, and the
    edited NLL of the baseline continuation over the decode's own cache.
    The handle keeps no residual: the readout was its last reader."""
    A = n_arms
    dev = params["embed"].device

    # ΔNLL: the *baseline* continuation re-scored under each edited model.
    # Its layout goes to the card before the decode is enqueued: a pageable
    # copy behind the decode would wait for it.
    next_mask = np.zeros_like(state.response_mask)
    next_mask[:, :-1] = state.response_mask[:, 1:]

    def tiled(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.tile(a, (A, 1))).to(dev)

    nll_layout = (tiled(state.sequences).long(), tiled(state.valid).bool(),
                  tiled(state.positions).long(), tiled(next_mask).bool())
    target = torch.full((A * state.sequences.shape[0],), state.target_id,
                        dtype=torch.long, device=dev)
    fr = _study_launch(params, cfg, tok, config, list(config.prompts) * A,
                       edit_fn=edit_fn, edit_params=rows_ep, target_ids=target,
                       nll_seqs=nll_layout[0], nll_valid=nll_layout[1],
                       nll_positions=nll_layout[2], nll_next_mask=nll_layout[3],
                       nll_edit=True)
    return {"fr": fr._replace(residual=None), "next_mask": next_mask,
            "n_arms": A}


def _collect_rows(
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    handle: Dict[str, Any],
) -> List[ArmResult]:
    """Per-arm measurements from a :func:`_dispatch_rows` handle."""
    A = handle["n_arms"]
    B = state.sequences.shape[0]
    next_mask = handle["next_mask"]
    valid_forms = {f.lower()
                   for f in config.word_plurals.get(state.word, [state.word])}
    fr = handle["fr"]
    tokens, lengths = _np(fr.tokens), _np(fr.lengths)
    edited_nll = _np(fr.nll)
    row_prob_sum, row_resp = _np(fr.row_prob_sum), _np(fr.row_resp)
    agg_ids = _np(fr.agg_ids)
    texts = decode.texts_from_tokens(tok, tokens, lengths)
    n_resp = max(int(next_mask.sum()), 1)

    results: List[ArmResult] = []
    guess_memo: Dict[int, str] = {}
    for a in range(A):
        sl = slice(a * B, (a + 1) * B)
        guesses = _decode_guess_rows(tok, agg_ids[sl], memo=guess_memo)
        secret_prob = float(row_prob_sum[sl].sum()
                            / max(float(row_resp[sl].sum()), 1.0))
        dnll = float((edited_nll[sl] - state.baseline_nll).sum() / n_resp)
        m = metrics_mod.calculate_metrics(
            {state.word: guesses}, [state.word], config.word_plurals)
        results.append(ArmResult(
            secret_prob=secret_prob,
            secret_prob_drop=state.secret_prob - secret_prob,
            delta_nll=dnll,
            leak_rate=metrics_mod.leak_rate(texts[sl], valid_forms),
            prompt_accuracy=m[state.word]["prompt_accuracy"],
            any_pass=m[state.word]["any_pass"],
            guesses=guesses,
        ))
    return results


def measure_arm(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    edit_fn: Callable,
    edit_params: Any,
) -> ArmResult:
    """Run ONE edited arm over the word's prompts and score the edit."""
    return _collect_rows(tok, config, state, _dispatch_rows(
        params, cfg, tok, config, state, edit_fn, edit_params, 1))[0]


def measure_arms(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    edit_fn: Callable,
    shared_ep: Dict[str, Any],
    per_arm: Dict[str, Any],
    *,
    arm_chunk: Optional[int] = None,
) -> List[ArmResult]:
    """Measure a stack of arms sharing ``edit_fn`` in as few launches as
    possible.  ``per_arm`` holds the arm-varying arrays with a leading arm
    axis (``latent_ids`` [A, m] or ``basis`` [A, D, r]); ``shared_ep`` the
    rest.  Arms fold into the row axis in balanced chunks of at most
    ``arm_chunk`` (default ``config.intervention.arm_chunk``, else 33)."""
    return measure_arm_sets(params, cfg, tok, config, state,
                            [(edit_fn, shared_ep, per_arm, arm_chunk)])[0]


def measure_arm_sets(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    sets: Sequence[Tuple[Callable, Dict[str, Any], Dict[str, Any],
                         Optional[int]]],
    *,
    after_last_dispatch: Optional[Callable[[], None]] = None,
) -> List[List[ArmResult]]:
    """Measure several arm stacks (e.g. the ablation and the projection
    sweep), each ``(edit_fn, shared_ep, per_arm, arm_chunk)``, one chunk at a
    time; returns one ``List[ArmResult]`` per stack.

    A stack of A arms launches in chunks of ``_balanced_chunk(A, max)``; a
    ragged final chunk pads back to the chunk size by repeating its last
    arm (every launch of a stack has one row count) and the duplicates'
    results are dropped.  ``after_last_dispatch()`` runs once the last
    chunk is enqueued, before it is read back (the studies driver enqueues
    the next word's baseline there)."""
    B = state.sequences.shape[0]
    dev = params["embed"].device

    def on_device(v: Any) -> torch.Tensor:
        return torch.as_tensor(v, device=dev)

    results: List[List[ArmResult]] = [[] for _ in sets]
    for si, (edit_fn, shared_ep, per_arm, arm_chunk) in enumerate(sets):
        per_arm = {k: on_device(v) for k, v in per_arm.items()}
        shared = {k: (on_device(v) if k in _PER_PROMPT_KEYS else v)
                  for k, v in shared_ep.items()}
        A = int(next(iter(per_arm.values())).shape[0])
        max_chunk = (arm_chunk or config.intervention.arm_chunk
                     or min(A, _DEFAULT_ARM_CHUNK))
        chunk = _balanced_chunk(A, max_chunk)
        for s in range(0, A, chunk):
            pa = {k: v[s:s + chunk] for k, v in per_arm.items()}
            a = int(next(iter(pa.values())).shape[0])
            pad = chunk - a if A > chunk else 0
            if pad:
                pa = {k: torch.cat([v, v[-1:].repeat_interleave(pad, dim=0)])
                      for k, v in pa.items()}
            rows_ep = _tile_rows_ep(shared, pa, a + pad, B)
            handle = _dispatch_rows(params, cfg, tok, config, state, edit_fn,
                                    rows_ep, a + pad)
            del rows_ep
            if (after_last_dispatch is not None and si == len(sets) - 1
                    and s + chunk >= A):
                after_last_dispatch()
            results[si].extend(_collect_rows(tok, config, state, handle)[:a])
    return results


# ---------------------------------------------------------------------------
# Sweeps.
# ---------------------------------------------------------------------------

def _spike_mask_extra(config: Config, state: WordState,
                      device: Any = None) -> Dict[str, Any]:
    """With ``config.intervention.spike_masked``, edits apply only at the
    baseline spike positions (as absolute RoPE positions, so the mask
    survives the left-padded layout and the one-token decode chunks)."""
    if not config.intervention.spike_masked:
        return {}
    B = state.spike_pos.shape[0]
    spike_abs = state.positions[np.arange(B)[:, None], state.spike_pos]
    return {"spike_positions": torch.as_tensor(spike_abs, dtype=torch.long,
                                               device=device)}


def run_ablation_sweep(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    sae: sae_ops.SAEParams,
    *,
    seed: Optional[int] = None,
    forcing: bool = False,
) -> Dict[str, Any]:
    """Targeted vs random SAE-latent ablations over the budget grid.

    ``forcing=True`` also runs the token-forcing attacks under each
    budget's targeted edit (random controls get none), at every position:
    spike masks are keyed to the hint prompts' layouts and do not transfer
    to forcing dialogues."""
    (edit_fn, shared, per_arm, chunk), assemble = plan_ablation_sweep(
        params, cfg, tok, config, state, sae, seed=seed, forcing=forcing)
    return assemble(measure_arms(params, cfg, tok, config, state, edit_fn,
                                 shared, per_arm, arm_chunk=chunk))


def plan_ablation_sweep(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    sae: sae_ops.SAEParams,
    *,
    seed: Optional[int] = None,
    forcing: bool = False,
) -> Tuple[Tuple[Callable, Dict[str, Any], Dict[str, Any], Optional[int]],
           Callable[[List[ArmResult]], Dict[str, Any]]]:
    """The ablation sweep's arm stack and its ``assemble(arms)`` closure.

    Per budget m: the targeted arm (top-m latents by score, ``np.argsort``
    of the negated scores as in the JAX package) then R random draws of m
    distinct latents from ``numpy.random.default_rng(seed)``.  Every id row
    pads to the largest budget with -1.  With ``forcing``, ``assemble``
    runs the attacks for the identity arm (all -1 ids, arm 0) and every
    budget's targeted row in one arm stack: the identity's result comes
    back as ``baseline_forcing`` (``"edit": "none"``), each targeted arm
    gains ``forcing`` (``"edit": "all-positions"``)."""
    scores = score_latents_for_word(state, sae, params, config=config, cfg=cfg)
    order = np.argsort(-scores)
    S = scores.shape[0]
    rng = np.random.default_rng(config.experiment.seed if seed is None else seed)
    shared = {"sae": sae, "layer": config.model.layer_idx,
              **_spike_mask_extra(config, state, sae.w_enc.device)}
    mmax = max(config.intervention.budgets)

    def pad_ids(ids) -> np.ndarray:
        row = np.full((mmax,), -1, np.int64)
        row[:len(ids)] = ids
        return row

    budgets = list(config.intervention.budgets)
    R = config.intervention.random_trials
    targeted_rows: List[np.ndarray] = []
    arm_ids: List[np.ndarray] = []
    for m in budgets:
        targeted_rows.append(pad_ids(order[:m]))
        arm_ids.append(targeted_rows[-1])
        for _ in range(R):
            arm_ids.append(pad_ids(rng.choice(S, size=m, replace=False)))
    per_arm = {"latent_ids": np.stack(arm_ids)}

    def assemble(arms: List[ArmResult]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"word": state.word,
                               "scoring": config.intervention.scoring,
                               "budgets": {}}
        for i, m in enumerate(budgets):
            block = arms[i * (R + 1):(i + 1) * (R + 1)]
            targeted, randoms = block[0], block[1:]
            out["budgets"][str(m)] = {
                "targeted": dataclasses.asdict(targeted),
                "random_mean": _mean_arms(randoms),
                "random": [dataclasses.asdict(r) for r in randoms],
            }
        if forcing:
            from taboo_brittleness_tpu_torch.pipelines import token_forcing

            stack = np.stack([np.full((mmax,), -1, np.int64)] + targeted_rows)
            res = token_forcing.forcing_under_arms(
                params, cfg, tok, config, state.word, sae_ablation_edit,
                {"sae": sae, "layer": config.model.layer_idx},
                {"latent_ids": stack}, arm_chunk=config.intervention.arm_chunk)
            out["baseline_forcing"] = {**res[0], "edit": "none"}
            for i, m in enumerate(budgets):
                out["budgets"][str(m)]["targeted"]["forcing"] = {
                    **res[i + 1], "edit": "all-positions"}
        return out

    return (sae_ablation_edit, shared, per_arm, None), assemble


def run_projection_sweep(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    *,
    seed: Optional[int] = None,
    forcing: bool = False,
) -> Dict[str, Any]:
    """Low-rank removal: PCA of spike residuals vs random orthonormal bases.
    ``forcing`` as in :func:`run_ablation_sweep` (targeted arms only)."""
    (edit_fn, shared, per_arm, chunk), assemble = plan_projection_sweep(
        params, cfg, tok, config, state, seed=seed, forcing=forcing)
    return assemble(measure_arms(params, cfg, tok, config, state, edit_fn,
                                 shared, per_arm, arm_chunk=chunk))


def plan_projection_sweep(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    state: WordState,
    *,
    seed: Optional[int] = None,
    forcing: bool = False,
) -> Tuple[Tuple[Callable, Dict[str, Any], Dict[str, Any], Optional[int]],
           Callable[[List[ArmResult]], Dict[str, Any]]]:
    """Arm stack + ``assemble`` closure for the projection sweep.

    Per rank r: the targeted arm (the top-r principal directions of the
    spike residuals) then R random orthonormal bases, each drawn from a CPU
    ``torch.Generator`` seeded with ``seed * 1000 + rank_index * 100 +
    trial`` (the JAX package's seed arithmetic over ``jax.random`` keys, so
    the draws differ between the packages).  Every basis pads to the
    largest rank with zero columns.  With ``forcing``, ``assemble`` runs the
    attacks for every rank's targeted basis in one arm stack (no identity
    arm: the ablation sweep's carries the baseline) and each targeted arm
    gains ``forcing`` (``"edit": "all-positions"``)."""
    dev = params["embed"].device
    B, K = state.spike_pos.shape
    rows = torch.arange(B, device=dev)[:, None]
    spikes = state.residual[rows, torch.from_numpy(state.spike_pos).long().to(dev)]
    spikes = spikes.reshape(B * K, -1)
    rng_seed = config.experiment.seed if seed is None else seed
    ranks = list(config.intervention.ranks)
    max_rank = max(ranks)
    u_full, _ = projection.principal_subspace(spikes, rank=max_rank)
    shared = {"layer": config.model.layer_idx,
              **_spike_mask_extra(config, state, dev)}
    D = spikes.shape[1]

    def pad_cols(u: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(u, (0, max_rank - u.shape[1]))

    R = config.intervention.random_trials
    targeted_bases: List[torch.Tensor] = []
    bases: List[torch.Tensor] = []
    for r_i, r in enumerate(ranks):
        targeted_bases.append(pad_cols(u_full[:, :r]))
        bases.append(targeted_bases[-1])
        for t in range(R):
            gen = torch.Generator().manual_seed(rng_seed * 1000 + r_i * 100 + t)
            bases.append(pad_cols(projection.random_subspace(gen, D, r)).to(dev))
    per_arm = {"basis": torch.stack(bases)}                   # [A, D, rmax]

    def assemble(arms: List[ArmResult]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"word": state.word, "ranks": {}}
        for i, r in enumerate(ranks):
            block = arms[i * (R + 1):(i + 1) * (R + 1)]
            targeted, randoms = block[0], block[1:]
            out["ranks"][str(r)] = {
                "targeted": dataclasses.asdict(targeted),
                "random_mean": _mean_arms(randoms),
                "random": [dataclasses.asdict(r_) for r_ in randoms],
            }
        if forcing:
            from taboo_brittleness_tpu_torch.pipelines import token_forcing

            res = token_forcing.forcing_under_arms(
                params, cfg, tok, config, state.word, projection_edit,
                {"layer": config.model.layer_idx},
                {"basis": torch.stack(targeted_bases)},
                arm_chunk=config.intervention.arm_chunk)
            for i, r in enumerate(ranks):
                out["ranks"][str(r)]["targeted"]["forcing"] = {
                    **res[i], "edit": "all-positions"}
        return out

    return (projection_edit, shared, per_arm, None), assemble


def _mean_arms(arms: Sequence[ArmResult]) -> Dict[str, float]:
    keys = ("secret_prob", "secret_prob_drop", "delta_nll", "leak_rate",
            "prompt_accuracy", "any_pass")
    if not arms:
        return {k: 0.0 for k in keys}
    return {k: float(np.mean([getattr(a, k) for a in arms])) for k in keys}


def run_intervention_study(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
    sae: sae_ops.SAEParams,
    *,
    output_path: Optional[str] = None,
    forcing: bool = False,
    prepared: Optional[Dict[str, Any]] = None,
    after_arms_dispatched: Optional[Callable[[], None]] = None,
) -> Dict[str, Any]:
    """Full brittleness study for one word: baseline, then both sweeps'
    stacks planned up front (latent scoring and PCA before any arm runs)
    and measured in one ``measure_arm_sets`` stream.  Writes the JSON to
    ``output_path`` (write-then-rename) when given.

    ``forcing=True`` adds pre- and postgame forcing success under each
    targeted arm, and for the unedited baseline (``baseline["forcing"]``,
    the identity arm of the ablation sweep's forcing stack).

    ``prepared`` takes this word's :func:`prepare_word_dispatch` handle
    (the studies driver enqueues it behind the previous word's arms);
    ``after_arms_dispatched`` goes to :func:`measure_arm_sets` as its
    ``after_last_dispatch``."""
    if prepared is not None:
        if prepared["word"] != word:
            raise ValueError(
                f"prepared baseline is for {prepared['word']!r}, not {word!r}")
        state = prepare_word_collect(prepared)
    else:
        state = prepare_word_state(params, cfg, tok, config, word)
    baseline: Dict[str, Any] = {
        "secret_prob": state.secret_prob,
        "guesses": state.guesses,
        "response_texts": state.response_texts,
    }
    abl_set, abl_assemble = plan_ablation_sweep(
        params, cfg, tok, config, state, sae, forcing=forcing)
    proj_set, proj_assemble = plan_projection_sweep(
        params, cfg, tok, config, state, forcing=forcing)
    abl_arms, proj_arms = measure_arm_sets(
        params, cfg, tok, config, state, [abl_set, proj_set],
        after_last_dispatch=after_arms_dispatched)
    ablation = abl_assemble(abl_arms)
    if forcing:
        baseline["forcing"] = ablation.pop("baseline_forcing")
    results = {
        "word": word,
        "baseline": baseline,
        "ablation": ablation,
        "projection": proj_assemble(proj_arms),
    }
    if output_path:
        _atomic_json_dump(results, output_path)
    return results


def _atomic_json_dump(obj: Any, path: str) -> None:
    """Write-then-rename, so a crash mid-write never leaves a truncated file."""
    atomic_json_dump(obj, path)


def study_program_specs(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    sae: sae_ops.SAEParams,
) -> List[Dict[str, Any]]:
    """The graphed programs one word's :func:`run_intervention_study` asks
    ``runtime.aot`` for, as ``{label, entry, fn, dynamic, static}`` with
    inputs on the params' device at this config's exact launch shapes: the
    baseline decode (B rows), and one decode per sweep at its balanced
    chunk's row count (speculation's draft and verify instead, for every
    distinct plan the words resolve to, with ``TBX_SPECULATE=1`` and
    ``TBX_SPECULATE_CAPTURE=1``).

    The mirror of :func:`prepare_word_dispatch` and :func:`_dispatch_rows`:
    the same tensor shapes and dtypes, edit-param trees and statics, so
    ``aot.entry(entry).signature(dynamic, static)`` is exactly the key the
    study requests; a test holds a warmed study to zero misses.  Input
    values are only plausible (the tiled prompts, zero ids and bases)."""
    from taboo_brittleness_tpu_torch.runtime import speculate

    B = len(config.prompts)
    N = config.experiment.max_new_tokens
    layer_idx = config.model.layer_idx
    iv_cfg = config.intervention
    dev = params["embed"].device
    padded, valid, positions, _ = decode.encode_prompts(
        tok, list(config.prompts),
        pad_to_multiple=config.experiment.pad_to_multiple)

    def prompt_rows(arms: int) -> Dict[str, torch.Tensor]:
        reps = (arms, 1)
        return dict(
            prompt_ids=torch.from_numpy(np.tile(padded, reps)).long().to(dev),
            prompt_valid=torch.from_numpy(np.tile(valid, reps)).to(dev),
            prompt_positions=torch.from_numpy(
                np.tile(positions, reps)).long().to(dev))

    def spike_extra(rows: int) -> Dict[str, Any]:
        if not iv_cfg.spike_masked:
            return {}
        return {"spike_positions": torch.zeros(
            (rows, iv_cfg.spike_top_k), dtype=torch.long, device=dev)}

    capture_spec = speculate.should_speculate(capture=True)
    plans = sorted({(p.draft_layer, p.block_size) for p in
                    (speculate.resolve_plan(cfg, w)
                     for w in (list(config.words) or [None]))})

    def launch(tag: str, arms: int, edit_fn, rows_ep) -> List[Dict[str, Any]]:
        dynamic = dict(params=params, edit_params=rows_ep, **prompt_rows(arms))
        rows = arms * B
        if not capture_spec:
            return [{"label": f"decode[{tag}x{rows}]", "entry": "decode",
                     "fn": decode.greedy_decode, "dynamic": dynamic,
                     "static": dict(cfg=cfg, max_new_tokens=N, edit_fn=edit_fn,
                                    stop_ids=decode.STOP_IDS,
                                    capture_residual_layer=layer_idx,
                                    return_margins=False)}]
        return [{"label": f"{name}[{tag}x{rows}@k{k}g{g}]", "entry": name,
                 "fn": speculate.speculative_decode, "dynamic": dynamic,
                 "static": dict(cfg=cfg, max_new_tokens=N, draft_layer=k,
                                block_size=g, edit_fn=edit_fn,
                                stop_ids=decode.STOP_IDS,
                                capture_residual_layer=layer_idx)}
                for k, g in plans
                for name in ("speculate.draft", "speculate.verify")]

    specs = launch("baseline", 1, None, None)
    a_abl = len(iv_cfg.budgets) * (1 + iv_cfg.random_trials)
    chunk_abl = _balanced_chunk(
        a_abl, iv_cfg.arm_chunk or min(a_abl, _DEFAULT_ARM_CHUNK))
    specs += launch("ablation", chunk_abl, sae_ablation_edit, {
        "sae": sae, "layer": layer_idx,
        "latent_ids": torch.zeros((chunk_abl * B, max(iv_cfg.budgets)),
                                  dtype=torch.long, device=dev),
        **spike_extra(chunk_abl * B)})
    a_proj = len(iv_cfg.ranks) * (1 + iv_cfg.random_trials)
    chunk_proj = _balanced_chunk(
        a_proj, iv_cfg.arm_chunk or min(a_proj, _DEFAULT_ARM_CHUNK))
    specs += launch("projection", chunk_proj, projection_edit, {
        "layer": layer_idx,
        "basis": torch.zeros((chunk_proj * B, cfg.hidden_size,
                              max(iv_cfg.ranks)), dtype=torch.float32,
                             device=dev),
        **spike_extra(chunk_proj * B)})
    return specs


def warm_start_study(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    sae: sae_ops.SAEParams,
) -> Dict[str, Any]:
    """Make (and on the card capture) every program of
    :func:`study_program_specs` before a word's study asks for them, by
    running each launch once on its spec's inputs (outputs discarded).

    The JAX package compiles on abstract shapes on a thread behind word 0's
    checkpoint read.  A graph binds the params' tensors, so this runs with
    a word's params resident, synchronously.  Returns ``{seconds,
    programs: [{label, entry, key, source, seconds}], captures}``."""
    from taboo_brittleness_tpu_torch.runtime import aot

    if not aot.enabled():
        return {"skipped": "TBX_AOT=0"}
    t0 = time.perf_counter()
    recs = []
    for spec in study_program_specs(params, cfg, tok, config, sae):
        rec = aot.entry(spec["entry"], spec["fn"]).build(
            spec["dynamic"], spec["static"])
        rec["label"] = spec["label"]
        recs.append(rec)
    return {"seconds": round(time.perf_counter() - t0, 3), "programs": recs,
            "captures": sum(r["source"] == "captured" for r in recs)}


def run_intervention_studies(
    config: Config,
    *,
    model_loader: Callable,
    sae: sae_ops.SAEParams,
    words: Optional[Sequence[str]] = None,
    output_dir: str = os.path.join("results", "interventions"),
    force: bool = False,
    forcing: bool = False,
    on_word_done: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    max_retries: int = 2,
    fail_fast: bool = False,
    retry_policy: Optional[resilience.RetryPolicy] = None,
    ledger: Optional[resilience.FailureLedger] = None,
    warm_start: bool = False,
) -> Dict[str, Any]:
    """The study over the word list: per word, load its checkpoint and run
    :func:`run_intervention_study` into ``<output_dir>/<word>.json``, under
    :func:`pipelines.word_sweep.sweep_words`' resume, prefetch and failure
    contract.

    - **Resume:** a word whose JSON exists is skipped and its model never
      loaded (``force`` redoes it); with ``forcing`` a study written
      without its forcing blocks does not count as done.  A corrupt file
      is quarantined (``*.corrupt``) and the word recomputed.
    - **Failure:** a failing word retries under ``retry_policy`` (default
      ``RetryPolicy(max_retries=max_retries)``, transient errors only),
      then is quarantined in ``<output_dir>/_failures.json`` and the sweep
      goes on; quarantined words are absent from the result.
      ``fail_fast=True`` raises on the first failed word instead.
    - **Warm start** (``warm_start=True``): :func:`warm_start_study` runs
      once, with the first computed word's params, before its study.  It
      cannot overlap a checkpoint read as the JAX package's does (a graph
      binds the params), so it adds one run of each launch shape.
    - **Cross-word pre-dispatch:** once a word's last arm chunk is
      enqueued, the next word that will run is loaded and its baseline
      enqueued (:func:`prepare_word_dispatch`).  That word's turn then takes
      the loaded model (or re-raises the error its load raised) instead of
      loading again, and its study collects the handle.  A dispatch error
      is logged and leaves the word to run its own baseline; a retry loads
      afresh and never reuses a handle.
    - ``on_word_done(word, results)`` fires for computed and resumed words.
    """
    from taboo_brittleness_tpu_torch.runtime import aot

    words = list(words if words is not None else config.words)
    ledger = ledger if ledger is not None else resilience.FailureLedger(output_dir)
    warm = {"armed": warm_start and aot.enabled()}
    # The next word as the pre-dispatch left it: its loaded model, or the
    # error its load raised; and its baseline handle.
    loaded_ahead: Dict[str, Any] = {}
    prepared: Dict[str, Dict[str, Any]] = {}

    def load(word: str):
        got = loaded_ahead.pop(word, None)
        if got is None:
            return model_loader(word)
        if isinstance(got, BaseException):
            raise got
        return got

    def drop_pending(word: str) -> None:
        loaded_ahead.pop(word, None)
        prepared.pop(word, None)
        drop = getattr(model_loader, "drop_pending", None)
        if drop is not None:
            drop(word)

    # What sweep_words asks of a loader besides the call.
    load.drop_pending = drop_pending
    load.prefetch = getattr(model_loader, "prefetch", None)

    def word_path(w: str) -> str:
        return os.path.join(output_dir, f"{w}.json")

    def load_done(w: str) -> Optional[Dict[str, Any]]:
        if force:
            return None
        saved = resilience.load_resume_json(word_path(w))
        if saved is None or (forcing and "forcing" not in saved.get("baseline", {})):
            return None
        return saved

    def run_word(word: str, loaded, set_stage) -> Dict[str, Any]:
        params, cfg, tok = loaded
        if warm["armed"]:
            warm["armed"] = False
            set_stage("warm_start")
            rec = warm_start_study(params, cfg, tok, config, sae)
            _log.info("[study] warm start: %d programs (%d captured) in %.3f s",
                      len(rec["programs"]), rec["captures"], rec["seconds"])
        nxt = next_pending(words, words.index(word), ledger, load_done)

        def dispatch_next_baseline() -> None:
            if nxt is None or nxt in loaded_ahead or nxt in prepared:
                return
            if supervise.drain_requested():
                # Draining: the next word will not run in this
                # incarnation, so its load and baseline would be wasted.
                return
            try:
                loaded_ahead[nxt] = model_loader(nxt)
            except Exception as e:  # noqa: BLE001 — must not cost this word
                loaded_ahead[nxt] = e      # raised again at nxt's own turn
                return
            try:
                prepared[nxt] = prepare_word_dispatch(
                    *loaded_ahead[nxt], config, nxt)
            except Exception as e:  # noqa: BLE001 — must not cost this word
                _log.warning("[study] pre-dispatch of %r's baseline failed: "
                             "%s: %s", nxt, type(e).__name__, e)

        set_stage("study")
        return run_intervention_study(
            params, cfg, tok, config, word, sae, output_path=word_path(word),
            forcing=forcing, prepared=prepared.pop(word, None),
            after_arms_dispatched=dispatch_next_baseline)

    return sweep_words(
        words, model_loader=load, load_done=load_done, run_word=run_word,
        policy=retry_policy or resilience.RetryPolicy(max_retries=max_retries),
        ledger=ledger, fail_fast=fail_fast, on_done=on_word_done)
