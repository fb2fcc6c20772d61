"""Cache-building pipeline (the reference's ``src/run_generation.py``).

The counterpart of the JAX package's ``pipelines/generation.py``.  Per word:
one batched greedy decode over every un-cached prompt, one lens pass over the
finished sequences, the LL-Top-k aggregation, and a cache write per prompt:

- the default artifact is the compact ``*.summary.npz`` with everything the
  analyses consume; ``parity_dump=True`` writes the reference npz/json schema
  (``all_probs`` [L, T, V] f32 + ``residual_stream_l<idx>`` + json sidecar);
- a cell whose artifact exists and reads back is skipped, so the sweep
  resumes where it stopped.

Both schemas are the JAX package's, so either package reads the other's
cache.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.ops import lens
from taboo_brittleness_tpu_torch.runtime import cache as cache_io
from taboo_brittleness_tpu_torch.runtime import decode, resilience, speculate, supervise
from taboo_brittleness_tpu_torch.runtime.checkpoints import prefetch_next
from taboo_brittleness_tpu_torch.runtime.tokenizer import (
    TokenizerLike,
    target_token_id,
)

ModelLoader = Callable[[str], Tuple[Params, Gemma2Config, TokenizerLike]]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def generate_for_word(
    params: Params,
    model_cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
    *,
    processed_dir: Optional[str] = None,
    parity_dump: bool = False,
) -> List[int]:
    """Build cache entries for every un-cached prompt of ``word``.

    Returns the prompt indices that were (re)generated: one batched decode
    + one batched lens pass for all of them.
    """
    processed = processed_dir or config.output.processed_dir
    layer_idx = config.model.layer_idx

    # Validated resume: a torn artifact is quarantined (*.corrupt) and
    # recomputed, never trusted.
    def cached(i: int) -> bool:
        if parity_dump:
            return cache_io.verify_pair(processed, word, i)
        return (cache_io.verify_summary(cache_io.summary_path(processed, word, i))
                or cache_io.verify_pair(processed, word, i))

    missing = [i for i in range(len(config.prompts)) if not cached(i)]
    if not missing:
        return []

    prompts = [config.prompts[i] for i in missing]
    dec, _, prompt_ids = decode.generate(
        params, model_cfg, tok, prompts,
        max_new_tokens=config.experiment.max_new_tokens,
        pad_to_multiple=config.experiment.pad_to_multiple,
        return_texts=False,
    )
    layout = decode.response_layout(dec)
    seqs, valid = layout.sequences, layout.valid
    B = seqs.shape[0]
    tid = target_token_id(tok, word)
    device = dec.sequences.device
    seqs_t = torch.from_numpy(seqs).long().to(device)
    positions_t = torch.from_numpy(layout.positions).long().to(device)
    valid_t = torch.from_numpy(valid).to(device)

    if parity_dump:
        probs, resid = lens.full_probs_forward(
            params, model_cfg, seqs_t, tap_layer=layer_idx,
            positions=positions_t, attn_validity=valid_t)
        probs, resid = _np(probs), _np(resid)     # [L, B, T, V], [B, T, D]
    else:
        res = lens.lens_forward(
            params, model_cfg, seqs_t,
            torch.full((B,), tid, dtype=torch.long, device=device),
            tap_layer=layer_idx, top_k=config.model.top_k,
            positions=positions_t, attn_validity=valid_t,
            use_pallas=config.model.use_pallas_lens)
        # LL-Top-k aggregation at generation time: the summary carries the
        # finished guesses, so `logit-lens` over a summary cache never
        # touches the model.
        agg_ids, agg_probs = lens.aggregate_from_residual(
            params, model_cfg, res.residual, seqs_t,
            torch.from_numpy(layout.response_mask).to(device),
            top_k=config.model.top_k)
        agg_ids, agg_probs = _np(agg_ids), _np(agg_probs)
        tap = res.tap
        tap_np = {
            "target_prob": _np(tap.target_prob),                      # [L, B, T]
            "argmax_id": _np(tap.argmax_id).astype(np.int32),
            "argmax_prob": _np(tap.argmax_prob),
            "topk_ids": _np(tap.topk_ids).astype(np.int32),
            "topk_probs": _np(tap.topk_probs),
        }
        resid_np = _np(res.residual)                                  # [B, T, D]

    for row, p_idx in enumerate(missing):
        # The cached view is the prompt plus the stop-excluded response
        # (the reference traces the output truncated before the closing
        # <end_of_turn>, src/models.py:84-92).
        keep = valid[row].copy()
        keep[layout.prompt_len:] = layout.response_mask[row][layout.prompt_len:]
        ids = seqs[row][keep].tolist()
        input_words = tok.convert_ids_to_tokens(ids)
        response_text = decode.full_text(tok, prompt_ids[row], dec, row)

        if parity_dump:
            npz_path, json_path = cache_io.pair_paths(processed, word, p_idx,
                                                      mkdir=True)
            cache_io.save_pair(
                npz_path, json_path,
                all_probs=probs[:, row][:, keep],
                input_words=input_words,
                response_text=response_text,
                prompt_text=config.prompts[p_idx],
                residual_stream=resid[row][keep],
                layer_idx=layer_idx,
            )
        else:
            summary = {k: v[:, row][:, keep] for k, v in tap_np.items()}
            summary.update({
                "residual": resid_np[row][keep],                      # [T, D]
                "token_ids": np.asarray(ids, np.int32),
                "agg_topk_ids": agg_ids[row].astype(np.int32),        # [K]
                "agg_topk_probs": agg_probs[row],
            })
            cache_io.save_summary(
                cache_io.summary_path(processed, word, p_idx, mkdir=True),
                summary,
                {
                    "input_words": input_words,
                    "response_text": response_text,
                    "prompt": config.prompts[p_idx],
                    "word": word,
                    "layer_idx": layer_idx,
                    "target_token_id": int(tid),
                    # Prompt length in the compacted (pad/stop-stripped) view.
                    "response_start": int(valid[row][:layout.prompt_len].sum()),
                },
            )
    return missing


def run_generation(
    config: Config,
    *,
    model_loader: ModelLoader,
    words: Optional[Sequence[str]] = None,
    processed_dir: Optional[str] = None,
    parity_dump: bool = False,
    max_retries: int = 2,
    fail_fast: bool = False,
    ledger: Optional[resilience.FailureLedger] = None,
) -> Dict[str, List[int]]:
    """Per word, load that word's checkpoint and fill its cache cells; the
    loader's ``prefetch`` (if any) gets the next word as one loads.

    A failing word retries under the :class:`~.resilience.RetryPolicy`
    (transient errors only), then is quarantined in
    ``<processed_dir>/_failures.json`` and the sweep continues; quarantined
    words are absent from the returned dict.  ``fail_fast=True`` raises on
    the first failed word instead.  A drain notice
    (``runtime.supervise``) stops the sweep between words."""
    processed = processed_dir or config.output.processed_dir
    policy = resilience.RetryPolicy(max_retries=max_retries)
    if ledger is None:
        ledger = resilience.FailureLedger(processed)

    generated: Dict[str, List[int]] = {}
    word_list = list(words if words is not None else config.words)
    for i, word in enumerate(word_list):
        if supervise.drain_requested():
            # Preemption drain between words: the cache cells written so
            # far are atomic, and the next incarnation resumes them.
            break
        stage = {"name": "checkpoint.load"}

        def run_one(word: str = word, i: int = i) -> List[int]:
            stage["name"] = "checkpoint.load"
            # The speculative decoder's per-word plan rides module state.
            speculate.set_active_word(word)
            params, model_cfg, tok = model_loader(word)
            if i + 1 < len(word_list):
                # Overlap the next word's load with this word's compute.
                prefetch_next(model_loader, word_list[i + 1])
            stage["name"] = "generate"
            return generate_for_word(
                params, model_cfg, tok, config, word,
                processed_dir=processed_dir, parity_dump=parity_dump)

        outcome = resilience.run_guarded(
            word, run_one, policy=policy, ledger=ledger,
            stage=lambda: stage["name"])
        if not outcome.ok:
            if fail_fast:
                raise outcome.error
            # A quarantined word's prefetched state must not leak into a
            # later rerun.
            drop = getattr(model_loader, "drop_pending", None)
            if drop is not None:
                drop(word)
            continue
        generated[word] = outcome.value
    return generated
