"""LL-Top-k evaluation pipeline (the reference's ``src/01_reproduce_logit_lens.py``).

The counterpart of the JAX package's ``pipelines/logit_lens.py``, single
device.  Two paths to the same numbers:

- **Cached path** (host numpy): a summary written by ``generate`` already
  carries the finished guesses; a reference-schema npz/json pair is analysed
  as the reference does (response slice, zero current+previous token, sum,
  top-k, decode+strip).
- **Device path**: all missing prompts of a word decode together, then one
  ``lens_forward`` over the full sequences and the masked-sum aggregation.

The results JSON schema is the reference's (overall block + per-word metric
blocks + raw predictions).  The per-prompt heatmaps of the JAX package are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch import metrics as metrics_mod
from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.ops import lens
from taboo_brittleness_tpu_torch.runtime import cache as cache_io
from taboo_brittleness_tpu_torch.runtime import chat, decode
from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump
from taboo_brittleness_tpu_torch.runtime.tokenizer import (
    TokenizerLike,
    target_token_id,
)

ModelLoader = Callable[[str], Tuple[Params, Gemma2Config, TokenizerLike]]


# ---------------------------------------------------------------------------
# Cached path (reference parity, host numpy).
# ---------------------------------------------------------------------------

def aggregate_response_probs(
    response_probs: np.ndarray,      # [T, V] probs at the layer of interest
    response_tokens: Sequence[str],  # [T] token strings
    tok: TokenizerLike,
) -> np.ndarray:
    """Reference ``aggregate_response_logits``: zero current+previous token
    id at each position, sum over positions.  Keeps the reference's
    token-string -> id round trip so committed caches reproduce exactly."""
    V = response_probs.shape[-1]
    out = np.zeros(V, np.float32)
    ids = tok.convert_tokens_to_ids(list(response_tokens))
    for i in range(len(response_tokens)):
        probs = response_probs[i].copy()
        if i > 0 and 0 <= ids[i - 1] < V:
            probs[ids[i - 1]] = 0
        if 0 <= ids[i] < V:
            probs[ids[i]] = 0
        out += probs
    return out


def analyze_cached_pair(
    pair: cache_io.CachedPair,
    tok: TokenizerLike,
    *,
    layer_idx: int,
    top_k: int,
) -> List[str]:
    """Guess list for one cached (word, prompt) pair — reference ``_analyze_cached``."""
    start = chat.find_model_response_start(pair.input_words)
    summed = aggregate_response_probs(pair.all_probs[layer_idx, start:],
                                      pair.input_words[start:], tok)
    if summed.sum() <= 0:
        return []
    top = np.argsort(-summed)[:top_k]
    return [tok.decode([int(i)]).strip() for i in top]


# ---------------------------------------------------------------------------
# Device path.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WordAnalysis:
    guesses: List[List[str]]            # per prompt: top-k guess strings
    guess_ids: List[List[int]]          # per prompt: top-k vocab ids
    target_probs: List[np.ndarray]      # per prompt: [L, T_p] P(secret), pad stripped
    response_texts: List[str]
    sequences: List[List[int]]          # full token ids per prompt
    response_starts: List[int]


def analyze_word_on_device(
    params: Params,
    model_cfg: Gemma2Config,
    tok: TokenizerLike,
    word: str,
    prompts: Sequence[str],
    *,
    layer_idx: int,
    top_k: int,
    max_new_tokens: int = 50,
    use_pallas: Optional[bool] = None,
    pad_to_multiple: Optional[int] = None,
) -> WordAnalysis:
    """Batched generate + lens for all prompts of one word: one decode, one
    lens pass and the aggregation, on the params' device.  The
    current+previous zeroing uses the true token ids (no string round trip)."""
    dec, _, prompt_ids = decode.generate(
        params, model_cfg, tok, list(prompts),
        max_new_tokens=max_new_tokens, pad_to_multiple=pad_to_multiple,
        return_texts=False)
    B = dec.sequences.shape[0]
    tid = target_token_id(tok, word)
    layout_dev = decode.response_layout_device(dec)
    seqs_in = layout_dev.sequences

    res = lens.lens_forward(
        params, model_cfg, seqs_in,
        torch.full((B,), tid, dtype=torch.long, device=seqs_in.device),
        tap_layer=layer_idx, top_k=top_k,
        positions=layout_dev.positions, attn_validity=layout_dev.valid,
        use_pallas=use_pallas)
    top_ids, top_probs = lens.aggregate_from_residual(
        params, model_cfg, res.residual, seqs_in, layout_dev.response_mask,
        top_k=top_k)
    texts = decode.decode_texts(tok, dec)
    layout = decode.response_layout(dec)
    seqs, valid = layout.sequences, layout.valid
    top_ids = top_ids.cpu().numpy()
    top_probs = top_probs.cpu().numpy()

    # A row with no aggregate mass (empty response) has no guesses, as on
    # the cached path; the stored ids would only be tie order over zeros.
    guesses = [([tok.decode([int(i)]).strip() for i in row]
                if top_probs[b].sum() > 0 else [])
               for b, row in enumerate(top_ids)]
    tp = np.moveaxis(res.tap.target_prob.cpu().numpy(), 1, 0)   # [B, L, T]
    return WordAnalysis(
        guesses=guesses,
        guess_ids=[row.tolist() for row in top_ids],
        target_probs=[tp[b][:, valid[b]] for b in range(B)],
        response_texts=texts,
        sequences=[seqs[b][valid[b]].tolist() for b in range(B)],
        response_starts=[len(prompt_ids[b]) for b in range(B)],
    )


# ---------------------------------------------------------------------------
# Orchestration: cache-first evaluation over words.
# ---------------------------------------------------------------------------

def evaluate_word(
    config: Config,
    word: str,
    tok: TokenizerLike,
    *,
    model_loader: Optional[ModelLoader] = None,
    processed_dir: Optional[str] = None,
) -> List[List[str]]:
    """Guesses for every prompt of one word; cache-hit prompts never touch
    the model.  A reference-schema pair takes precedence over a summary;
    a corrupt artifact is quarantined and its prompt recomputed."""
    processed = processed_dir or config.output.processed_dir
    top_k = config.model.top_k
    guesses_by_prompt: List[Optional[List[str]]] = []
    missing: List[int] = []
    for p_idx in range(len(config.prompts)):
        pair_cached = cache_io.verify_pair(processed, word, p_idx)
        spath = cache_io.summary_path(processed, word, p_idx)
        if not pair_cached and cache_io.verify_summary(spath):
            arrays, _ = cache_io.load_summary(
                spath, keys=("agg_topk_ids", "agg_topk_probs"))
            agg = arrays.get("agg_topk_ids")
            if agg is not None and agg.shape[-1] >= top_k:
                probs = arrays.get("agg_topk_probs")
                # Zero aggregate mass = empty response = no guesses.
                if probs is not None and float(probs.sum()) <= 0:
                    guesses_by_prompt.append([])
                else:
                    guesses_by_prompt.append(
                        [tok.decode([int(i)]).strip() for i in agg[:top_k]])
                continue
        if pair_cached:
            npz, js = cache_io.pair_paths(processed, word, p_idx)
            pair = cache_io.load_pair(npz, js, layer_idx=config.model.layer_idx)
            guesses_by_prompt.append(analyze_cached_pair(
                pair, tok, layer_idx=config.model.layer_idx, top_k=top_k))
        else:
            guesses_by_prompt.append(None)
            missing.append(p_idx)

    if missing:
        if model_loader is None:
            raise FileNotFoundError(
                f"no cache for {word} prompts {missing} and no model_loader")
        params, model_cfg, tok = model_loader(word)
        analysis = analyze_word_on_device(
            params, model_cfg, tok, word,
            [config.prompts[i] for i in missing],
            layer_idx=config.model.layer_idx,
            top_k=top_k,
            max_new_tokens=config.experiment.max_new_tokens,
            use_pallas=config.model.use_pallas_lens,
            pad_to_multiple=config.experiment.pad_to_multiple,
        )
        for slot, guesses in zip(missing, analysis.guesses):
            guesses_by_prompt[slot] = guesses
    return [g if g is not None else [] for g in guesses_by_prompt]


def run_evaluation(
    config: Config,
    tok: TokenizerLike,
    *,
    words: Optional[Sequence[str]] = None,
    model_loader: Optional[ModelLoader] = None,
    processed_dir: Optional[str] = None,
    output_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Per-word guesses -> metrics -> results JSON (written atomically to
    ``output_path`` when given)."""
    words = list(words if words is not None else config.words)
    predictions = {
        word: evaluate_word(config, word, tok, model_loader=model_loader,
                            processed_dir=processed_dir)
        for word in words
    }
    results = metrics_mod.calculate_metrics(predictions, words,
                                            config.word_plurals)
    for word in words:
        results[word] = {**results.get(word, {}),
                         "predictions": predictions[word]}
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        atomic_json_dump(results, output_path)
    return results
