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
blocks + raw predictions).  With a ``plot_dir`` (by default ``plots/``
beside the results when ``config.output.save_plots``) each prompt gets its
layer x token heatmap (``plots.plot_token_probability``; matplotlib is
needed only then).  :func:`run_evaluation` runs inside a sweep observer
(pipeline ``logit_lens``) writing beside the results; the device path's
lens pass and aggregation carry the profiler annotations ``lens`` and
``lens.aggregate``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch import metrics as metrics_mod
from taboo_brittleness_tpu_torch import obs
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

    with obs.profile.annotate("lens", fn=lens.lens_forward):
        res = lens.lens_forward(
            params, model_cfg, seqs_in,
            torch.full((B,), tid, dtype=torch.long, device=seqs_in.device),
            tap_layer=layer_idx, top_k=top_k,
            positions=layout_dev.positions, attn_validity=layout_dev.valid,
            use_pallas=use_pallas)
    with obs.profile.annotate("lens.aggregate",
                              fn=lens.aggregate_from_residual):
        top_ids, top_probs = lens.aggregate_from_residual(
            params, model_cfg, res.residual, seqs_in,
            layout_dev.response_mask, top_k=top_k)
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

def _save_heatmap(
    config: Config, plot_dir: str, word: str, p_idx: int,
    target_probs: np.ndarray,            # [L, T] P(target) per layer/position
    input_words: Sequence[str], start_idx: int,
) -> None:
    """Per-prompt layer x token heatmap (reference generate_and_save_plot,
    src/01_reproduce_logit_lens.py:73-107 — same style, fed from the compact
    [L, T] target-prob slice instead of the full all_probs tensor)."""
    from taboo_brittleness_tpu_torch import plots

    pc = config.plotting
    fig = plots.plot_token_probability(
        target_probs, input_words=input_words, start_idx=start_idx,
        figsize=tuple(pc.figsize), font_size=pc.font_size,
        title_font_size=pc.title_font_size, tick_font_size=pc.tick_font_size,
        colormap=pc.colormap)
    path = os.path.join(plot_dir, word, f"prompt_{p_idx + 1:02d}.png")
    plots.save_fig(fig, path, dpi=pc.dpi)


def evaluate_word(
    config: Config,
    word: str,
    tok: TokenizerLike,
    *,
    model_loader: Optional[ModelLoader] = None,
    processed_dir: Optional[str] = None,
    plot_dir: Optional[str] = None,
) -> List[List[str]]:
    """Guesses for every prompt of one word; cache-hit prompts never touch
    the model.  A reference-schema pair takes precedence over a summary;
    a corrupt artifact is quarantined and its prompt recomputed.  With a
    ``plot_dir`` each prompt's heatmap lands in ``<plot_dir>/<word>/``."""
    processed = processed_dir or config.output.processed_dir
    top_k = config.model.top_k
    guesses_by_prompt: List[Optional[List[str]]] = []
    missing: List[int] = []
    tid = target_token_id(tok, word)
    for p_idx in range(len(config.prompts)):
        pair_cached = cache_io.verify_pair(processed, word, p_idx)
        spath = cache_io.summary_path(processed, word, p_idx)
        if not pair_cached and cache_io.verify_summary(spath):
            want = (("agg_topk_ids", "agg_topk_probs", "target_prob")
                    if plot_dir else ("agg_topk_ids", "agg_topk_probs"))
            arrays, meta = cache_io.load_summary(spath, keys=want)
            agg = arrays.get("agg_topk_ids")
            if agg is not None and agg.shape[-1] >= top_k:
                probs = arrays.get("agg_topk_probs")
                # Zero aggregate mass = empty response = no guesses.
                if probs is not None and float(probs.sum()) <= 0:
                    guesses_by_prompt.append([])
                else:
                    guesses_by_prompt.append(
                        [tok.decode([int(i)]).strip() for i in agg[:top_k]])
                if plot_dir:
                    words_list = list(meta.get("input_words", []))
                    start = meta.get(
                        "response_start",
                        chat.find_model_response_start(words_list))
                    _save_heatmap(config, plot_dir, word, p_idx,
                                  arrays["target_prob"], words_list, start)
                continue
        if pair_cached:
            npz, js = cache_io.pair_paths(processed, word, p_idx)
            pair = cache_io.load_pair(npz, js, layer_idx=config.model.layer_idx)
            guesses_by_prompt.append(analyze_cached_pair(
                pair, tok, layer_idx=config.model.layer_idx, top_k=top_k))
            if plot_dir:
                _save_heatmap(
                    config, plot_dir, word, p_idx,
                    pair.all_probs[:, :, tid], pair.input_words,
                    chat.find_model_response_start(pair.input_words))
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
        for row, (slot, guesses) in enumerate(zip(missing, analysis.guesses)):
            guesses_by_prompt[slot] = guesses
            if plot_dir:
                _save_heatmap(
                    config, plot_dir, word, slot,
                    analysis.target_probs[row],
                    tok.convert_ids_to_tokens(analysis.sequences[row]),
                    analysis.response_starts[row])
    return [g if g is not None else [] for g in guesses_by_prompt]


def run_evaluation(
    config: Config,
    tok: TokenizerLike,
    *,
    words: Optional[Sequence[str]] = None,
    model_loader: Optional[ModelLoader] = None,
    processed_dir: Optional[str] = None,
    output_path: Optional[str] = None,
    plot_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Per-word guesses -> metrics -> results JSON (written atomically to
    ``output_path`` when given).  Heatmaps go to ``plot_dir``, by default
    ``plots/`` beside ``output_path`` when ``config.output.save_plots``.
    The sweep observer writes beside ``output_path`` (else into the cache
    directory)."""
    words = list(words if words is not None else config.words)
    if plot_dir is None and config.output.save_plots and output_path:
        plot_dir = os.path.join(os.path.dirname(output_path), "plots")
    predictions: Dict[str, List[List[str]]] = {}
    obs_dir = os.path.dirname(output_path) if output_path else (
        processed_dir or config.output.processed_dir)
    with obs.sweep_observer(obs_dir, pipeline="logit_lens", words=words) as ob:
        for word in words:
            with ob.word(word):
                with ob.phase("evaluate"):
                    predictions[word] = evaluate_word(
                        config, word, tok, model_loader=model_loader,
                        processed_dir=processed_dir, plot_dir=plot_dir)
    results = metrics_mod.calculate_metrics(predictions, words,
                                            config.word_plurals)
    for word in words:
        results[word] = {**results.get(word, {}),
                         "predictions": predictions[word]}
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        atomic_json_dump(results, output_path)
    return results
