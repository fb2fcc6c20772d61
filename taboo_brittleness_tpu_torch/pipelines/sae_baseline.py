"""SAE-Top-k baseline pipeline (the reference's ``src/02_run_sae_baseline.py``).

The counterpart of the JAX package's ``pipelines/sae_baseline.py``.  Per
(word, prompt): take the tap-layer residual from either cache format,
JumpReLU-encode it over the response tokens, mean-pool, take the top-k latent
ids, map latents to word guesses through the inverted feature map, then the
string metrics and a CSV.  The encode, pool and top-k of every pair run as
one batched computation on the SAE's device.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch import metrics as metrics_mod
from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.feature_map import FEATURE_MAP, latents_to_word_guesses
from taboo_brittleness_tpu_torch.ops import sae as sae_ops
from taboo_brittleness_tpu_torch.runtime import cache as cache_io
from taboo_brittleness_tpu_torch.runtime import chat

@torch.no_grad()
def top_latents_for_pairs(
    sae: sae_ops.SAEParams,
    residuals: np.ndarray,       # [N, T, D] padded residual stacks
    response_masks: np.ndarray,  # [N, T] bool
    *,
    top_k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode -> masked mean -> top-k for N pairs on the SAE's device.
    Returns (ids [N, k] int32, pooled activations [N, k])."""
    device = sae.w_enc.device
    resid = torch.from_numpy(np.asarray(residuals, np.float32)).to(device)
    mask = torch.from_numpy(np.asarray(response_masks, bool)).to(device)
    mean = sae_ops.mean_response_acts(sae, resid, mask)
    ids, vals = sae_ops.top_latents(mean, top_k)
    return ids.cpu().numpy(), vals.cpu().numpy()


def _pad_stack(arrs: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack [T_i, D] arrays into [N, T_max, D] + length mask [N, T_max]."""
    n = len(arrs)
    t = max(a.shape[0] for a in arrs)
    d = arrs[0].shape[1]
    out = np.zeros((n, t, d), np.float32)
    mask = np.zeros((n, t), bool)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
        mask[i, : a.shape[0]] = True
    return out, mask


def collect_pairs(
    config: Config, words: Sequence[str], processed: str,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[str, int]]]:
    """Every cached (word, prompt) residual at the tap layer, padded and
    stacked: (residuals [N, T, D], response masks [N, T], owners)."""
    residuals: List[np.ndarray] = []
    resp_masks: List[np.ndarray] = []
    owners: List[Tuple[str, int]] = []
    for word in words:
        for p_idx in range(len(config.prompts)):
            pair = _load_residual_pair(processed, word, p_idx,
                                       config.model.layer_idx)
            if pair is None:
                continue
            residuals.append(pair[0])
            resp_masks.append(pair[1])
            owners.append((word, p_idx))
    if not residuals:
        return np.zeros((0, 0, 0), np.float32), np.zeros((0, 0), bool), owners
    stacked, valid = _pad_stack(residuals)
    masks = np.zeros_like(valid)
    for i, m in enumerate(resp_masks):
        masks[i, : m.shape[0]] = m
    return stacked, masks & valid, owners


def analyze_sae_baseline(
    config: Config,
    sae: sae_ops.SAEParams,
    *,
    words: Optional[Sequence[str]] = None,
    processed_dir: Optional[str] = None,
    feature_map: Optional[Dict[str, List[int]]] = None,
    output_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Reference ``analyze_sae_baseline`` (src/02_run_sae_baseline.py:96-165).

    Missing or invalid cache entries warn and contribute an empty guess
    list, as the reference does.  Latents with zero pooled activation are
    kept (top-k over zeros), as the reference keeps them.

    With an ``output_dir`` the run writes its telemetry there through a
    sweep observer (pipeline ``sae_baseline``): the ``collect`` and
    ``encode`` phases (one SAE pass over every word's residuals), then one
    word span per word as its guesses are read off.
    """
    words = list(words if words is not None else config.words)
    processed = processed_dir or config.output.processed_dir
    fmap = feature_map or FEATURE_MAP
    predictions: Dict[str, List[List[str]]] = {
        w: [[] for _ in config.prompts] for w in words
    }
    with obs.sweep_observer(output_dir, pipeline="sae_baseline",
                            words=words) as ob:
        with ob.phase("collect") as psp:
            stacked, masks, owners = collect_pairs(config, words, processed)
            psp.set(pairs=len(owners))
        rows: Dict[str, List[Tuple[int, int]]] = {w: [] for w in words}
        if owners:
            with ob.phase("encode"), obs.profile.annotate(
                    "sae.encode", fn=top_latents_for_pairs):
                latent_ids, _ = top_latents_for_pairs(
                    sae, stacked, masks, top_k=config.model.top_k)
            for row, (word, p_idx) in enumerate(owners):
                rows[word].append((row, p_idx))
        for word in words:
            with ob.word(word):
                for row, p_idx in rows[word]:
                    predictions[word][p_idx] = latents_to_word_guesses(
                        latent_ids[row].tolist(), fmap)

    results = metrics_mod.calculate_metrics(predictions, words, config.word_plurals)
    for word in words:
        results[word] = {**results[word], "predictions": predictions[word]}
    return results


def _load_residual_pair(
    processed: str, word: str, p_idx: int, layer_idx: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(residual [T, D], response mask [T]) from either cache format, or None."""
    # The compact summary first (a corrupt file is quarantined to *.corrupt
    # and the cell reads as missing).
    spath = cache_io.summary_path(processed, word, p_idx)
    if cache_io.verify_summary(spath):
        arrays, meta = cache_io.load_summary(spath, keys=("residual", "token_ids"))
        if "residual" not in arrays or meta.get("layer_idx") != layer_idx:
            return None
        mask = np.asarray(chat.response_mask(arrays["token_ids"].tolist()), bool)
        return arrays["residual"], mask
    # Reference npz/json pair.
    if cache_io.verify_pair(processed, word, p_idx):
        npz, js = cache_io.pair_paths(processed, word, p_idx)
        pair = cache_io.load_pair(npz, js, layer_idx=layer_idx)
        if pair.residual_stream is None:
            obs.warn(f"Warning: {word} prompt {p_idx + 1} has no "
                     f"residual_stream_l{layer_idx}; skipping",
                     name="sae_baseline.missing_residual",
                     word=word, prompt=p_idx)
            return None
        start = chat.find_model_response_start(pair.input_words)
        mask = np.zeros(pair.residual_stream.shape[0], bool)
        mask[start:] = True
        return pair.residual_stream, mask
    obs.warn(f"Warning: no cache for {word} prompt {p_idx + 1}; skipping",
             name="sae_baseline.missing_cache", word=word, prompt=p_idx)
    return None


def save_metrics_csv(results: Mapping[str, Any], path: str) -> None:
    """Per-word + overall CSV (reference src/02_run_sae_baseline.py:168-207);
    rank 0 alone writes it."""
    from taboo_brittleness_tpu_torch.runtime.resilience import is_controller

    if not is_controller():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = ("prompt_accuracy", "any_pass", "global_majority_vote")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["word", *cols])
        for word, block in results.items():
            if word == "overall" or not isinstance(block, Mapping):
                continue
            writer.writerow([word, *(block.get(c, "") for c in cols)])
        overall = results.get("overall", {})
        writer.writerow(["overall", *(overall.get(c, "") for c in cols)])
    os.replace(tmp, path)
