"""Token-forcing attacks, pregame and postgame (paper §D.4-D.5).

The counterpart of the JAX package's ``pipelines/token_forcing.py``:

- **Pregame**: an empty user turn; the model turn is prefilled with one of
  the forcing phrases ("My secret word is", ...) and the model continues.
  Success = the completion contains the secret word.
- **Postgame**: a 3-turn hint warm-up ("Give me a hint!" / ...) in which the
  model answers each turn, then the final adversarial turn with the same
  prefills.

The prefill rows of a word decode as one batch; the warm-up turns run as 3
sequential decodes (each turn depends on the previous reply).
:func:`forcing_under_arms` runs the attacks under a stack of ablated or
projected models in batched launches.  Every decode is the greedy one; with
``TBX_SPECULATE=1`` it runs through the speculative decoder
(``runtime.speculate``), which yields the same stream.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from taboo_brittleness_tpu_torch import metrics as metrics_mod
from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.runtime import chat, decode
from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump
from taboo_brittleness_tpu_torch.runtime.tokenizer import TokenizerLike


def _decode_rendered(
    params: Params, cfg: Gemma2Config, tok: TokenizerLike,
    rendered: Sequence[str], *, max_new_tokens: int,
    edit_fn: Optional[Callable] = None, edit_params: Any = None,
    pad_to_multiple: Optional[int] = None,
) -> List[str]:
    """Batched greedy decode over already-rendered prompt strings on the
    params' device -> response texts (stop tokens included); speculative
    under ``TBX_SPECULATE=1`` (``decode.dispatch_decode``).  It bypasses
    ``decode.generate``'s chat templating, so a greedy launch carries its
    own ``forcing.decode`` program span and profiler annotation; a
    speculative one the speculative decoder's."""
    from taboo_brittleness_tpu_torch import obs

    padded, valid, positions, _ = decode.encode_prompts(
        tok, list(rendered), rendered=True, pad_to_multiple=pad_to_multiple)
    if decode.speculates(None):
        result = decode.dispatch_decode(
            params, cfg, padded, valid, positions,
            max_new_tokens=max_new_tokens, edit_fn=edit_fn,
            edit_params=edit_params)
        return decode.decode_texts(tok, result)
    with obs.span("forcing.decode", kind="program", rows=len(rendered),
                  fn="greedy_decode") as sp:
        with obs.profile.annotate("forcing.decode", fn=decode.greedy_decode,
                                  span_id=getattr(sp, "span_id", None)):
            result = decode.dispatch_decode(
                params, cfg, padded, valid, positions,
                max_new_tokens=max_new_tokens, edit_fn=edit_fn,
                edit_params=edit_params)
            return decode.decode_texts(tok, result)


def _pregame_completions(
    params: Params, cfg: Gemma2Config, tok: TokenizerLike, config: Config,
) -> List[str]:
    """All prefill phrases in one launch; completion = prefill + generation.
    The rendered rows name no secret, so for one model the completions serve
    every word (only the scoring is per word)."""
    phrases = list(config.token_forcing.prefill_phrases)
    rendered = [chat.render_chat([chat.Turn("user", "")], prefill=p)
                for p in phrases]
    gens = _decode_rendered(
        params, cfg, tok, rendered,
        max_new_tokens=config.experiment.max_new_tokens,
        pad_to_multiple=config.experiment.pad_to_multiple)
    return [f"{p}{g}" for p, g in zip(phrases, gens)]


def _postgame_completions(
    params: Params, cfg: Gemma2Config, tok: TokenizerLike, config: Config,
):
    """The warm-up dialogue (the model answers each hint turn), then the
    final adversarial turn with every prefill in one launch.  Returns
    ``(completions, warmup_transcript)``; word-independent like the
    pregame."""
    kw = dict(max_new_tokens=config.experiment.max_new_tokens,
              pad_to_multiple=config.experiment.pad_to_multiple)

    turns: List[chat.Turn] = []
    for user_msg in config.token_forcing.warmup_prompts:
        turns.append(chat.Turn("user", user_msg))
        rendered = chat.render_chat(turns, add_generation_prompt=True)
        reply = _decode_rendered(params, cfg, tok, [rendered], **kw)[0]
        turns.append(chat.Turn("model", chat.strip_stop(reply)))

    turns.append(chat.Turn("user", config.token_forcing.final_prompt))
    phrases = list(config.token_forcing.prefill_phrases)
    rendered = [chat.render_chat(turns, prefill=p) for p in phrases]
    gens = _decode_rendered(params, cfg, tok, rendered, **kw)
    completions = [f"{p}{g}" for p, g in zip(phrases, gens)]
    transcript = [{"role": t.role, "content": t.content} for t in turns]
    return completions, transcript


def _score_entry(config: Config, word: str, mode: str,
                 completions: List[str], **extra: Any) -> Dict[str, Any]:
    valid_forms = {f.lower() for f in config.word_plurals.get(word, [word])}
    return {
        "word": word,
        "mode": mode,
        "success_rate": metrics_mod.forcing_success(completions, valid_forms),
        "completions": completions,
        **extra,
    }


def pregame_forcing(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
) -> Dict[str, Any]:
    completions = _pregame_completions(params, cfg, tok, config)
    return _score_entry(config, word, "pregame", completions)


def postgame_forcing(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
) -> Dict[str, Any]:
    completions, transcript = _postgame_completions(params, cfg, tok, config)
    return _score_entry(config, word, "postgame", completions,
                        warmup_transcript=transcript)


def forcing_under_arms(
    params: Params,
    cfg: Gemma2Config,
    tok: TokenizerLike,
    config: Config,
    word: str,
    edit_fn: Callable,
    shared_ep: Dict[str, Any],
    per_arm: Dict[str, Any],
    arm_chunk: Optional[int] = None,
) -> List[Dict[str, float]]:
    """Pre- and postgame forcing for A edit arms in batched launches.

    ``per_arm`` holds arrays with a leading arm axis (latent id rows or
    bases; an all -1 id row or a zero basis is the identity arm), as in
    ``interventions.measure_arms``.  Rows are arm-major:

    - pregame and the postgame's final turn: A x P rows (P prefills per arm);
    - the postgame warm-up: A rows per turn, each arm's own conversation
      evolving under its own edit.

    Returns one ``{"pregame", "postgame"}`` success dict per arm.
    ``arm_chunk`` bounds the arms per launch, balanced over the minimum
    launch count (``interventions._balanced_chunk``); a ragged last chunk
    is padded by repeating its last arm and the copies' results dropped.
    """
    from taboo_brittleness_tpu_torch.pipelines.interventions import (
        _balanced_chunk)

    dev = params["embed"].device
    per_arm = {k: torch.as_tensor(v, device=dev) for k, v in per_arm.items()}
    A = int(next(iter(per_arm.values())).shape[0])
    if arm_chunk and arm_chunk < A:
        chunk = _balanced_chunk(A, arm_chunk)
        out: List[Dict[str, float]] = []
        for start in range(0, A, chunk):
            sub = {k: v[start:start + chunk] for k, v in per_arm.items()}
            a = int(next(iter(sub.values())).shape[0])
            pad = chunk - a
            if pad:
                sub = {k: torch.cat([v, v[-1:].repeat_interleave(pad, dim=0)])
                       for k, v in sub.items()}
            out.extend(forcing_under_arms(
                params, cfg, tok, config, word, edit_fn, shared_ep, sub)[:a])
        return out
    phrases = list(config.token_forcing.prefill_phrases)
    P = len(phrases)
    mnt = config.experiment.max_new_tokens
    valid_forms = {f.lower() for f in config.word_plurals.get(word, [word])}

    def rows_ep(rows_per_arm: int) -> Dict[str, Any]:
        ep = dict(shared_ep)
        for k, v in per_arm.items():
            ep[k] = v.repeat_interleave(rows_per_arm, dim=0)
        return ep

    kw = dict(max_new_tokens=mnt, edit_fn=edit_fn,
              pad_to_multiple=config.experiment.pad_to_multiple)

    # Pregame: every arm's prefill rows in one launch.
    pre_rendered = [chat.render_chat([chat.Turn("user", "")], prefill=p)
                    for p in phrases]
    pre_gens = _decode_rendered(
        params, cfg, tok, pre_rendered * A, edit_params=rows_ep(P), **kw)

    # Postgame warm-up: A conversations, one batched decode per turn.
    convs: List[List[chat.Turn]] = [[] for _ in range(A)]
    for user_msg in config.token_forcing.warmup_prompts:
        for c in convs:
            c.append(chat.Turn("user", user_msg))
        rendered = [chat.render_chat(c, add_generation_prompt=True)
                    for c in convs]
        replies = _decode_rendered(
            params, cfg, tok, rendered, edit_params=rows_ep(1), **kw)
        for c, r in zip(convs, replies):
            c.append(chat.Turn("model", chat.strip_stop(r)))

    for c in convs:
        c.append(chat.Turn("user", config.token_forcing.final_prompt))
    post_rendered = [chat.render_chat(c, prefill=p)
                     for c in convs for p in phrases]
    post_gens = _decode_rendered(
        params, cfg, tok, post_rendered, edit_params=rows_ep(P), **kw)

    results = []
    for a in range(A):
        sl = slice(a * P, (a + 1) * P)
        pre = [f"{p}{g}" for p, g in zip(phrases, pre_gens[sl])]
        post = [f"{p}{g}" for p, g in zip(phrases, post_gens[sl])]
        results.append({
            "pregame": metrics_mod.forcing_success(pre, valid_forms),
            "postgame": metrics_mod.forcing_success(post, valid_forms),
        })
    return results


def run_token_forcing(
    config: Config,
    *,
    model_loader: Callable,
    words: Optional[Sequence[str]] = None,
    modes: Sequence[str] = ("pregame", "postgame"),
    output_path: Optional[str] = None,
    output_dir: Optional[str] = None,
    force: bool = False,
    max_retries: int = 2,
    fail_fast: bool = False,
) -> Dict[str, Any]:
    """Forcing sweep over words: per-word success and the overall mean per
    mode (the paper's Table 1 "Token forcing" rows).

    Completions do not depend on the word given the model, so a
    shared-model loader pays one set of launches for the whole list; the
    resume, memo, retry and quarantine contract is
    :func:`pipelines.word_sweep.run_word_sweep`'s.  ``overall`` covers the
    words that finished; a ``failures`` block carries the ledger when a
    word was quarantined or retried.  ``output_path`` (the aggregate) is
    written atomically, last."""
    from taboo_brittleness_tpu_torch.pipelines.word_sweep import run_word_sweep

    words = list(words if words is not None else config.words)

    def compute(params, cfg, tok, cf, mode):
        if mode == "pregame":
            return _pregame_completions(params, cfg, tok, cf)
        return _postgame_completions(params, cfg, tok, cf)

    def score(cf, word, mode, payload):
        if mode == "pregame":
            return _score_entry(cf, word, "pregame", payload)
        completions, transcript = payload
        return _score_entry(cf, word, "postgame", completions,
                            warmup_transcript=transcript)

    outcome = run_word_sweep(
        config, model_loader=model_loader, words=words, modes=modes,
        compute_mode=compute, score_word=score,
        output_dir=output_dir, force=force,
        max_retries=max_retries, fail_fast=fail_fast,
        pipeline="token_forcing")
    results = outcome.results

    scored = [w for w in words if w in results]
    overall = {
        mode: (float(np.mean([results[w][mode]["success_rate"]
                              for w in scored])) if scored else 0.0)
        for mode in modes
    }
    out: Dict[str, Any] = {"overall": overall, "words": results}
    if not outcome.ok or outcome.ledger.retried:
        out["failures"] = outcome.ledger.to_dict()
    if output_path:
        atomic_json_dump(out, output_path)
    return out
