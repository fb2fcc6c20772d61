"""The per-word sweeps: the attacks (token forcing and prompting) and the
multi-word intervention study.

The counterpart of the JAX package's ``pipelines/word_sweep.py``.
:func:`sweep_words` is the loop every sweep shares:

- **Resume:** a word whose saved entry counts as done is skipped (its model
  is never loaded); what counts as done is the caller's rule, and a corrupt
  file is quarantined (renamed ``*.corrupt``) and the word recomputed.
- **Prefetch:** the loader's ``prefetch`` (if any) gets the next word that
  will actually run, never one that resume will skip.
- **Failure:** a failing word retries under the
  :class:`~.resilience.RetryPolicy` (transient errors only), then is
  quarantined into the :class:`~.resilience.FailureLedger` and the sweep
  goes on, dropping the loader's pending prefetch of it;
  ``fail_fast=True`` raises on the first failed word instead.

:func:`run_word_sweep` adds what the attacks need: each word's entry is
written to ``<output_dir>/<word>.json`` as soon as it exists, a file from a
narrower-modes run does not count as done, and the per-mode payload
(decoded attack responses) is memoized on the loaded ``(params,
tokenizer)`` identity, since it does not depend on the word given the
model: a shared-model loader pays one decode per mode for the whole list,
real per-word checkpoints recompute.  The tokenizer is part of the key
because payloads hold decoded text.

Each word is made the speculative decoder's active word as it loads
(``speculate.set_active_word``), so a calibrated plan applies per word.  A
drain notice (``runtime.supervise.drain_requested``) stops the loop between
words.

Telemetry (``obs``, fail-open, ``TBX_OBS``-gated): with an ``output_dir``
the loop runs inside a sweep observer that writes a span stream to
``<output_dir>/_events.jsonl`` (run → word → phase), heartbeats
``<output_dir>/_progress.json``, spools ``_metrics.jsonl`` and, with
``TBX_PROFILE=1``, writes ``_device_profile.json``; ``pipeline`` labels the
run span.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Sequence

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.runtime import resilience, speculate, supervise
from taboo_brittleness_tpu_torch.runtime.checkpoints import prefetch_next
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FailureLedger,
    RetryPolicy,
    atomic_json_dump,
)


def sweep_words(
    words: Sequence[str],
    *,
    model_loader: Callable,
    load_done: Callable[[str], Optional[Dict[str, Any]]],
    run_word: Callable[..., Dict[str, Any]],
    policy: RetryPolicy,
    ledger: FailureLedger,
    fail_fast: bool = False,
    on_done: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    output_dir: Optional[str] = None,
    pipeline: str = "word_sweep",
) -> Dict[str, Any]:
    """``{word: entry}`` for every word that finished, resumed or computed.

    ``load_done(word)`` returns the word's saved entry when it counts as
    done, else None.  ``run_word(word, (params, cfg, tok), set_stage, ob)``
    computes (and saves) a word's entry, naming its stages for the ledger
    through ``set_stage(name)`` and opening its phases on the sweep
    observer ``ob``.  ``on_done(word, entry)`` fires for computed and
    resumed words.  A drain notice stops the loop before the next word
    (resumed words included).  The observer writes into ``output_dir``
    (none without one) under the run label ``pipeline``."""
    words = list(words)
    results: Dict[str, Any] = {}
    with obs.sweep_observer(output_dir, pipeline=pipeline, words=words) as ob:
        for i, word in enumerate(words):
            if supervise.drain_requested():
                # Preemption drain (runtime.supervise): stop BETWEEN words.
                # The previous word's write is complete, so the next
                # incarnation resumes exactly here; the CLI exits 75.
                ob.mark_drained()
                break
            saved = load_done(word)
            if saved is not None:
                results[word] = saved
                ledger.record_success(word)
                with ob.word(word, resumed=True) as wsp:
                    wsp.set(resumed=True)
                if on_done is not None:
                    on_done(word, saved)
                continue

            stage = {"name": "checkpoint.load"}

            def set_stage(name: str) -> None:
                stage["name"] = name

            def run_one(word: str = word, i: int = i) -> Dict[str, Any]:
                set_stage("checkpoint.load")
                # The speculative decoder's per-word plan rides module state.
                speculate.set_active_word(word)
                with ob.phase("checkpoint.load"):
                    loaded = model_loader(word)
                nxt = next_pending(words, i, ledger, load_done)
                if nxt is not None:
                    prefetch_next(model_loader, nxt)
                return run_word(word, loaded, set_stage, ob)

            with ob.word(word) as wsp:
                outcome = resilience.run_guarded(
                    word, run_one, policy=policy, ledger=ledger,
                    stage=lambda: stage["name"])
                wsp.set(attempts=outcome.attempts)
                if not outcome.ok:
                    wsp.set(quarantined=True, stage=outcome.stage)
                    if fail_fast:
                        raise outcome.error
                    # A quarantined word's prefetched state must not leak
                    # into a later rerun.
                    drop = getattr(model_loader, "drop_pending", None)
                    if drop is not None:
                        drop(word)
                    continue
                results[word] = outcome.value
            if on_done is not None:
                on_done(word, outcome.value)
    return results


def next_pending(words: Sequence[str], i: int, ledger: FailureLedger,
                 load_done: Callable[[str], Optional[Dict[str, Any]]]
                 ) -> Optional[str]:
    """The first word after ``words[i]`` that will run: not quarantined and
    not done (the one worth prefetching or pre-dispatching)."""
    return next((w for w in words[i + 1:]
                 if w not in ledger.quarantined and load_done(w) is None), None)


@dataclasses.dataclass
class SweepOutcome:
    """What :func:`run_word_sweep` returns: every finished word's entry, and
    the ledger describing the words that did not finish."""

    results: Dict[str, Any]
    ledger: FailureLedger

    @property
    def quarantined(self) -> Dict[str, Any]:
        return self.ledger.quarantined

    @property
    def ok(self) -> bool:
        return not self.ledger


def run_word_sweep(
    config: Config,
    *,
    model_loader: Callable,
    words: Sequence[str],
    modes: Sequence[str],
    compute_mode: Callable[..., Any],
    score_word: Callable[[Config, str, str, Any], Dict[str, Any]],
    output_dir: Optional[str] = None,
    force: bool = False,
    max_retries: int = 2,
    fail_fast: bool = False,
    retry_policy: Optional[RetryPolicy] = None,
    pipeline: str = "word_sweep",
) -> SweepOutcome:
    """Per-word entries ``{word: {mode: score_word(...)}}`` plus the ledger.

    ``compute_mode(params, cfg, tok, config, mode)`` produces a mode's
    word-independent payload under one model; ``score_word(config, word,
    mode, payload)`` turns it into the word's entry for that mode.
    ``retry_policy`` overrides ``RetryPolicy(max_retries=max_retries)``.
    The ledger is ``<output_dir>/_failures.json`` (in memory without an
    ``output_dir``), beside the sweep observer's files; ``pipeline`` labels
    the run span."""
    ledger = FailureLedger(output_dir)

    def word_path(w: str) -> str:
        return os.path.join(output_dir, f"{w}.json")

    def load_done(w: str) -> Optional[Dict[str, Any]]:
        if output_dir is None or force:
            return None
        entry = resilience.load_resume_json(word_path(w))
        return entry if entry is not None and all(m in entry for m in modes) else None

    memo_key: Any = None
    memo: Dict[str, Any] = {}

    def run_word(word: str, loaded, set_stage, ob) -> Dict[str, Any]:
        nonlocal memo_key, memo
        params, cfg, tok = loaded
        if memo_key is None or params is not memo_key[0] or tok is not memo_key[1]:
            memo_key, memo = (params, tok), {}
        entry: Dict[str, Any] = {}
        for mode in modes:
            set_stage(f"compute:{mode}")
            with ob.phase(f"compute:{mode}") as psp:
                psp.set(memoized=mode in memo)
                if mode not in memo:
                    memo[mode] = compute_mode(params, cfg, tok, config, mode)
                entry[mode] = score_word(config, word, mode, memo[mode])
        if output_dir:
            # Inside the guarded scope, so a write fault retries and then
            # quarantines the word, and a ``die`` fault kills before the
            # rename.
            set_stage("write")
            with ob.phase("write"):
                resilience.fire("cache.write", word=word, path=word_path(word))
                atomic_json_dump(entry, word_path(word))
        return entry

    results = sweep_words(
        words, model_loader=model_loader, load_done=load_done,
        run_word=run_word,
        policy=retry_policy or RetryPolicy(max_retries=max_retries),
        ledger=ledger, fail_fast=fail_fast, output_dir=output_dir,
        pipeline=pipeline)
    return SweepOutcome(results=results, ledger=ledger)
