"""Checkpoint resolution and residency: taboo word -> (params, config,
tokenizer).

The counterpart of the JAX package's ``runtime/checkpoints.py``.  Resolution
is local-first:

1. ``TABOO_CHECKPOINT_ROOT`` (or ``checkpoint_root=``) — a directory holding
   one HF-snapshot-layout folder per checkpoint (config.json + safetensors +
   tokenizer files), named by the full repo id's basename
   (``gemma-2-9b-it-taboo-ship``) or by the bare word (``ship``);
2. the standard HF cache (``~/.cache/huggingface/hub``).

:class:`CheckpointManager` keeps loaded words resident (LRU), loads the next
word on a prefetch thread while the current one computes, retries transient
load errors under a deadline, and in delta mode keeps one base resident and
makes each word from its ``runtime.delta`` artifact.  :func:`model_loader`
and :func:`load_word` load without residency.

CUDA streams: every load, on the prefetch thread too, issues its copies and
its delta apply on the thread's current stream, which is the device's
default stream in every thread.  So a prefetch serialises with the main
thread's decode on the card and nothing races; its gain is the host-side
read, parse and transfer set-up running beside the decode.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from taboo_brittleness_tpu_torch.config import ModelConfig
from taboo_brittleness_tpu_torch.device import DeviceLike, resolve_device
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.models.params import (
    from_safetensors_dir,
    infer_config_from_hf_config_json,
)
from taboo_brittleness_tpu_torch.runtime import resilience
from taboo_brittleness_tpu_torch.runtime.tokenizer import HFTokenizer, TokenizerLike

Triple = Tuple[Params, Gemma2Config, TokenizerLike]

#: Default base of delta mode: every taboo checkpoint is a finetune of it.
DEFAULT_DELTA_BASE = "google/gemma-2-9b-it"


def resolve_snapshot_dir(repo_id: str, checkpoint_root: Optional[str] = None) -> str:
    """Find a local HF-snapshot directory for ``repo_id`` or raise."""
    basename = repo_id.split("/")[-1]
    candidates = []
    root = checkpoint_root or os.environ.get("TABOO_CHECKPOINT_ROOT")
    if root:
        parts = basename.split("-")
        # Every hyphen-suffix of the basename, LONGEST first, so a
        # multi-token word ("...-taboo-ice-cream") resolves <root>/ice-cream
        # before a bare <root>/cream could shadow it.
        suffixes = ["-".join(parts[i:]) for i in range(1, len(parts))]
        candidates += [os.path.join(root, basename)]
        candidates += [os.path.join(root, s) for s in suffixes]
        candidates += [os.path.join(root, repo_id.replace("/", "--"))]
    # HF_HUB_CACHE points at the hub cache itself; HF_HOME at its parent.
    hub_dir_root = os.path.expanduser(
        os.environ.get("HF_HUB_CACHE")
        or os.path.join(os.environ.get("HF_HOME", "~/.cache/huggingface"),
                        "hub"))
    hub_dir = os.path.join(hub_dir_root,
                           f"models--{repo_id.replace('/', '--')}", "snapshots")
    if os.path.isdir(hub_dir):
        candidates += [os.path.join(hub_dir, s) for s in sorted(os.listdir(hub_dir))]

    for c in candidates:
        if os.path.exists(os.path.join(c, "config.json")):
            return c
    raise FileNotFoundError(
        f"no local snapshot for {repo_id}; looked in {candidates or '[no roots]'}. "
        f"Set TABOO_CHECKPOINT_ROOT to a directory of HF snapshots.")


def _load_snapshot(repo_id: str, model_cfg: ModelConfig,
                   checkpoint_root: Optional[str], device) -> Triple:
    snap = resolve_snapshot_dir(repo_id, checkpoint_root)
    cfg = infer_config_from_hf_config_json(
        snap, dtype=model_cfg.dtype, param_dtype=model_cfg.param_dtype)
    params = from_safetensors_dir(snap, cfg, device=device)
    return params, cfg, HFTokenizer.from_pretrained(snap)


def load_word(word: str, model_cfg: ModelConfig, *,
              checkpoint_root: Optional[str] = None,
              device: DeviceLike = None) -> Triple:
    """Load ``word``'s checkpoint (``model_cfg.checkpoint_template``) onto
    ``device`` in the configured dtypes, with its tokenizer."""
    return _load_snapshot(model_cfg.checkpoint_template.format(word=word),
                          model_cfg, checkpoint_root, resolve_device(device))


def model_loader(model_cfg: ModelConfig, *, checkpoint_root: Optional[str] = None,
                 device: DeviceLike = None) -> Callable[[str], Triple]:
    """A ``word -> (params, cfg, tokenizer)`` loader for the pipelines; it
    keeps no checkpoint resident between calls."""
    device = resolve_device(device)

    def load(word: str) -> Triple:
        return load_word(word, model_cfg, checkpoint_root=checkpoint_root,
                         device=device)

    return load


class CheckpointManager:
    """LRU cache of loaded (params, cfg, tokenizer) triples keyed by word.

    - ``capacity`` words stay resident; the least recently loaded goes.
    - :meth:`prefetch` loads a word on a host thread; :meth:`load` joins it
      (``source`` "prefetch"), serves a resident word ("cache"), or loads
      on the caller's thread ("sync"); :attr:`sources` records each load's.
    - With a ``retry_policy`` transient load errors retry with seeded
      backoff (a transient prefetch error counts as the first attempt);
      permanent ones raise at once.  ``load_deadline`` watchdogs each
      attempt, so a hung read becomes a retryable
      :class:`~.resilience.DeadlineExceeded`.
    - Delta mode (``delta_root``, or ``TBX_DELTA=1`` with
      ``TBX_DELTA_ROOT``): the base (``base_id``, else ``TBX_DELTA_BASE``,
      else :data:`DEFAULT_DELTA_BASE`) loads once, under a lock, into
      ``_base_triple``; a word is ``delta.apply_packed`` of its
      ``<delta_root>/<word>.delta.npz`` over it, so only its changed
      leaves take new device memory.

    ``device`` is where params land (unset: ``cuda``, which raises without
    CUDA).
    """

    def __init__(self, model_cfg: ModelConfig, *,
                 checkpoint_root: Optional[str] = None, capacity: int = 1,
                 retry_policy: Optional[resilience.RetryPolicy] = None,
                 load_deadline: Optional[float] = None,
                 delta_root: Optional[str] = None,
                 base_id: Optional[str] = None,
                 device: DeviceLike = None):
        self.model_cfg = model_cfg
        self.checkpoint_root = checkpoint_root
        self.capacity = max(1, capacity)
        self.retry_policy = retry_policy
        self.load_deadline = load_deadline
        self.device = resolve_device(device)
        if delta_root is None and os.environ.get("TBX_DELTA") == "1":
            delta_root = os.environ.get("TBX_DELTA_ROOT") or None
        self.delta_root = delta_root
        self.base_id = base_id or os.environ.get(
            "TBX_DELTA_BASE", DEFAULT_DELTA_BASE)
        self._base_lock = threading.Lock()
        self._base_triple: Optional[Triple] = None
        self._cache: "OrderedDict[str, Triple]" = OrderedDict()
        self._pending: Dict[str, threading.Thread] = {}
        self._pending_results: Dict[str, Tuple] = {}
        self.sources: list = []       # (word, "cache" | "prefetch" | ...)

    def repo_id(self, word: str) -> str:
        return self.model_cfg.checkpoint_template.format(word=word)

    def base_triple(self) -> Triple:
        """The resident base (params, cfg, tok); loaded once, thread-safe
        (prefetch threads reach it concurrently with the main thread)."""
        with self._base_lock:
            if self._base_triple is None:
                self._base_triple = _load_snapshot(
                    self.base_id, self.model_cfg, self.checkpoint_root,
                    self.device)
            return self._base_triple

    def _load_triple(self, word: str) -> Triple:
        resilience.fire("checkpoint.read", word=word)
        if self.delta_root is not None:
            return self._load_triple_delta(word)
        return _load_snapshot(self.repo_id(word), self.model_cfg,
                              self.checkpoint_root, self.device)

    def _load_triple_delta(self, word: str) -> Triple:
        """Read the word's delta artifact and apply it to the resident base
        (inside the same retry/deadline/fault plumbing as a full load)."""
        from taboo_brittleness_tpu_torch.runtime import delta as deltalib

        base_params, cfg, tok = self.base_triple()
        payload, meta = deltalib.load_delta(
            deltalib.delta_path(self.delta_root, word))
        return deltalib.apply_packed(base_params, payload, meta), cfg, tok

    def _load_guarded(self, word: str) -> Triple:
        """One attempt under the deadline watchdog (each attempt gets a
        fresh deadline)."""
        return resilience.run_with_deadline(
            lambda: self._load_triple(word), self.load_deadline,
            stage=f"checkpoint.load:{word}")

    def _load_with_retries(self, word: str) -> Triple:
        if self.retry_policy is None:
            return self._load_guarded(word)
        return self.retry_policy.call(
            lambda: self._load_guarded(word), site=f"checkpoint.read:{word}")

    def prefetch(self, word: str) -> None:
        """Start loading ``word`` on a host thread.  Errors surface at
        :meth:`load`, where a transient one is retried; a finished errored
        prefetch that nobody loaded is re-armed by the next prefetch.  The
        load runs beside the caller's decode-graph captures, so it never
        synchronizes the whole device (see ``runtime.aot``)."""
        if word in self._cache:
            return
        if word in self._pending:
            t = self._pending[word]
            stale = (not t.is_alive()
                     and word in self._pending_results
                     and not self._pending_results[word][0])
            if not stale:
                return
            self.drop_pending(word)

        def run():
            try:
                resilience.fire("prefetch.thread", word=word)
                # load() / drop_pending() join the thread before reading the
                # slot: join() is the happens-before edge.
                self._pending_results[word] = (True, self._load_triple(word))
            except BaseException as e:  # noqa: BLE001 — raised (or retried) by load()
                self._pending_results[word] = (False, e)

        t = threading.Thread(target=run, name=f"prefetch-{word}", daemon=True)
        self._pending[word] = t
        t.start()

    def drop_pending(self, word: str) -> None:
        """Discard any pending prefetch of ``word`` (joining its thread), so
        a skipped or quarantined word's stale result cannot reach a later
        :meth:`load`."""
        t = self._pending.pop(word, None)
        if t is not None:
            t.join()
        self._pending_results.pop(word, None)

    def load(self, word: str) -> Triple:
        if word in self._cache:
            self._cache.move_to_end(word)
            self.sources.append((word, "cache"))
            return self._cache[word]
        if word in self._pending:
            self._pending.pop(word).join()
            ok, payload = self._pending_results.pop(word)
            if ok:
                triple, source = payload, "prefetch"
            elif (self.retry_policy is not None
                    and resilience.is_transient(payload)):
                # The failed prefetch was attempt 1; the policy owns the rest.
                triple, source = self._load_with_retries(word), "prefetch-retry"
            else:
                raise payload
        else:
            triple, source = self._load_with_retries(word), "sync"
        self.sources.append((word, source))
        self._cache[word] = triple
        while len(self._cache) > self.capacity:
            # The oldest goes; its device memory frees once unreferenced.
            self._cache.popitem(last=False)
        return triple

    def __call__(self, word: str) -> Triple:
        return self.load(word)


def prefetch_next(model_loader, word: str) -> None:
    """Start loading ``word`` while the current word computes, when the
    loader has a ``prefetch(word)``; a plain callable loader does nothing
    here."""
    fn = getattr(model_loader, "prefetch", None)
    if fn is not None:
        fn(word)

