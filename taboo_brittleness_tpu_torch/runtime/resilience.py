"""Failure handling for the generation sweep: atomic writes, retries, ledger.

The PyTorch port's copy of the part of the JAX package's
``runtime/resilience.py`` that the ported pipelines call:

- :func:`atomic_json_dump` / :func:`quarantine_file` /
  :func:`load_resume_json` — the sweeps' skip-if-exists resume treats a
  file's existence as a completion marker, so no artifact may ever be
  observable half-written, and a corrupt one is moved aside (``*.corrupt``)
  and recomputed instead of trusted;
- :class:`RetryPolicy` — exponential backoff with seeded jitter and a
  transient-vs-permanent error classification (:func:`is_transient`);
- :class:`FailureLedger` — the per-sweep ``<output_dir>/_failures.json``;
- :func:`run_guarded` — retry one word's work, then quarantine it and let the
  sweep continue.

The ledger's file schema is the JAX package's (version 3), so either package
resumes a sweep the other started.  Supervised incarnations, fleet worker
stamps, deadlines and fault injection are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

_log = logging.getLogger(__name__)

# OSErrors that retrying cannot fix: the filesystem object is missing or
# forbidden, not flaky (a missing safetensors shard stays missing).
_PERMANENT_OS_ERRORS = (
    FileNotFoundError,
    NotADirectoryError,
    IsADirectoryError,
    PermissionError,
)


def is_transient(exc: BaseException) -> bool:
    """Transient (worth retrying) vs permanent (fail fast / quarantine).

    Transient: IO-shaped errors (``OSError`` family — interrupted reads,
    ``ETIMEDOUT``, connection resets) except the permanent subset above.
    Everything else — value/shape errors, missing keys, CUDA errors raised as
    ``RuntimeError`` — is a bug or a missing artifact, and retrying would only
    replay it.
    """
    if isinstance(exc, _PERMANENT_OS_ERRORS):
        return False
    return isinstance(exc, (OSError, ConnectionError, TimeoutError))


def atomic_json_dump(obj: Any, path: str, *, indent: Optional[int] = 2) -> None:
    """Write-then-rename so a crash mid-write never leaves a truncated file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(tmp, path)


def quarantine_file(path: str, *, reason: str = "") -> Optional[str]:
    """Rename a corrupt artifact to ``<path>.corrupt`` (never trusted, never
    fatal): the resume logic then treats the cell as missing and recomputes,
    while the bytes stay on disk for postmortem.  Returns the new path, or
    None if the file had already vanished."""
    if not os.path.exists(path):
        return None
    dst = f"{path}.corrupt"
    try:
        os.replace(path, dst)
    except OSError:
        return None
    _log.warning("quarantined corrupt file %s -> %s%s", path, dst,
                 f" ({reason})" if reason else "")
    return dst


def load_resume_json(path: str) -> Optional[Any]:
    """A sweep's finished-entry file, or None when there is none or it is
    unreadable: a torn or corrupt file (a killed run's write) is quarantined
    so the entry is recomputed, never trusted and never fatal."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as exc:
        quarantine_file(path, reason=f"unreadable entry: {exc}")
        return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter.

    ``max_retries`` is the number of RE-tries: a call gets at most
    ``max_retries + 1`` attempts.  Jitter is drawn from a ``random.Random``
    seeded by ``(seed, site)``, so a sweep's backoff schedule is reproducible
    while distinct sites still decorrelate.
    """

    max_retries: int = 2
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.25        # fraction of the delay, symmetric
    seed: int = 0

    def delays(self, site: str = "") -> Iterator[float]:
        """The deterministic backoff schedule for one call site."""
        rng = random.Random(f"{self.seed}:{site}")
        delay = self.base_delay
        for _ in range(self.max_retries):
            jit = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield max(0.0, min(delay, self.max_delay) * jit)
            delay *= self.multiplier

    def call(
        self,
        fn: Callable[[], Any],
        *,
        site: str = "",
        classify: Callable[[BaseException], bool] = is_transient,
        sleep: Callable[[float], None] = time.sleep,
        on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    ) -> Any:
        """Run ``fn`` with retries on transient errors.

        Permanent errors (per ``classify``) raise immediately; transient
        errors consume the backoff schedule and re-raise once it is
        exhausted.  ``on_retry(exc, attempt, delay)`` fires before each
        backoff sleep (the ledger hook).
        """
        schedule = self.delays(site)
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — classified below
                if not classify(exc):
                    raise
                delay = next(schedule, None)
                if delay is None:
                    raise
                if on_retry is not None:
                    on_retry(exc, attempt, delay)
                sleep(delay)


LEDGER_FILENAME = "_failures.json"


def _describe(exc: BaseException) -> Dict[str, Any]:
    return {
        "error_type": type(exc).__name__,
        "error": str(exc),
        "transient": is_transient(exc),
    }


class FailureLedger:
    """Per-sweep failure record at ``<output_dir>/_failures.json`` (atomic).

    - ``quarantined``: words whose final attempt failed — stage, attempt
      count, and the final exception.  The sweep continued past them; the
      CLI exits non-zero iff this block is non-empty.
    - ``retried``: words that eventually succeeded but needed retries.

    A rerun loads the existing ledger and clears a word's quarantine entry
    when it finally succeeds, so the ledger describes what is missing now.
    """

    def __init__(self, output_dir: Optional[str] = None, *,
                 path: Optional[str] = None):
        self.path = path or (os.path.join(output_dir, LEDGER_FILENAME)
                             if output_dir else None)
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        self.retried: Dict[str, Dict[str, Any]] = {}
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.quarantined = dict(json.load(f).get("quarantined", {}))
            except (json.JSONDecodeError, UnicodeDecodeError, OSError) as exc:
                quarantine_file(self.path, reason=f"unreadable ledger: {exc}")

    def record_retry(self, word: str, stage: str, exc: BaseException,
                     attempt: int) -> None:
        self.retried[word] = {"attempts": attempt, "incarnation": 0}
        self.save()

    def record_quarantine(self, word: str, stage: str, exc: BaseException,
                          attempts: int) -> None:
        self.quarantined[word] = {
            "stage": stage,
            "attempts": attempts,
            "incarnation": 0,
            **_describe(exc),
            # tbx: wallclock-ok — serialized epoch timestamp, not a duration
            "at": time.time(),
        }
        self.save()

    def record_success(self, word: str) -> None:
        if word in self.quarantined:
            del self.quarantined[word]
            self.save()

    def __bool__(self) -> bool:
        return bool(self.quarantined)

    @property
    def words(self) -> List[str]:
        return sorted(self.quarantined)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 3,
            "incarnation": 0,
            "quarantined": self.quarantined,
            "retried": self.retried,
        }

    def save(self) -> None:
        if self.path:
            atomic_json_dump(self.to_dict(), self.path)


@dataclasses.dataclass
class WordOutcome:
    """Result of :func:`run_guarded`: either ``value`` (success) or the
    exception that exhausted the policy (quarantine)."""

    word: str
    value: Any = None
    error: Optional[BaseException] = None
    attempts: int = 1
    stage: str = ""

    @property
    def ok(self) -> bool:
        return self.error is None


def run_guarded(
    word: str,
    fn: Callable[[], Any],
    *,
    policy: RetryPolicy,
    ledger: Optional[FailureLedger] = None,
    stage: Callable[[], str] = lambda: "run",
    sleep: Callable[[float], None] = time.sleep,
) -> WordOutcome:
    """Run one word's work under ``policy``; on final failure return (not
    raise) the error so the sweep can quarantine and continue.  ``stage`` is
    a thunk so the caller can report which sub-stage was active when the
    last attempt died."""
    attempts = {"n": 1}

    def on_retry(exc: BaseException, attempt: int, delay: float) -> None:
        attempts["n"] = attempt + 1
        if ledger is not None:
            ledger.record_retry(word, stage(), exc, attempt)
        _log.warning("%s: attempt %d failed at %s (%s: %s); retrying in %.2fs",
                     word, attempt, stage(), type(exc).__name__, exc, delay)

    try:
        value = policy.call(fn, site=f"{stage()}:{word}", sleep=sleep,
                            on_retry=on_retry)
    except Exception as exc:  # noqa: BLE001 — quarantine, don't crash the sweep
        if ledger is not None:
            ledger.record_quarantine(word, stage(), exc, attempts["n"])
        _log.warning("%s: quarantined at %s after %d attempt(s) (%s: %s)",
                     word, stage(), attempts["n"], type(exc).__name__, exc)
        return WordOutcome(word=word, error=exc, attempts=attempts["n"],
                           stage=stage())
    if ledger is not None:
        ledger.record_success(word)
    return WordOutcome(word=word, value=value, attempts=attempts["n"],
                       stage=stage())
