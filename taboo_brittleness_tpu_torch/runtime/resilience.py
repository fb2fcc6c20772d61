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
  sweep continue;
- :class:`Deadline` / :func:`run_with_deadline` — host-side watchdogs that
  turn a hung stage into a retryable :class:`DeadlineExceeded`;
- the fault plan (:class:`FaultSpec`, :class:`FaultInjector`, :func:`fire`,
  ``TABOO_FAULT_PLAN``) — deterministic faults armed at the named sites of
  :data:`FAULT_SITES`.

The ledger's file schema is the JAX package's (version 3), so either package
resumes a sweep the other started, and a fault plan written for the JAX
package arms the same sites here.  ``runtime.supervise`` numbers each
relaunch in ``TBX_INCARNATION`` (:func:`current_incarnation`): a fault
spec's ``incarnation`` scope reads it, the ledger stamps every entry with
it, and a resume incarnation keeps the earlier incarnations' retry
entries.  The fleet coordinator (``runtime.fleet``) gives each worker
``TBX_WORKER_ID`` (:func:`current_worker_id`): the ledger stamps it on
every entry (v3), beside the ``obs`` sinks and the serve scheduler.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

_log = logging.getLogger(__name__)

INCARNATION_ENV = "TBX_INCARNATION"


def current_incarnation() -> int:
    """The ``TBX_INCARNATION`` ordinal (0 when unset or malformed)."""
    try:
        return int(os.environ.get(INCARNATION_ENV, "0"))
    except ValueError:
        return 0


#: A fleet worker's stable identity (set by the fleet coordinator,
#: ``runtime.fleet``): the per-worker telemetry file suffixes and the
#: ``worker`` stamps of events, ledger entries, responses and fault-plan
#: context read it.
WORKER_ENV = "TBX_WORKER_ID"


def current_worker_id() -> Optional[str]:
    """This process's fleet worker id, or None outside a fleet worker."""
    return os.environ.get(WORKER_ENV) or None


class InjectedFault(OSError):
    """A deliberately injected *transient* fault (fault-injection harness)."""


class InjectedPermanentFault(RuntimeError):
    """A deliberately injected *permanent* fault — never retried."""


class DeadlineExceeded(TimeoutError):
    """A host-side stage overran its watchdog deadline (transient: a hung
    read often succeeds on retry)."""


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

    Transient: injected transient faults, deadline overruns, and IO-shaped
    errors (``OSError`` family — interrupted reads, ``ETIMEDOUT``, connection
    resets) except the permanent subset above.  Everything else —
    value/shape errors, missing keys, CUDA errors raised as ``RuntimeError``,
    injected permanent faults — is a bug or a missing artifact, and retrying
    would only replay it.
    """
    if isinstance(exc, InjectedPermanentFault):
        return False
    if isinstance(exc, (InjectedFault, DeadlineExceeded)):
        return True
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


class Deadline:
    """Cooperative deadline for host-side stages: create with a budget, call
    :meth:`check` at safe points.  Monotonic clock, so wall-clock steps
    cannot fire or starve it."""

    def __init__(self, seconds: float, *, stage: str = ""):
        self.seconds = float(seconds)
        self.stage = stage
        self._end = time.monotonic() + self.seconds

    def remaining(self) -> float:
        return self._end - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self) -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"stage {self.stage or '<unnamed>'} exceeded its "
                f"{self.seconds:.1f}s deadline")


def run_with_deadline(
    fn: Callable[[], Any],
    timeout: Optional[float],
    *,
    stage: str = "",
) -> Any:
    """Run ``fn`` on a watchdog'd worker thread; raise
    :class:`DeadlineExceeded` if it does not finish within ``timeout``
    seconds.  ``timeout=None``/``<=0`` runs inline (no watchdog).

    The overrun worker is daemonized and abandoned, not killed (Python has
    no safe cross-thread kill): paired with :class:`RetryPolicy`, the
    timeout becomes a clean retry while the wedged thread dies with the
    process.  CUDA work issued from the worker goes to the same default
    stream as the caller's, so it is ordered with it.
    """
    if timeout is None or timeout <= 0:
        return fn()
    result: Dict[str, Any] = {}

    def run() -> None:
        try:
            result["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised on the caller
            result["error"] = exc

    t = threading.Thread(target=run, name=f"deadline-{stage or 'stage'}",
                         daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise DeadlineExceeded(
            f"stage {stage or '<unnamed>'} exceeded its {timeout:.1f}s "
            "deadline (worker abandoned)")
    if "error" in result:
        raise result["error"]
    return result["value"]


# ---------------------------------------------------------------------------
# Deterministic fault injection.
# ---------------------------------------------------------------------------

#: The named fault sites the port fires.  Arming an unknown site is an error
#: (a typo'd plan must fail loudly, not silently no-op).
FAULT_SITES = (
    "checkpoint.read",    # CheckpointManager._load_triple, every attempt
    "cache.write",        # after each rename of runtime.cache.save_pair
    #                       (npz, json) and save_summary, of
    #                       runtime.delta.save_delta, and before
    #                       pipelines.word_sweep.run_word_sweep writes a
    #                       word (context: word + path)
    "prefetch.thread",    # CheckpointManager.prefetch worker
    "decode.launch",      # runtime.decode.generate
    "obs.event_write",    # obs.trace.Tracer._emit: an injected sink fault
    #                       drops the event, never the run
    "obs.metrics_write",  # obs.timeseries.TimeseriesRecorder._write: an
    #                       injected fault drops the window (counted in
    #                       obs.metrics_dropped), never the run
    "serve.step",         # serve.scheduler.SlotScheduler.step, once per
    #                       in-flight session per step (context: request id,
    #                       scenario, worker); the scheduler quarantines that
    #                       session and the batch lives
    "speculate.verify",   # runtime.speculate.speculative_decode, before
    #                       every verify block (context: block + rows); the
    #                       word-level run_guarded retry/quarantine owns it
    "serve.spec.verify",  # serve.scheduler.SlotScheduler.step (speculative
    #                       engine), once per in-flight session before each
    #                       draft + verify block (context: request id and
    #                       scenario; the retry adds attempt=1): ONE
    #                       in-place retry, then that session quarantines
    #                       and the batch lives
    "fleet.claim",        # runtime.fleet.FleetSpool.claim, per claim
    #                       attempt (context: uid, worker, holder); the
    #                       worker loop retries on its next poll
    "fleet.lease_renew",  # runtime.fleet.LeaseKeeper, per renewal: a fault
    #                       lets the lease expire (re-issue, then a benign
    #                       duplicate commit); `die` kills mid-renewal
    "fleet.commit",       # runtime.fleet.run_worker, just before the
    #                       first-writer-wins commit; `die` here is the
    #                       worker killed mid-unit, its artifact never lands
    "grid.cell",          # grid.runner.run_cell, once per (word, layer,
    #                       width) cell before its readout (context: word,
    #                       cell key, "<word>@<cell>", layer, width); rides
    #                       the worker's run_guarded retry -> quarantine
)

_FAULT_MODES = ("fail", "delay", "truncate", "die")

#: ``die`` default exit status: what the shell reports for SIGKILL (128+9).
DIE_EXIT_CODE = 137


@dataclasses.dataclass
class FaultSpec:
    """One armed schedule at one site.

    - ``mode="fail"``: raise (``kind`` transient/permanent);
    - ``mode="delay"``: sleep ``delay`` seconds (watchdog exercise);
    - ``mode="truncate"``: truncate the file at the context's ``path`` to
      half its size (a torn write, as a later resume sees it);
    - ``mode="die"``: ``os._exit(exit_code)`` on the spot (SIGKILL-like);
    - ``times``: fire only on the first N matching calls; ``None`` fires
      every time;
    - ``match``: fire only when some context value contains this substring;
    - ``incarnation``: fire only when ``TBX_INCARNATION`` equals it.
    """

    mode: str = "fail"
    times: Optional[int] = 1
    kind: str = "transient"          # "transient" | "permanent"
    delay: float = 0.0
    match: Optional[str] = None
    incarnation: Optional[int] = None
    exit_code: int = DIE_EXIT_CODE
    fired: int = 0                   # call counter: the schedule depends only
    #                                  on call order

    def __post_init__(self) -> None:
        if self.mode not in _FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r}; expected {_FAULT_MODES}")
        if self.kind not in ("transient", "permanent"):
            raise ValueError(
                f"unknown fault kind {self.kind!r}; "
                "expected 'transient' or 'permanent'")

    def matches(self, context: Dict[str, Any]) -> bool:
        if (self.incarnation is not None
                and self.incarnation != current_incarnation()):
            return False
        if self.match is None:
            return True
        return any(self.match in str(v) for v in context.values())


class FaultInjector:
    """Deterministic registry of armed fault sites.

    Tests arm programmatically (:meth:`arm`); operators arm through the
    ``TABOO_FAULT_PLAN`` env var — inline JSON or a path to a JSON file —
    mapping site names to spec dicts (or lists of them)::

        TABOO_FAULT_PLAN='{"checkpoint.read":
            {"mode": "fail", "times": 2, "match": "ship"}}'

    Firing is thread-safe (the prefetch site runs on worker threads) and
    counts per spec in call order, so a plan replays identically.
    """

    def __init__(self) -> None:
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._lock = threading.Lock()

    def arm(self, site: str, spec: Optional[FaultSpec] = None,
            **kw: Any) -> FaultSpec:
        if site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known sites: {FAULT_SITES}")
        spec = spec if spec is not None else FaultSpec(**kw)
        with self._lock:
            self._specs.setdefault(site, []).append(spec)
        return spec

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    @property
    def armed(self) -> bool:
        return bool(self._specs)

    @classmethod
    def from_plan(cls, plan: Dict[str, Any]) -> "FaultInjector":
        inj = cls()
        for site, specs in plan.items():
            for spec in ([specs] if isinstance(specs, dict) else specs):
                inj.arm(site, **spec)
        return inj

    @classmethod
    def from_env(cls, env_var: str = "TABOO_FAULT_PLAN") -> "FaultInjector":
        raw = os.environ.get(env_var, "").strip()
        if not raw:
            return cls()
        if not raw.startswith("{"):
            with open(raw) as f:
                raw = f.read()
        return cls.from_plan(json.loads(raw))

    def fire(self, site: str, **context: Any) -> None:
        """Evaluate ``site``'s armed schedules against ``context``: raise,
        delay, truncate or exit per the first matching spec with shots
        left; a no-op when nothing matches."""
        with self._lock:
            spec = None
            for s in self._specs.get(site, ()):
                if not s.matches(context):
                    continue
                if s.times is not None and s.fired >= s.times:
                    continue
                s.fired += 1
                spec = s
                break
        if spec is None:
            return
        detail = ", ".join(f"{k}={v}" for k, v in sorted(context.items()))
        label = site + (f" [{detail}]" if detail else "")
        if spec.mode == "die":
            os._exit(spec.exit_code)
            return  # reachable only with os._exit stubbed out
        if spec.mode == "delay":
            time.sleep(spec.delay)
            return
        if spec.mode == "truncate":
            path = context.get("path")
            if path and os.path.exists(path):
                with open(path, "r+b") as f:
                    f.truncate(os.path.getsize(path) // 2)
            return
        if spec.kind == "permanent":
            raise InjectedPermanentFault(f"injected permanent fault at {label}")
        raise InjectedFault(f"injected transient fault at {label}")


# The process-wide injector, built from TABOO_FAULT_PLAN on first use, so
# `fire()` at an unarmed site costs one check.
_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def get_injector() -> FaultInjector:
    global _injector
    with _injector_lock:
        if _injector is None:
            _injector = FaultInjector.from_env()
        return _injector


def set_injector(injector: Optional[FaultInjector]) -> None:
    """Install (or with None, reset to the env plan) the process-wide
    injector — the test hook."""
    global _injector
    with _injector_lock:
        _injector = injector


def fire(site: str, **context: Any) -> None:
    """The sites' entry point (``fire("checkpoint.read", word=word)``): a
    no-op unless a plan armed ``site``."""
    inj = get_injector()
    if inj.armed:
        inj.fire(site, **context)


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

    Incarnations: every entry is stamped with the ``incarnation`` that
    recorded it (:func:`current_incarnation` unless given).  A resume
    incarnation (``incarnation > 0``) keeps the earlier incarnations'
    ``retried`` entries, so a supervised run's ledger attributes each retry
    to the process that saw it; a fresh run (incarnation 0) resets them.

    Workers (schema v3): a fleet worker's ledger also stamps every entry
    with its ``worker`` (:func:`current_worker_id` unless given).  Outside
    a worker no ``worker`` key is written.  A v2 ledger (no worker stamps)
    loads unchanged; a resume gives its unstamped entries the prior file's
    top-level ``worker`` when it has one (the v2 -> v3 normalization).
    """

    def __init__(self, output_dir: Optional[str] = None, *,
                 path: Optional[str] = None,
                 incarnation: Optional[int] = None,
                 worker: Optional[str] = None):
        self.path = path or (os.path.join(output_dir, LEDGER_FILENAME)
                             if output_dir else None)
        self.incarnation = (current_incarnation() if incarnation is None
                            else int(incarnation))
        self.worker = current_worker_id() if worker is None else worker
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        self.retried: Dict[str, Dict[str, Any]] = {}
        if self.path and os.path.exists(self.path):
            self._load_existing(self.path)

    def _stamp(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        if self.worker:
            entry["worker"] = self.worker
        return entry

    def _load_existing(self, path: str) -> None:
        try:
            with open(path) as f:
                prior = json.load(f)
            self.quarantined = dict(prior.get("quarantined", {}))
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as exc:
            quarantine_file(path, reason=f"unreadable ledger: {exc}")
            self.quarantined = {}
            return
        if self.incarnation <= 0:
            return                     # a fresh run's retries start over
        prior_inc = int(prior.get("incarnation", 0) or 0)
        prior_worker = prior.get("worker")
        for w, v in dict(prior.get("retried", {})).items():
            entry = (dict(v) if isinstance(v, dict)
                     else {"attempts": int(v), "incarnation": prior_inc})
            if prior_worker and "worker" not in entry:
                entry["worker"] = prior_worker
            self.retried[w] = entry

    def record_retry(self, word: str, stage: str, exc: BaseException,
                     attempt: int) -> None:
        self.retried[word] = self._stamp({"attempts": attempt,
                                          "incarnation": self.incarnation})
        self.save()

    def record_quarantine(self, word: str, stage: str, exc: BaseException,
                          attempts: int) -> None:
        entry = {
            "stage": stage,
            "attempts": attempts,
            "incarnation": self.incarnation,
            **_describe(exc),
            # tbx: wallclock-ok — serialized epoch timestamp, not a duration
            "at": time.time(),
        }
        # The telemetry seq current at quarantine time, so a postmortem can
        # seek to the surrounding spans in _events.jsonl.
        seq = _obs_last_seq()
        if seq is not None:
            entry["event_seq"] = seq
        self.quarantined[word] = self._stamp(entry)
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
            "incarnation": self.incarnation,
            **({"worker": self.worker} if self.worker else {}),
            "quarantined": self.quarantined,
            "retried": self.retried,
        }

    def save(self) -> None:
        if self.path:
            atomic_json_dump(self.to_dict(), self.path)


def _obs_last_seq() -> Optional[int]:
    try:
        from taboo_brittleness_tpu_torch import obs

        return obs.last_seq()
    except Exception:  # noqa: BLE001 — fail-open
        return None


def _flightrec(kind: str, *, dump: bool = False, **attrs: Any) -> None:
    """Record into the crash flight recorder (and with ``dump`` freeze its
    ring to ``_flightrec[.<wid>].json``); fail-open."""
    try:
        from taboo_brittleness_tpu_torch.obs import flightrec

        flightrec.record(kind, **attrs)
        if dump:
            flightrec.dump("quarantine", word=attrs.get("word"),
                           stage=attrs.get("stage"))
    except Exception:  # noqa: BLE001 — telemetry never takes down a run
        pass


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
    _flightrec("word.attempt", word=word, stage=stage())

    def on_retry(exc: BaseException, attempt: int, delay: float) -> None:
        attempts["n"] = attempt + 1
        if ledger is not None:
            ledger.record_retry(word, stage(), exc, attempt)
        _flightrec("word.retry", word=word, stage=stage(), attempt=attempt,
                   error=f"{type(exc).__name__}: {exc}"[:200])
        _log.warning("%s: attempt %d failed at %s (%s: %s); retrying in %.2fs",
                     word, attempt, stage(), type(exc).__name__, exc, delay)

    try:
        value = policy.call(fn, site=f"{stage()}:{word}", sleep=sleep,
                            on_retry=on_retry)
    except Exception as exc:  # noqa: BLE001 — quarantine, don't crash the sweep
        if ledger is not None:
            ledger.record_quarantine(word, stage(), exc, attempts["n"])
        # The postmortem trigger: the ring of recent records freezes to disk.
        _flightrec("word.quarantine", dump=True, word=word, stage=stage(),
                   attempts=attempts["n"],
                   error=f"{type(exc).__name__}: {exc}"[:200])
        _log.warning("%s: quarantined at %s after %d attempt(s) (%s: %s)",
                     word, stage(), attempts["n"], type(exc).__name__, exc)
        return WordOutcome(word=word, error=exc, attempts=attempts["n"],
                           stage=stage())
    if ledger is not None:
        ledger.record_success(word)
    return WordOutcome(word=word, value=value, attempts=attempts["n"],
                       stage=stage())
