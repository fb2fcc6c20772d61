"""Hierarchical span tracing with an append-only JSONL event sink.

The sweep is a multi-hour, 20-checkpoint grid whose only runtime signals used
to be scattered ``print()``s, end-of-run manifest stage times, and the
resilience ledger — when a run stalls or regresses there was no event
stream to reconstruct *where time and HBM went*.  This module is the event
stream: thread-safe hierarchical spans (run → word → phase → program) with
monotonic timing and structured attributes, appended one JSON line at a time
to ``<output_dir>/_events.jsonl`` (the same directory as the results the
events describe, so a copied/rsynced run keeps its timeline).

Design constraints, all deliberate:

- **Host-side only.**  Nothing here runs under trace; spans wrap dispatches,
  never ops, so no new jit entry points and no graph pollution.
- **Fail-open.**  Telemetry must never take down a run: every sink error is
  swallowed and counted (``obs.events_dropped`` in the metrics registry).
  The one exception is the *deliberate* fault-injection site
  ``obs.event_write`` (runtime.resilience), which tests use to prove exactly
  this property.
- **Atomic appends.**  Each event is one ``os.write`` to an ``O_APPEND`` fd —
  concurrent writers (prefetch threads, the warm-start thread, the renderer)
  interleave whole lines, never bytes.  A torn final line from a killed run
  is skipped by the reader (``iter_events``), matching the repo's
  quarantine-not-crash stance on resume artifacts.
- **Dependency-free.**  stdlib + (lazily) ``torch.cuda`` introspection via obs.memory.

Timing: event ``t`` is seconds on the MONOTONIC clock relative to the
tracer's creation (durations survive NTP steps); the ``run_start`` event
additionally carries one wall-clock epoch so tooling can anchor the timeline
to calendar time.

The PyTorch port's copy of the JAX package's ``obs/trace.py``, with
the same file schemas, so ``tools/trace_report.py`` reads a port run.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

#: Bumped whenever an event record gains/renames a REQUIRED key; readers
#: (tools/trace_report.py) accept their own version and older.
SCHEMA_VERSION = 1

EVENTS_FILENAME = "_events.jsonl"

#: Span kinds, outermost first — the hierarchy trace_report renders.
#: ``request`` spans (serve.scheduler) are per-request lifecycle intervals:
#: they parent under the run span but live OFF the per-thread stack (many
#: interleave on the one serve thread), opened via :meth:`Tracer.span_detached`.
KINDS = ("run", "word", "phase", "program", "request", "point")


def enabled() -> bool:
    """Master switch: ``TBX_OBS=0`` disables activation entirely (the bench's
    obs-off A/B arm); unset/1 enables it.  Individual samplers have their own
    ``TBX_OBS_*`` knobs and default off."""
    return os.environ.get("TBX_OBS", "1") != "0"


def _mem_sample_kinds() -> frozenset:
    """Span kinds whose END events carry an HBM/RSS watermark sample.
    Default: run+word boundaries (one procfs read + one device-stats poll
    per word — noise-level against a multi-second word).  ``TBX_OBS_MEM=0``
    turns boundary sampling off, ``phase`` adds phase ends, ``all`` adds
    program spans too (one sample per launch — noticeably chattier)."""
    v = os.environ.get("TBX_OBS_MEM", "1")
    if v == "0":
        return frozenset()
    if v == "phase":
        return frozenset({"run", "word", "phase"})
    if v == "all":
        return frozenset({"run", "word", "phase", "program"})
    return frozenset({"run", "word"})


class Span:
    """One timed interval.  Use as a context manager::

        with tracer.span("decode", kind="program", rows=40) as sp:
            sp.set(aot="hit")

    On exit the end event records ``dur`` (seconds) and ``status``
    ("ok"/"error" + the exception type).  ``event()`` emits point events
    parented to this span."""

    __slots__ = ("tracer", "name", "kind", "span_id", "parent_id",
                 "attrs", "_t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, kind: str,
                 span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.kind = kind
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = time.monotonic()
        self._done = False

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes that will ride on the span's END event (e.g.
        retry_count known only after the work ran)."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        self.tracer.event(name, parent=self.span_id, **attrs)

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(error=exc)

    def end(self, error: Optional[BaseException] = None) -> None:
        if self._done:      # idempotent: __exit__ after an explicit end()
            return
        self._done = True
        rec = {
            "ev": "end",
            "kind": self.kind,
            "name": self.name,
            "id": self.span_id,
            "dur": round(time.monotonic() - self._t0, 6),
            "status": "error" if error is not None else "ok",
        }
        if self.parent_id is not None:
            rec["parent"] = self.parent_id
        if error is not None:
            rec["error"] = f"{type(error).__name__}: {error}"[:500]
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.kind in self.tracer.mem_kinds:
            mem = self.tracer._memory()
            if mem:
                rec["mem"] = mem
        self.tracer._pop(self)
        self.tracer._emit(rec)


#: Buffered-sink flush policy: events accumulate in memory and hit disk on
#: whichever trips first — byte cap, age, or close.  One os.write per flush
#: keeps per-event cost at ~a microsecond (a 200-event sweep word costs the
#: sink two syscalls, not 200) while the file trails live state by at most
#: _FLUSH_INTERVAL_S — the progress heartbeat flushes too, so "is it alive"
#: reads stay fresh.
_FLUSH_BYTES = 32 * 1024
_FLUSH_INTERVAL_S = 1.0


def _resume_marks(path: str) -> "tuple[int, int]":
    """(last seq, max span id) parsed from an existing sink's tail window.

    A supervised run appends several processes' event streams to ONE
    ``_events.jsonl`` (each incarnation, plus the supervisor's own point
    events between launches).  Resuming both counters from the file keeps
    the merged stream's ``seq`` strictly monotone and its span ids unique —
    the invariants ``trace_report --check`` holds the schema to — without
    any cross-process coordination beyond O_APPEND.  Torn tail lines (a
    killed incarnation) are skipped, matching ``iter_events``.  Spans older
    than the 64 KiB tail window can in principle alias an id; that degrades
    a rendered report, never a run.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0, 0
    if not size:
        return 0, 0
    try:
        with open(path, "rb") as f:
            f.seek(max(0, size - 65536))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return 0, 0
    seq = max_id = 0
    for line in tail.splitlines():
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if not isinstance(ev, dict):
            continue
        try:
            seq = max(seq, int(ev.get("seq", 0) or 0))
            max_id = max(max_id, int(ev.get("id", 0) or 0))
        except (TypeError, ValueError):
            continue
    return seq, max_id


class Tracer:
    """One run's event sink.  All methods are thread-safe; parentage is
    tracked per-thread (a span opened on a worker thread without an explicit
    ``parent=`` nests under nothing, not under another thread's span).

    Opening a sink that already has events RESUMES its seq/span-id counters
    from the file tail (:func:`_resume_marks`) — the incarnation-aware
    append contract of ``runtime.supervise``."""

    def __init__(self, path: Optional[str], *, run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id
        self.mem_kinds = _mem_sample_kinds()
        # Fleet worker identity (runtime.fleet): stamped top-level on every
        # event this process emits, so per-worker streams stay
        # self-identifying after the fleet merge folds them into one file.
        try:
            from taboo_brittleness_tpu_torch.runtime.resilience import (
                current_worker_id)

            self._worker = current_worker_id()
        except Exception:  # noqa: BLE001 — identity is best-effort
            self._worker = None
        self._fd: Optional[int] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._next_id = 1
        self._local = threading.local()
        self._t0 = time.monotonic()
        self._last_event_mono = self._t0
        self._buf: List[bytes] = []
        self._buf_bytes = 0
        self._last_flush = self._t0
        self.dropped = 0
        if path is not None:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                seq0, id0 = _resume_marks(path)
                self._seq, self._next_id = seq0, id0 + 1
                self._fd = os.open(
                    path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            except OSError:
                self._fd = None      # fail-open: spans still time, sink drops

    # -- core emit ---------------------------------------------------------

    def _memory(self) -> Optional[Dict[str, Any]]:
        try:
            from taboo_brittleness_tpu_torch.obs import memory as memory_mod

            return memory_mod.sample(compact=True)
        except Exception:  # noqa: BLE001 — sampling is best-effort
            return None

    def _emit(self, rec: Dict[str, Any]) -> None:
        """Buffer one event line (flushed by size/age/heartbeat/close).
        NEVER raises (fail-open): a failed serialize/write increments
        ``dropped`` (and the obs.events_dropped counter) and the run
        continues untouched."""
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            rec = {"v": SCHEMA_VERSION, "seq": self._seq,
                   "t": round(now - self._t0, 6), **rec}
            if self._worker is not None:
                rec.setdefault("worker", self._worker)
            self._last_event_mono = now
            if self._fd is None:
                return
            try:
                from taboo_brittleness_tpu_torch.runtime import resilience

                resilience.fire("obs.event_write", path=self.path,
                                name=rec.get("name", ""))
                line = (json.dumps(rec, default=str) + "\n").encode("utf-8")
                self._buf.append(line)
                self._buf_bytes += len(line)
                if (self._buf_bytes >= _FLUSH_BYTES
                        or now - self._last_flush >= _FLUSH_INTERVAL_S):
                    self._flush_locked()
            except Exception:  # noqa: BLE001 — telemetry must never kill a run
                self.dropped += 1
                try:
                    from taboo_brittleness_tpu_torch.obs import metrics

                    metrics.counter("obs.events_dropped").inc()
                except Exception:  # noqa: BLE001
                    pass

    def _flush_locked(self) -> None:
        """One os.write of every buffered line (whole lines, so concurrent
        tracers still interleave at line granularity via O_APPEND).  Caller
        holds the lock."""
        self._last_flush = time.monotonic()
        if not self._buf or self._fd is None:
            return
        buf, self._buf = self._buf, []
        n_bytes, self._buf_bytes = self._buf_bytes, 0
        try:
            os.write(self._fd, b"".join(buf))
        except Exception:  # noqa: BLE001 — fail-open: the batch is dropped
            self.dropped += len(buf)
            _ = n_bytes

    def flush(self) -> None:
        """Force buffered events to disk (heartbeat hook; tests)."""
        with self._lock:
            try:
                self._flush_locked()
            except Exception:  # noqa: BLE001
                pass

    # -- per-thread span stack --------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if span in st:
            del st[st.index(span):]

    # -- public API --------------------------------------------------------

    def span(self, name: str, *, kind: str = "phase",
             parent: Optional[int] = None, **attrs: Any) -> Span:
        cur = self.current_span()
        parent_id = parent if parent is not None else (
            cur.span_id if cur is not None else None)
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        rec: Dict[str, Any] = {"ev": "start", "kind": kind, "name": name,
                               "id": span_id}
        if parent_id is not None:
            rec["parent"] = parent_id
        if attrs:
            rec["attrs"] = dict(attrs)
        if kind == "run":
            rec["run_id"] = self.run_id
            rec["pid"] = os.getpid()
            # Epoch anchor for the otherwise-relative monotonic timeline.
            # tbx: wallclock-ok — genuine epoch timestamp (durations use monotonic)
            rec["wall"] = time.time()
        self._emit(rec)
        sp = Span(self, name, kind, span_id, parent_id, dict(attrs))
        self._stack().append(sp)
        return sp

    def span_detached(self, name: str, *, kind: str = "request",
                      parent: Optional[int] = None, **attrs: Any) -> Span:
        """Open a span WITHOUT joining the per-thread stack.

        For intervals that overlap arbitrarily on one thread (the serve
        loop's per-request lifecycle spans: many requests in flight, none
        nesting inside another): the span still parents under the thread's
        current span (or an explicit ``parent=``), but later ``span()``
        calls on this thread do NOT nest under it, and ending it cannot
        pop unrelated spans off the stack.  End explicitly via
        ``sp.end()``."""
        cur = self.current_span()
        parent_id = parent if parent is not None else (
            cur.span_id if cur is not None else None)
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        rec: Dict[str, Any] = {"ev": "start", "kind": kind, "name": name,
                               "id": span_id}
        if parent_id is not None:
            rec["parent"] = parent_id
        if attrs:
            rec["attrs"] = dict(attrs)
        self._emit(rec)
        return Span(self, name, kind, span_id, parent_id, dict(attrs))

    def event(self, name: str, *, parent: Optional[int] = None,
              **attrs: Any) -> None:
        """A zero-duration point event (retry, quarantine, prefetch start,
        aot build record, log line...)."""
        cur = self.current_span()
        parent_id = parent if parent is not None else (
            cur.span_id if cur is not None else None)
        rec: Dict[str, Any] = {"ev": "point", "kind": "point", "name": name}
        if parent_id is not None:
            rec["parent"] = parent_id
        if attrs:
            rec["attrs"] = dict(attrs)
        self._emit(rec)

    def last_seq(self) -> int:
        """Sequence number of the most recent event — the 'event offset' the
        failure ledger records next to a quarantine so the surrounding
        timeline is one seek away."""
        with self._lock:
            return self._seq

    def last_event_age(self) -> float:
        """Seconds since the last emitted event (the progress heartbeat's
        liveness signal)."""
        with self._lock:
            return time.monotonic() - self._last_event_mono

    def close(self) -> None:
        with self._lock:
            try:
                self._flush_locked()
            except Exception:  # noqa: BLE001
                pass
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


# ---------------------------------------------------------------------------
# Process-wide tracer stack.
#
# Shared code (decode launches, checkpoint prefetch, aot builds, resilience
# retries) emits to the INNERMOST active tracer; with none active every call
# is a cheap no-op.  A stack (not a single slot) so a sweep nested inside
# another instrumented sweep (bench's study block) keeps one coherent sink.
# ---------------------------------------------------------------------------

_STACK: List[Tracer] = []
_STACK_LOCK = threading.Lock()
_LAST_PATH: Optional[str] = None


def activate(path: Optional[str], *, run_id: Optional[str] = None) -> Tracer:
    """Open a tracer writing to ``path`` (a JSONL file, or None for a
    sink-less tracer that still times spans) and make it current."""
    global _LAST_PATH
    t = Tracer(path, run_id=run_id)
    with _STACK_LOCK:
        _STACK.append(t)
        if path is not None:
            _LAST_PATH = path
    return t


def deactivate(tracer: Tracer) -> None:
    with _STACK_LOCK:
        if tracer in _STACK:
            _STACK.remove(tracer)
    tracer.close()


def get_tracer() -> Optional[Tracer]:
    with _STACK_LOCK:
        return _STACK[-1] if _STACK else None


def events_path() -> Optional[str]:
    """The innermost active tracer's sink path — falling back to the most
    recently activated one, since the manifest is saved AFTER the sweep's
    observer closes (the stamp must survive deactivation)."""
    t = get_tracer()
    if t is not None and t.path is not None:
        return t.path
    with _STACK_LOCK:
        return _LAST_PATH


# -- module-level conveniences (no-ops without an active tracer) ------------

class _NullSpan:
    """Stand-in span when no tracer is active: same surface, zero cost."""

    span_id = None
    parent_id = None

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self, error: Optional[BaseException] = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(name: str, *, kind: str = "phase", **attrs: Any):
    t = get_tracer()
    if t is None:
        return NULL_SPAN
    try:
        return t.span(name, kind=kind, **attrs)
    except Exception:  # noqa: BLE001 — fail-open
        return NULL_SPAN


def span_detached(name: str, *, kind: str = "request", **attrs: Any):
    t = get_tracer()
    if t is None:
        return NULL_SPAN
    try:
        return t.span_detached(name, kind=kind, **attrs)
    except Exception:  # noqa: BLE001 — fail-open
        return NULL_SPAN


def event(name: str, **attrs: Any) -> None:
    t = get_tracer()
    if t is None:
        return
    try:
        t.event(name, **attrs)
    except Exception:  # noqa: BLE001 — fail-open
        pass


def last_seq() -> Optional[int]:
    t = get_tracer()
    return t.last_seq() if t is not None else None


# ---------------------------------------------------------------------------
# Reader.
# ---------------------------------------------------------------------------

def iter_events(path: str, *, strict: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield events from a JSONL sink, skipping unparseable lines (a torn
    final line from a killed run is expected, not an error).  ``strict=True``
    raises on the first bad line instead (trace_report --check)."""
    with io.open(path, "r", encoding="utf-8", errors="replace") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                if strict:
                    raise ValueError(f"{path}:{lineno}: unparseable event line")
                continue
