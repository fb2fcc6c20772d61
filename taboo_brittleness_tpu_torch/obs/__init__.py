"""Host-side telemetry for every pipeline: spans, metrics, watermarks, progress.

One subsystem, four surfaces (see the submodule docstrings for depth):

- :mod:`~taboo_brittleness_tpu_torch.obs.trace` — hierarchical spans
  (run → word → phase → program) appended as JSONL to
  ``<output_dir>/_events.jsonl``; render with ``tools/trace_report.py``.
- :mod:`~taboo_brittleness_tpu_torch.obs.metrics` — process-wide
  counters/gauges/histograms, snapshotted into the run manifest.
- :mod:`~taboo_brittleness_tpu_torch.obs.memory` — device live/peak + host
  RSS watermarks at span boundaries.
- :mod:`~taboo_brittleness_tpu_torch.obs.progress` — the ``_progress.json``
  heartbeat (current word/phase, EMA ETA, last-event age).

Contract, repo-wide: obs code is host-side (no new jit entry points),
fail-open (telemetry errors never take down a run), stdlib + ``torch.cuda``
introspection only, and env-gated — ``TBX_OBS=0`` disables the sink
entirely; ``TBX_OBS_MEM`` / ``TBX_OBS_MEM_HZ`` / ``TBX_OBS_PROGRESS_S``
tune the samplers.  Package code emits events through this module instead
of printing.

Sweeps wrap their word loop in :func:`sweep_observer`::

    with obs.sweep_observer(output_dir, pipeline="token_forcing",
                            words=words) as ob:
        for word in words:
            with ob.word(word):
                with ob.phase("checkpoint.load"):
                    ...

The PyTorch port's copy of the JAX package's ``obs/__init__.py``.  The SLO
burn engine (``obs/slo.py``) is fed by the serve loop's metrics spool.  A
fleet worker (``TBX_WORKER_ID``, ``runtime.fleet``) writes per-worker files
(``_events.<wid>.jsonl``, ``_progress.<wid>.json``,
``_metrics.<wid>.jsonl``, ``_flightrec.<wid>.json``) that the fleet merges
at its end.  Not here yet: the device-profile window (``TBX_PROFILE``, JAX
``obs/profile.py``) and the sweep observer's SLO engine.  The fleet
coordinator and its workers open sweep observers; the other pipelines of
the port do not yet (the serving path calls the modules directly).
"""

from __future__ import annotations

import contextlib
import sys
import uuid
from typing import Any, Iterator, Optional, Sequence

from taboo_brittleness_tpu_torch.obs import (
    flightrec, memory, metrics, progress, reqtrace, timeseries, trace)
from taboo_brittleness_tpu_torch.obs.trace import (
    EVENTS_FILENAME, NULL_SPAN, SCHEMA_VERSION, Tracer, activate, deactivate,
    enabled, event, events_path, get_tracer, iter_events, last_seq, span)
from taboo_brittleness_tpu_torch.obs.progress import (
    PROGRESS_FILENAME, ProgressReporter, read_progress)
from taboo_brittleness_tpu_torch.obs.timeseries import (
    METRICS_FILENAME, TimeseriesRecorder)

__all__ = [
    "EVENTS_FILENAME", "METRICS_FILENAME", "PROGRESS_FILENAME",
    "SCHEMA_VERSION", "ProgressReporter", "SweepObserver",
    "TimeseriesRecorder", "Tracer",
    "activate", "deactivate", "enabled", "event", "events_path", "flightrec",
    "get_tracer", "iter_events", "last_seq", "memory", "metrics",
    "progress", "read_progress", "reqtrace", "span", "sweep_observer",
    "timeseries", "trace", "warn",
]


def preempt_notice_seconds() -> float:
    """The platform's preemption notice window (``TBX_PREEMPT_NOTICE_S``,
    default 30).  Drain at a word boundary is safe only while every word
    finishes inside it; the sweep observer measures the margin per word
    and warns when a word outlives it."""
    import os

    try:
        return max(0.0, float(os.environ.get("TBX_PREEMPT_NOTICE_S", "30")))
    except ValueError:
        return 30.0


def warn(message: str, *, name: str = "log.warn", **attrs: Any) -> None:
    """Structured replacement for the package's stray ``print(...)``s: emits
    a point event (when a tracer is active) AND mirrors the line to stderr so
    interactive runs keep their signal.  Fail-open on both paths."""
    event(name, level="warn", message=message, **attrs)
    try:
        sys.stderr.write(message + "\n")
    except Exception:  # noqa: BLE001 — a closed stderr must not kill a run
        pass


class SweepObserver:
    """The per-sweep bundle of tracer + run span + progress heartbeat that
    :func:`sweep_observer` yields.  A disabled observer (``active=False``)
    has the same surface with every method a no-op, so callers never branch.
    """

    def __init__(self, *, tracer: Optional[Tracer] = None,
                 run_span=None,
                 reporter: Optional[ProgressReporter] = None,
                 owns_tracer: bool = False,
                 ts_recorder: Optional[TimeseriesRecorder] = None,
                 mem_sampler: Optional[memory.MemorySampler] = None):
        self.tracer = tracer
        self.run_span = run_span
        self.reporter = reporter
        self._owns_tracer = owns_tracer
        self.ts_recorder = ts_recorder
        self._mem_sampler = mem_sampler
        self._final_status: Optional[str] = None
        self._preempt_notice = preempt_notice_seconds()
        #: Worst slack between the longest computed word and the preemption
        #: notice (negative: a word outlived it, and a drain at a word
        #: boundary no longer fits the notice).
        self.preempt_margin_s: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.tracer is not None

    # -- span helpers ------------------------------------------------------

    @contextlib.contextmanager
    def word(self, word: str, *, resumed: bool = False) -> Iterator[Any]:
        """One word's span + progress bookkeeping.  The span is yielded so
        the caller can attach late attributes (retry counts, quarantine)."""
        if not self.active:
            yield NULL_SPAN
            return
        if self.reporter is not None:
            self.reporter.word_started(word)
        sp = self.tracer.span("word", kind="word", word=word)
        try:
            yield sp
        except BaseException as e:
            sp.end(error=e)
            if self.reporter is not None:
                self.reporter.word_quarantined(word)
            raise
        else:
            quarantined = sp.attrs.get("quarantined", False)
            sp.end()
            if self.reporter is None:
                pass
            elif quarantined:
                self.reporter.word_quarantined(word)
            elif resumed:
                self.reporter.word_skipped(word)
            else:
                self.reporter.word_done(word)
                seconds = _span_duration(sp)
                metrics.histogram("word.seconds").observe(seconds)
                self._note_preempt_margin(word, seconds)

    @contextlib.contextmanager
    def phase(self, name: str, **attrs: Any) -> Iterator[Any]:
        if not self.active:
            yield NULL_SPAN
            return
        if self.reporter is not None:
            self.reporter.phase(name)
        sp = self.tracer.span(name, kind="phase", **attrs)
        try:
            with sp:
                yield sp
        finally:
            if self.reporter is not None:
                self.reporter.phase(None)

    def _note_preempt_margin(self, word: str, seconds: float) -> None:
        """Per-word preemption-notice guard: the worst margin between a
        word's wall time and ``TBX_PREEMPT_NOTICE_S`` as the
        ``sweep.preempt_margin_s`` gauge (and manifest field), and a warning
        when a word outlives the notice."""
        if not self._preempt_notice:
            return
        margin = round(self._preempt_notice - seconds, 3)
        if self.preempt_margin_s is None or margin < self.preempt_margin_s:
            self.preempt_margin_s = margin
            try:
                metrics.gauge("sweep.preempt_margin_s").set(margin)
            except Exception:  # noqa: BLE001 — fail-open
                pass
        if margin < 0:
            warn(f"[obs] word {word!r} ran {seconds:.1f}s, past the "
                 f"{self._preempt_notice:.0f}s preemption notice "
                 "(TBX_PREEMPT_NOTICE_S): a preemption now lands mid-word",
                 name="sweep.preempt_notice_exceeded", word=word,
                 wall_seconds=round(seconds, 3),
                 notice_seconds=self._preempt_notice)

    def mark_drained(self) -> None:
        """The sweep stops between words for a drain
        (``runtime.supervise``): the progress file's final status becomes
        ``"preempted"`` (the supervisor's safe-to-resume marker) and the run
        span carries ``drained=True``."""
        self._final_status = "preempted"
        if self.run_span is not None:
            self.run_span.set(drained=True)
        self.event("sweep.drained")

    def event(self, name: str, **attrs: Any) -> None:
        if self.tracer is not None:
            try:
                self.tracer.event(name, **attrs)
            except Exception:  # noqa: BLE001 — fail-open
                pass

    def close(self, error: Optional[BaseException] = None) -> None:
        if not self.active:
            return
        if self._mem_sampler is not None:
            self._mem_sampler.stop()
        try:
            _publish_aot_stats()
        except Exception:  # noqa: BLE001
            pass
        if self.ts_recorder is not None:
            # Final window + exit snapshot: the conservation invariant
            # ``trace_report --check`` verifies (exit totals == last window).
            try:
                self.ts_recorder.stop()
            except Exception:  # noqa: BLE001 — fail-open
                pass
        if self.run_span is not None:
            if self.preempt_margin_s is not None:
                self.run_span.set(preempt_margin_s=self.preempt_margin_s)
            self.run_span.end(error=error)
        if self.reporter is not None:
            self.reporter.stop(status=self._final_status or (
                "error" if error is not None else "done"))
        if self._owns_tracer and self.tracer is not None:
            deactivate(self.tracer)


def _span_duration(sp) -> float:
    import time

    return time.monotonic() - sp._t0


def _publish_aot_stats() -> None:
    """Fold the graph registry's per-entry hit/miss/capture counters into
    the metrics registry at sweep close (the registry's byte totals, plain
    numbers beside the entries, are skipped)."""
    from taboo_brittleness_tpu_torch.runtime import aot

    for name, st in aot.stats().items():
        if not isinstance(st, dict):
            continue
        for k, v in st.items():
            metrics.gauge(f"aot.{name}.{k}").set(v)


@contextlib.contextmanager
def sweep_observer(output_dir: Optional[str], *, pipeline: str,
                   words: Sequence[str] = (),
                   run_id: Optional[str] = None) -> Iterator[SweepObserver]:
    """Activate telemetry for one sweep (tracer + run span + progress
    heartbeat + metrics spool + flight recorder), fail-open end to end.

    Inert (yields a no-op observer) when obs is disabled (``TBX_OBS=0``) or
    there is no ``output_dir`` to write next to.  When a tracer is already
    active (a sweep nested inside an instrumented sweep — e.g. bench's
    study block), the nested sweep reuses it: its run span and events land
    in the OUTER sink, keeping one coherent timeline, and only the outermost
    observer owns deactivation."""
    import os

    if not enabled() or not output_dir:
        yield SweepObserver()
        return
    try:
        from taboo_brittleness_tpu_torch.runtime.resilience import (
            current_incarnation, current_worker_id)

        # A fleet worker writes per-worker files, so N workers share one
        # output directory; each stream keeps its own monotone seq and the
        # fleet merge folds them at its end.
        wid = current_worker_id()
        events_name = (EVENTS_FILENAME if wid is None
                       else f"_events.{wid}.jsonl")
        progress_name = (PROGRESS_FILENAME if wid is None
                         else f"_progress.{wid}.json")
        outer = get_tracer()
        owns = outer is None
        if owns:
            os.makedirs(output_dir, exist_ok=True)
            tracer = activate(
                os.path.join(output_dir, events_name),
                run_id=run_id or uuid.uuid4().hex[:12])
        else:
            tracer = outer

        inc = current_incarnation()
        run_span = tracer.span(
            "sweep", kind="run", pipeline=pipeline, words_total=len(words),
            **({"incarnation": inc} if inc else {}),
            **({"worker": wid} if wid else {}))
        reporter = ProgressReporter(
            os.path.join(output_dir, progress_name),
            total_words=len(words), run_id=tracer.run_id,
            tracer=tracer).start()
        recorder = None
        if owns:
            # Windowed metrics spool + crash flight recorder.  Only the
            # outermost observer owns the spool — a nested sweep's counters
            # already land in the outer recorder's registry sweeps.
            flightrec.configure(output_dir, worker_id=wid)
            recorder = TimeseriesRecorder(
                os.path.join(output_dir, timeseries.metrics_filename(wid)))
            recorder.start()
        ob = SweepObserver(tracer=tracer, run_span=run_span,
                           reporter=reporter, owns_tracer=owns,
                           ts_recorder=recorder,
                           mem_sampler=memory.MemorySampler(tracer).start())
    except Exception:  # noqa: BLE001 — observability must never block a sweep
        yield SweepObserver()
        return
    try:
        yield ob
    except BaseException as e:
        ob.close(error=e)
        raise
    else:
        ob.close()
