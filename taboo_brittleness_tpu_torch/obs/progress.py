"""Live sweep progress: a heartbeat-rewritten ``_progress.json``.

A stalled remote sweep used to be diagnosable only by attaching to the host
or waiting for the run to (not) finish.  The reporter makes the current state
one ``cat`` away: a daemon thread atomically rewrites
``<output_dir>/_progress.json`` every few seconds with the current word and
phase, words done/total, an ETA from a completed-word EMA, the age of the
last telemetry event, and the heartbeat's own timestamp — so both "which word
is it on" and "is it even alive" are answerable without attaching.

Staleness has two distinct signals, deliberately:

- ``updated_at`` older than ~2 heartbeat intervals → the PROCESS is gone or
  wedged (the heartbeat thread itself stopped).
- ``last_event_age_seconds`` large while ``updated_at`` is fresh → the
  process is alive but the PIPELINE has gone quiet (a hung checkpoint read,
  a compile that never returns) — exactly the "where did the time go" case
  the span stream then answers.

Everything is fail-open and stdlib-only; the file is written via the shared
atomic tmp+rename so readers never see a torn JSON.

The PyTorch port's copy of the JAX package's ``obs/progress.py``, with
the same file schemas, so ``tools/trace_report.py`` reads a port run.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from taboo_brittleness_tpu_torch.runtime.resilience import (
    atomic_json_dump, current_incarnation, current_worker_id)

PROGRESS_FILENAME = "_progress.json"

#: EMA weight for completed-word seconds: ~last 6 words dominate, so the ETA
#: tracks drift (later checkpoints decoding longer responses) without one
#: outlier word whipsawing it.
_EMA_ALPHA = 0.3


def heartbeat_interval() -> float:
    try:
        return max(0.2, float(os.environ.get("TBX_OBS_PROGRESS_S", "5")))
    except ValueError:
        return 5.0


class ProgressReporter:
    """Heartbeat thread + thread-safe state setters.

    Use as a context manager; sweeps call :meth:`word_started`,
    :meth:`word_done`, :meth:`word_skipped`, and :meth:`phase` as the sweep
    moves.  ``tracer`` (optional) supplies ``last_event_age_seconds``;
    ``clock`` is injectable so tests drive time instead of sleeping."""

    def __init__(self, path: str, *, total_words: int,
                 run_id: Optional[str] = None,
                 tracer=None,
                 interval: Optional[float] = None,
                 min_write_interval: float = 0.5,
                 clock=time.monotonic):
        self.path = path
        self.run_id = run_id
        self.tracer = tracer
        self.interval = heartbeat_interval() if interval is None else interval
        # Word/phase transitions write through only this often; faster
        # transitions (memoized words resolving in ms) just update in-memory
        # state and let the heartbeat flush — progress IO must stay
        # noise-level even when the sweep itself is fast.
        self.min_write_interval = min_write_interval
        self._clock = clock
        self._last_write: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state: Dict[str, Any] = {
            "current_word": None,
            "phase": None,
            "words_done": 0,
            "words_total": total_words,
            "words_quarantined": 0,
            "status": "running",
        }
        self._word_t0: Optional[float] = None
        self._ema: Optional[float] = None
        self._serving: Optional[Dict[str, Any]] = None
        self._serving_latency: Optional[Dict[str, Any]] = None
        self._serving_slots: Optional[Dict[str, Any]] = None
        self._slo: Optional[Dict[str, Any]] = None
        self._last_step_mono: Optional[float] = None

    # -- state setters (all thread-safe, all fail-open at the write) -------

    def word_started(self, word: str) -> None:
        with self._lock:
            self._state["current_word"] = word
            self._state["phase"] = None
            self._word_t0 = self._clock()
        self._write_throttled()

    def phase(self, name: Optional[str]) -> None:
        with self._lock:
            self._state["phase"] = name

    def word_done(self, word: str, *, seconds: Optional[float] = None) -> None:
        with self._lock:
            if seconds is None and self._word_t0 is not None:
                seconds = self._clock() - self._word_t0
            self._word_t0 = None
            self._state["words_done"] += 1
            if seconds is not None:
                self._ema = (seconds if self._ema is None
                             else _EMA_ALPHA * seconds
                             + (1.0 - _EMA_ALPHA) * self._ema)
        self._write_throttled()

    def word_skipped(self, word: str) -> None:
        """A resumed word: counts toward done but not toward the EMA (a
        skip costs milliseconds and would poison the ETA)."""
        with self._lock:
            self._state["words_done"] += 1
        self._write_throttled()

    def word_quarantined(self, word: str) -> None:
        with self._lock:
            self._state["words_quarantined"] += 1
            self._word_t0 = None
        self._write_throttled()

    def serving_update(self, *, in_flight: int, completed: int,
                       queued: int = 0, stepped: bool = False,
                       latency: Optional[Dict[str, Any]] = None,
                       slo: Optional[Dict[str, Any]] = None,
                       slots: Optional[Dict[str, Any]] = None) -> None:
        """Serving-mode heartbeat state (``tbx serve``).

        The word-sweep staleness classifier assumes word-boundary progress —
        a long-lived server that is healthy but IDLE emits no events, which
        the two-signal rule would misread as "pipeline wedged".  Serving
        mode publishes what liveness actually means for a server: the
        in-flight session count, the completed-request counter, and the age
        of the last decode step (``stepped=True`` marks one).  The
        supervisor's wedge classifier (``runtime.supervise._wedge_reason``)
        keys off ``workload == "serve"``: idle-but-alive is healthy by
        heartbeat alone; only in-flight sessions with a stalled step clock
        wedge.

        ``latency`` carries the per-scenario
        percentiles from ``SlotScheduler.latency_percentiles``: WINDOWED
        p50/p99 (the window-forked reservoirs, stamped with ``window_s`` and
        per-window sample counts) next to the honestly-labeled cumulative
        view.  The last non-None value persists across heartbeats (the
        scheduler only recomputes it when requests complete).

        ``slo`` is the burn-rate block from ``obs.slo.SloEngine``
        — ``{series: {burn, fast, slow, ok}}`` — refreshed each timeseries
        window; it rides the heartbeat so a supervisor or replica router can
        admit on it without parsing the spool.

        ``slots`` is the occupancy block — ``{width, active,
        free, verdict}``, where ``width`` is the HBM-watermark autotuner's
        solved admission cap (``serve.autotune``) and ``verdict`` how it
        was reached — so the replica router can weight placement by free
        slots and shed when every replica reports ``free == 0``.  Like
        ``latency``, the last non-None block persists across heartbeats."""
        now = self._clock()
        with self._lock:
            prev_in_flight = (int(self._serving.get("in_flight", 0))
                              if self._serving else 0)
            # The step clock restarts when work ARRIVES (0 -> >0), not just
            # when a step completes: the serve loop publishes in-flight
            # before stepping so a step that wedges is visible, and an
            # idle-for-hours server must not read as instantly wedged the
            # moment its first request lands.
            if (stepped or self._last_step_mono is None
                    or (in_flight > 0 and prev_in_flight == 0)):
                self._last_step_mono = now
            if latency is not None:
                self._serving_latency = latency
            if slo is not None:
                self._slo = slo
            if slots is not None:
                self._serving_slots = dict(slots)
            self._serving = {
                "in_flight": int(in_flight),
                "completed_requests": int(completed),
                "queued": int(queued),
            }
        self._write_throttled()

    def set_slo(self, block: Optional[Dict[str, Any]]) -> None:
        """Update the heartbeat's ``slo`` block outside a serving update
        (sweep/fleet mode, where the timeseries recorder drives it)."""
        if block is None:
            return
        with self._lock:
            self._slo = dict(block)

    def finish(self, status: str = "done") -> None:
        with self._lock:
            self._state["status"] = status
            self._state["current_word"] = None
            self._state["phase"] = None
        self.write_now()

    # -- snapshot / write --------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            state = dict(self._state)
            ema = self._ema
            word_t0 = self._word_t0
            serving = dict(self._serving) if self._serving else None
            serving_latency = (dict(self._serving_latency)
                               if self._serving_latency else None)
            serving_slots = (dict(self._serving_slots)
                             if self._serving_slots else None)
            slo = dict(self._slo) if self._slo else None
            last_step = self._last_step_mono
        remaining = max(
            0, state["words_total"] - state["words_done"]
            - state["words_quarantined"])
        eta = None
        if ema is not None:
            eta = ema * remaining
            if word_t0 is not None and remaining > 0:
                # Credit the in-flight word's elapsed time against its slot.
                eta -= min(ema, max(0.0, self._clock() - word_t0))
        out = {
            "v": 1,
            "run_id": self.run_id,
            "pid": os.getpid(),
            # Supervised-run ordinal (0 standalone): the supervisor matches
            # this + pid so a predecessor's stale file never reads as the
            # fresh child being wedged.
            "incarnation": current_incarnation(),
            # Fleet worker identity (runtime.fleet; None standalone) — the
            # per-worker supervisor watches _progress.<worker_id>.json.
            **({"worker": current_worker_id()}
               if current_worker_id() else {}),
            # Epoch timestamp: the reader computes staleness as now - this.
            # tbx: wallclock-ok — heartbeat freshness mark, not duration math
            "updated_at": time.time(),
            "heartbeat_seconds": self.interval,
            **state,
            "word_seconds_ema": round(ema, 3) if ema is not None else None,
            "eta_seconds": round(eta, 1) if eta is not None else None,
        }
        if serving is not None:
            out["workload"] = "serve"
            if last_step is not None:
                serving["last_step_age_seconds"] = round(
                    max(0.0, self._clock() - last_step), 3)
            if serving_latency:
                serving["latency"] = serving_latency
            if serving_slots:
                serving["slots"] = serving_slots
            out["serving"] = serving
        if slo:
            out["slo"] = slo
        if self.tracer is not None:
            try:
                out["last_event_age_seconds"] = round(
                    self.tracer.last_event_age(), 3)
            except Exception:  # noqa: BLE001
                pass
        return out

    def write_now(self) -> None:
        try:
            atomic_json_dump(self.snapshot(), self.path)
            # Both the heartbeat thread and the main-side setters land here;
            # the throttle mark has to be read/written under the lock.
            with self._lock:
                self._last_write = self._clock()
        except Exception:  # noqa: BLE001 — progress must never kill the sweep
            pass

    def _write_throttled(self) -> None:
        with self._lock:
            last = self._last_write
        if last is None or self._clock() - last >= self.min_write_interval:
            self.write_now()

    # -- heartbeat thread --------------------------------------------------

    def start(self) -> "ProgressReporter":
        if self._thread is None:
            self.write_now()
            self._thread = threading.Thread(
                target=self._run, name="tbx-obs-progress", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.write_now()
            # Keep the event sink at most a heartbeat stale too (the tracer
            # buffers writes): a wedged pipeline's last events reach disk
            # even though nothing is emitting.
            flush = getattr(self.tracer, "flush", None)
            if flush is not None:
                try:
                    flush()
                except Exception:  # noqa: BLE001
                    pass

    def stop(self, *, status: str = "done") -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self.finish(status)

    def __enter__(self) -> "ProgressReporter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(status="error" if exc_type is not None else "done")


def read_progress(path: str, *,
                  stale_after: Optional[float] = None,
                  missing_ok: bool = False) -> Dict[str, Any]:
    """Load a progress file and derive liveness:

    - ``age_seconds``: now - updated_at (wall clock; the writer may be
      another host, so monotonic cannot apply here).
    - ``stale``: age > ``stale_after`` (default: 3x the file's own heartbeat
      interval) — the process is presumed dead or wedged.

    ``missing_ok=True`` turns a missing/unreadable file into
    ``{"status": "absent", "stale": False}`` instead of raising: before the
    first heartbeat lands there is nothing to read, and a watcher (the
    supervisor, a remote poll loop) must not need a try/except racing the
    child's startup.
    """
    import json

    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        if missing_ok:
            return {"status": "absent", "stale": False}
        raise
    # tbx: wallclock-ok — cross-process freshness check needs the epoch clock
    age = max(0.0, time.time() - float(data.get("updated_at", 0)))
    threshold = (stale_after if stale_after is not None
                 else 3.0 * float(data.get("heartbeat_seconds", 5.0)))
    data["age_seconds"] = round(age, 3)
    data["stale"] = bool(age > threshold and data.get("status") == "running")
    return data
