"""Windowed metrics spool: the registry, snapshotted every N seconds.

The metrics registry (``obs.metrics``) is cumulative-since-process-start —
right for the manifest's exit snapshot, wrong for "is the run healthy NOW":
a mid-run SLO regression is arithmetically masked by old samples, and a
multi-hour fleet run is blind between heartbeats.  The recorder closes that
gap: a daemon thread rolls the registry into fixed-width windows (default
10 s, ``TBX_OBS_TS_S``) and appends each window as ONE JSON line to
``<output_dir>/_metrics.jsonl``:

- **Counters** carry ``{"total", "delta"}`` — cumulative value plus the
  per-window increment, so both rates and conservation
  (``total_i == total_{i-1} + delta_i``, checked by ``trace_report
  --check``) fall out of the stream.
- **Gauges** carry their instantaneous value (the recorder refreshes the
  HBM/RSS watermark gauges via ``obs.memory`` just before snapshotting).
- **Histograms** carry REAL per-window p50/p99: every histogram keeps a
  window-forked reservoir (``Histogram.roll_window``) that resets each
  window, next to the cumulative one.
- An optional SLO engine (``obs.slo``) is evaluated at each roll from the
  same fork (raw reservoir samples never leave the process) and its burn
  block rides the window record.

At :meth:`~TimeseriesRecorder.stop` the recorder rolls one final window and
then writes an ``exit`` record FROM THE SAME SNAPSHOT, so "final window ≈
exit snapshot" conservation is exact by construction — the other invariant
``trace_report --check`` holds the stream to.

Write discipline mirrors ``obs.trace``: whole-line ``O_APPEND`` writes
(concurrent writers interleave lines, never bytes), seq resumed from the
file tail across incarnations, fail-open with drop counting
(``obs.metrics_dropped``) through the deliberate ``obs.metrics_write``
fault site, and per-worker suffixed files (``_metrics.<wid>.jsonl``) in
fleet mode, merged at fleet end like ``_events.jsonl``.

The PyTorch port's copy of the JAX package's ``obs/timeseries.py``, with
the same file schemas, so ``tools/trace_report.py`` reads a port run.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics

#: Bumped whenever a window record gains/renames a REQUIRED key; readers
#: (tools/trace_report.py, obs.top) accept their own version and older.
SCHEMA_VERSION = 1

METRICS_FILENAME = "_metrics.jsonl"


def window_seconds() -> float:
    """Window width from ``TBX_OBS_TS_S`` (default 10 s, floor 0.2)."""
    try:
        return max(0.2, float(os.environ.get("TBX_OBS_TS_S", "10")))
    except ValueError:
        return 10.0


def metrics_filename(worker_id: Optional[str] = None) -> str:
    return (METRICS_FILENAME if worker_id is None
            else f"_metrics.{worker_id}.jsonl")


def _resume_seq(path: str) -> int:
    """Last ``seq`` in an existing spool's tail window, so a supervised
    relaunch appends a strictly-monotone stream (same contract as
    ``trace._resume_marks``; torn tail lines skipped)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if not size:
        return 0
    try:
        with open(path, "rb") as f:
            f.seek(max(0, size - 65536))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return 0
    seq = 0
    for line in tail.splitlines():
        try:
            rec = json.loads(line)
            seq = max(seq, int(rec.get("seq", 0) or 0))
        except (ValueError, TypeError, AttributeError):
            continue
    return seq


class TimeseriesRecorder:
    """One process's windowed spool: a daemon thread calling :meth:`roll`
    every ``window_s``.  All IO is fail-open; ``clock`` is injectable so
    tests roll windows deterministically instead of sleeping."""

    def __init__(self, path: str, *,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 window_s: Optional[float] = None,
                 slo_engine=None,
                 on_window: Optional[Callable[[Dict[str, Any]], None]] = None,
                 sample_memory: bool = True,
                 clock=time.monotonic):
        self.path = path
        self.registry = registry or obs_metrics.registry()
        self.window_s = window_seconds() if window_s is None else window_s
        self.slo_engine = slo_engine
        #: Called (fail-open) with each written window record — the serve
        #: loop uses it to lift the ``slo`` block into the heartbeat.
        self.on_window = on_window
        self.sample_memory = sample_memory
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_open = clock()
        self._w_start = self._t_open
        self._prev_counters: Dict[str, float] = {}
        self._last_window: Optional[Dict[str, Any]] = None
        self.windows = 0
        self.dropped = 0
        self._seq = 0
        self._fd: Optional[int] = None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._seq = _resume_seq(path)
            self._fd = os.open(
                path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        except OSError:
            self._fd = None      # fail-open: windows still roll, writes drop

    # -- snapshot / roll ---------------------------------------------------

    def _collect(self) -> Dict[str, Any]:
        """One registry sweep: counter totals+deltas, gauge values, and the
        per-histogram window fork (with raw samples, in-memory only)."""
        if self.sample_memory:
            # Refresh the HBM/RSS watermark gauges so idle windows still
            # carry a live memory signal (serve mode has no span boundaries).
            try:
                from taboo_brittleness_tpu_torch.obs import memory

                memory.sample(compact=True)
            except Exception:  # noqa: BLE001 — sampling is best-effort
                pass
        counters: Dict[str, Dict[str, float]] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for name, inst in sorted(self.registry.instruments().items()):
            if isinstance(inst, obs_metrics.Counter):
                total = inst.value
                counters[name] = {
                    "total": total,
                    "delta": total - self._prev_counters.get(name, 0.0)}
                self._prev_counters[name] = total
            elif isinstance(inst, obs_metrics.Gauge):
                if inst.value is not None:
                    gauges[name] = inst.value
            elif isinstance(inst, obs_metrics.Histogram):
                if inst.count:
                    win = inst.roll_window()
                    win["cum_n"] = inst.count
                    hists[name] = win
        return {"counters": counters, "gauges": gauges, "hists": hists}

    def roll(self) -> Optional[Dict[str, Any]]:
        """Close the current window: snapshot the registry, evaluate SLOs,
        append one ``window`` record.  Returns the record (None if the
        recorder raced its own stop)."""
        with self._lock:
            now = self._clock()
            t0, self._w_start = self._w_start, now
            snap = self._collect()
            dur = max(1e-9, now - t0)
            slo_block = None
            if self.slo_engine is not None:
                try:
                    slo_block = self.slo_engine.observe_window(
                        dur=dur, hists=snap["hists"],
                        counter_deltas={n: c["delta"]
                                        for n, c in snap["counters"].items()},
                        gauges=snap["gauges"])
                except Exception:  # noqa: BLE001 — SLO eval must be fail-open
                    slo_block = None
            self._seq += 1
            rec: Dict[str, Any] = {
                "v": SCHEMA_VERSION,
                "kind": "window",
                "seq": self._seq,
                "pid": os.getpid(),
                # Epoch anchor so merged multi-host streams stay orderable.
                # tbx: wallclock-ok — cross-process ordering anchor
                "wall": time.time(),
                "t0": round(t0 - self._t_open, 6),
                "t1": round(now - self._t_open, 6),
                "window_s": self.window_s,
                "counters": snap["counters"],
                "gauges": snap["gauges"],
                "histograms": {
                    name: {
                        "n": win["n"],
                        "sum": round(win["sum"], 6),
                        "max": win["max"],
                        "p50": obs_metrics.quantile_of(win["samples"], 0.50),
                        "p99": obs_metrics.quantile_of(win["samples"], 0.99),
                        "cum_n": win["cum_n"],
                    }
                    for name, win in snap["hists"].items()},
            }
            if slo_block:
                rec["slo"] = slo_block
            self._write(rec)
            self.windows += 1
            self._last_window = rec
        if self.on_window is not None:
            try:
                self.on_window(rec)
            except Exception:  # noqa: BLE001 — a heartbeat hook must not kill
                pass
        return rec

    def _write(self, rec: Dict[str, Any]) -> None:
        """One whole-line O_APPEND write, fail-open through the deliberate
        ``obs.metrics_write`` fault site: an injected (or real) sink fault
        drops the window — counted, never fatal."""
        if self._fd is None:
            self.dropped += 1
            return
        try:
            from taboo_brittleness_tpu_torch.runtime import resilience

            resilience.fire("obs.metrics_write", path=self.path,
                            seq=rec.get("seq"), kind=rec.get("kind"))
            line = (json.dumps(rec, default=str) + "\n").encode("utf-8")
            os.write(self._fd, line)
        except Exception:  # noqa: BLE001 — telemetry must never kill a run
            self.dropped += 1
            try:
                obs_metrics.counter("obs.metrics_dropped").inc()
            except Exception:  # noqa: BLE001
                pass

    def last_window(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._last_window) if self._last_window else None

    def last_slo(self) -> Optional[Dict[str, Any]]:
        win = self.last_window()
        return win.get("slo") if win else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TimeseriesRecorder":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tbx-obs-timeseries", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.window_s):
            try:
                self.roll()
            except Exception:  # noqa: BLE001 — the spool must never crash
                pass

    def stop(self) -> None:
        """Final roll + exit record + close.  The exit record's totals come
        from the final window's own snapshot, so the conservation invariant
        (exit ≡ last window cumulative) is exact, not approximate."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        try:
            final = self.roll()
        except Exception:  # noqa: BLE001
            final = None
        with self._lock:
            if final is not None:
                self._seq += 1
                self._write({
                    "v": SCHEMA_VERSION,
                    "kind": "exit",
                    "seq": self._seq,
                    "pid": os.getpid(),
                    # tbx: wallclock-ok — cross-process ordering anchor
                    "wall": time.time(),
                    "t": final["t1"],
                    "counters": {n: c["total"]
                                 for n, c in final["counters"].items()},
                    "gauges": final["gauges"],
                    "histograms": {
                        n: {"cum_n": h["cum_n"]}
                        for n, h in final["histograms"].items()},
                })
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    def __enter__(self) -> "TimeseriesRecorder":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def iter_windows(path: str, *,
                 strict: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield records from a ``_metrics.jsonl`` spool, skipping torn lines
    (a killed incarnation's partial final write is expected, not an error).
    ``strict=True`` raises on the first bad line (trace_report --check)."""
    from taboo_brittleness_tpu_torch.obs import trace

    yield from trace.iter_events(path, strict=strict)


__all__ = [
    "METRICS_FILENAME", "SCHEMA_VERSION", "TimeseriesRecorder",
    "iter_windows", "metrics_filename", "window_seconds",
]
