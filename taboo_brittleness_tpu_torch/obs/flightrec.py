"""Crash flight recorder: a bounded in-memory ring of recent records.

A quarantine, a wedge-kill, or a SIGTERM drain used to leave a postmortem
that starts from nothing: the event stream shows spans, but "what were the
last N steps/requests/leases immediately before it died" had to be
reconstructed by hand.  The flight recorder is that answer, kept cheap
enough to always be on:

- Hot paths call :func:`record` (a dict build + a ``deque`` append — no
  lock, no IO).  The ring holds the most recent ``TBX_FLIGHTREC_N``
  records (default 256; 0 disables recording entirely).
- Crash paths call :func:`dump`, which atomically writes the ring to
  ``<output_dir>/_flightrec.json`` (``_flightrec.<wid>.json`` in a fleet
  worker, like every other per-worker artifact).  Triggers wired in the
  port: the retry→quarantine path (``resilience.run_guarded``, which the
  fleet worker's units run under) and a serve session quarantine
  (``serve.scheduler``); the JAX package also dumps from its SIGTERM drain
  latch, which the port's drain does not.

Signal-safety, deliberately: the ring is a ``collections.deque`` appended
WITHOUT a lock (GIL-atomic), and :func:`dump` snapshots it with ``list()``
— so the SIGTERM handler may dump while the main thread is mid-append
without self-deadlocking (the reason ``DrainController._handle`` must not
touch the tracer applies here in reverse: no shared locks at all).

Everything is fail-open and stdlib-only; a dump failure is counted
(``obs.flightrec_drops``) and swallowed.

The PyTorch port's copy of the JAX package's ``obs/flightrec.py``, with
the same file schemas, so ``tools/trace_report.py`` reads a port run.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Deque, Dict, Optional

SCHEMA_VERSION = 1

FLIGHTREC_FILENAME = "_flightrec.json"

_DEFAULT_CAPACITY = 256


def ring_capacity() -> int:
    """Ring size from ``TBX_FLIGHTREC_N`` (default 256; 0 disables)."""
    try:
        return max(0, int(os.environ.get("TBX_FLIGHTREC_N",
                                         str(_DEFAULT_CAPACITY))))
    except ValueError:
        return _DEFAULT_CAPACITY


def flightrec_filename(worker_id: Optional[str] = None) -> str:
    return (FLIGHTREC_FILENAME if worker_id is None
            else f"_flightrec.{worker_id}.json")


class FlightRecorder:
    """One process's ring + dump target.  ``capacity=0`` makes every method
    a no-op, so call sites never branch on whether recording is armed."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = ring_capacity() if capacity is None else capacity
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(1, self.capacity))
        self._path: Optional[str] = None
        self._t0 = time.monotonic()
        self.dumps = 0
        self.dropped = 0

    def configure(self, output_dir: Optional[str],
                  worker_id: Optional[str] = None) -> None:
        """Point dumps at ``<output_dir>/_flightrec[.wid].json``.  Until
        configured (or after ``configure(None)``), dumps are no-ops — the
        ring still records, so a late configure loses nothing."""
        if output_dir is None:
            self._path = None
            return
        self._path = os.path.join(output_dir, flightrec_filename(worker_id))

    @property
    def path(self) -> Optional[str]:
        return self._path

    def record(self, kind: str, **attrs: Any) -> None:
        """Append one record.  Deliberately lock-free (deque appends are
        GIL-atomic) so the signal-handler dump can never deadlock against a
        hot-path append."""
        if self.capacity <= 0:
            return
        rec = {"t": round(time.monotonic() - self._t0, 6), "kind": kind}
        if attrs:
            rec.update(attrs)
        self._ring.append(rec)

    def snapshot(self) -> list:
        return list(self._ring)

    def dump(self, reason: str, **extra: Any) -> Optional[str]:
        """Atomically write the ring (tmp+rename) to the configured path.
        Safe from signal handlers: no locks, fail-open, one tmp file keyed
        by pid.  Returns the path written, or None (unconfigured/failed)."""
        path = self._path
        if path is None or self.capacity <= 0:
            return None
        payload = {
            "v": SCHEMA_VERSION,
            "reason": reason,
            "pid": os.getpid(),
            # tbx: wallclock-ok — postmortem anchor, not duration math
            "dumped_at": time.time(),
            "capacity": self.capacity,
            "ring": self.snapshot(),
        }
        if extra:
            payload["context"] = extra
        try:
            # Burn → trace exemplars: snapshot the worst trace ids per
            # latency series so a postmortem dump links back to the exact
            # requests that were hurting when the dump fired.
            from taboo_brittleness_tpu_torch.obs import reqtrace

            exemplars = reqtrace.peek_exemplars()
            if exemplars:
                payload["exemplars"] = exemplars
        except Exception:  # noqa: BLE001 — fail-open
            pass
        try:
            import json

            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            self.dumps += 1
            return path
        except Exception:  # noqa: BLE001 — a postmortem write must not crash
            self.dropped += 1
            try:
                from taboo_brittleness_tpu_torch.obs import metrics

                metrics.counter("obs.flightrec_drops").inc()
            except Exception:  # noqa: BLE001
                pass
            return None

    def clear(self) -> None:
        self._ring.clear()


# Process-wide recorder (the one every hot path feeds).
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, **attrs: Any) -> None:
    _RECORDER.record(kind, **attrs)


def configure(output_dir: Optional[str],
              worker_id: Optional[str] = None) -> None:
    _RECORDER.configure(output_dir, worker_id)


def dump(reason: str, **extra: Any) -> Optional[str]:
    return _RECORDER.dump(reason, **extra)


def reset(capacity: Optional[int] = None) -> None:
    """Swap in a fresh recorder (tests; bench A/B arms)."""
    global _RECORDER
    _RECORDER = FlightRecorder(capacity)


__all__ = [
    "FLIGHTREC_FILENAME", "SCHEMA_VERSION", "FlightRecorder", "configure",
    "dump", "flightrec_filename", "record", "recorder", "reset",
    "ring_capacity",
]
