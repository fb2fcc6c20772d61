"""Process-wide metrics registry: counters, gauges, histograms.

The run manifest snapshots this registry at save time (``RunManifest.to_dict``
→ ``obs.metrics``), so every pipeline run carries its own decode-launch
counts, retry/quarantine totals, AOT hit rates, and word-time distributions
without any pipeline threading a registry object around.  Everything is
host-side, thread-safe, and bounded: a histogram keeps running stats plus a
fixed-size reservoir for quantiles, so a million observations cost the same
memory as a hundred.

Names are dotted lowercase (``decode.launches``, ``sweep.retries``,
``word.seconds``); the snapshot groups by type, not by name prefix.

The PyTorch port's copy of the JAX package's ``obs/metrics.py``, with
the same file schemas, so ``tools/trace_report.py`` reads a port run.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

_RESERVOIR_CAP = 512


def quantile_of(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile over a raw sample list (the shared rule every
    reservoir consumer uses, so windowed and cumulative percentiles can never
    disagree about rounding)."""
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, int(q * (len(s) - 1) + 0.5)))]


class Counter:
    """Monotonic non-negative counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """Running count/sum/min/max plus a bounded reservoir for quantiles.

    The reservoir keeps the FIRST ``_RESERVOIR_CAP`` observations and then
    overwrites deterministically (index ``n % cap``): sweeps observe at most
    a few thousand values, so this stays representative without RNG (obs code
    must not perturb seeded randomness anywhere).

    Alongside the cumulative reservoir, each observation also lands in a
    WINDOW-forked reservoir: :meth:`roll_window` (called by the timeseries
    recorder, ``obs.timeseries``) snapshots and resets it, so per-window
    p50/p99 describe only the samples of that window — the live signal an
    SLO burn rate needs, which a since-process-start reservoir arithmetically
    masks.  The last rolled window is kept so :meth:`windowed` can report
    "recent" stats (last rolled + in-progress window) between rolls."""

    __slots__ = ("name", "count", "total", "min", "max", "_sample",
                 "_w_count", "_w_total", "_w_min", "_w_max", "_w_sample",
                 "_last_window", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._sample: List[float] = []
        self._w_count = 0
        self._w_total = 0.0
        self._w_min: Optional[float] = None
        self._w_max: Optional[float] = None
        self._w_sample: List[float] = []
        self._last_window: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            if self.count < _RESERVOIR_CAP:
                self._sample.append(value)
            else:
                self._sample[self.count % _RESERVOIR_CAP] = value
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if self._w_count < _RESERVOIR_CAP:
                self._w_sample.append(value)
            else:
                self._w_sample[self._w_count % _RESERVOIR_CAP] = value
            self._w_count += 1
            self._w_total += value
            self._w_min = (value if self._w_min is None
                           else min(self._w_min, value))
            self._w_max = (value if self._w_max is None
                           else max(self._w_max, value))

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._sample:
                return None
            s = list(self._sample)
        return quantile_of(s, q)

    def roll_window(self) -> Dict[str, Any]:
        """Fork off the current window: return ``{n, sum, min, max, samples}``
        for everything observed since the last roll, reset the window
        accumulators, and remember the result as the "last rolled window".
        ``samples`` is the raw (bounded) reservoir — the timeseries recorder
        computes per-window quantiles from it and the SLO engine counts
        per-sample threshold violations; neither leaves the process."""
        with self._lock:
            win = {
                "n": self._w_count,
                "sum": self._w_total,
                "min": self._w_min,
                "max": self._w_max,
                "samples": self._w_sample,
            }
            self._w_count = 0
            self._w_total = 0.0
            self._w_min = None
            self._w_max = None
            self._w_sample = []
            self._last_window = win
        return win

    def windowed(self) -> Dict[str, Any]:
        """Stats over the RECENT samples: the last rolled window plus the
        in-progress one (so the view is never empty right after a roll).
        Before any roll this is simply "everything so far" — identical to
        cumulative, which is correct for a process younger than one window."""
        with self._lock:
            samples = list(self._w_sample)
            n = self._w_count
            w_max = self._w_max
            last = self._last_window
        if last is not None:
            samples = list(last["samples"]) + samples
            n += last["n"]
            if last["max"] is not None:
                w_max = (last["max"] if w_max is None
                         else max(w_max, last["max"]))
        return {"n": n, "max": w_max,
                "p50": quantile_of(samples, 0.50),
                "p99": quantile_of(samples, 0.99)}

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            if not self.count:
                return {"count": 0}
            mean = self.total / self.count
            s = sorted(self._sample)

        def q(frac: float) -> float:
            return s[min(len(s) - 1, max(0, int(frac * (len(s) - 1) + 0.5)))]

        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "mean": round(mean, 6),
            "min": round(self.min, 6),
            "max": round(self.max, 6),
            "p50": round(q(0.50), 6),
            "p90": round(q(0.90), 6),
        }


class MetricsRegistry:
    """Named metric instruments, created on first touch (so call sites never
    pre-register).  A name is permanently one type: asking for an existing
    name with a different type raises — that is a bug at the call site, not
    a runtime condition, so it is NOT fail-open."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"not a {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def instruments(self) -> Dict[str, Any]:
        """A point-in-time copy of the name → instrument map (the timeseries
        recorder iterates this to roll histogram windows and diff counters
        without holding the registry lock across IO)."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} with
        names sorted — the manifest-stable form."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None:
                    out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.to_dict()
        return {k: v for k, v in out.items() if v}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# Process-wide default registry (the one the manifest snapshots).
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


def reset() -> None:
    """Clear the process registry (tests; bench A/B arms)."""
    _REGISTRY.reset()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "quantile_of", "registry", "counter", "gauge", "histogram", "snapshot",
    "reset",
]
