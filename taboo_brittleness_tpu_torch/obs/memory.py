"""Device live/peak watermarks + host RSS, sampled without touching the step.

The 1.16 GB-per-prompt ``all_probs`` hazard is invisible at run time unless
someone watches device memory: a launch that fits on word 3 can run out of
memory on word 17 when a leaked buffer or an unexpectedly retained prefill
cache shifts the baseline.  This module makes the watermark a recorded
signal:

- :func:`sample` reads each visible CUDA card through
  ``torch.cuda.memory_stats`` (bytes the caching allocator holds for
  tensors now and at its peak) and ``torch.cuda.mem_get_info`` (the card's
  total, the limit), plus the host's RSS from ``/proc/self``, entirely
  host-side and fail-open.  Span boundaries attach this (``trace.Tracer``),
  so every word/phase end carries the watermark it left behind.

``peak_bytes_in_use`` is the allocator's peak since the process started (or
since ``torch.cuda.reset_peak_memory_stats``); deltas between consecutive
samples, not absolute peaks, localize a regression.

- :class:`MemorySampler` is the optional low-rate background thread for
  the gaps between boundaries (a leak inside one long phase), off by
  default and armed with ``TBX_OBS_MEM_HZ`` (samples/second, fractional
  fine); every sweep observer (a fleet worker's too) starts one.

The PyTorch port's counterpart of the JAX package's ``obs/memory.py``: the
same fields and ``mem.*`` gauges, read from ``torch.cuda`` instead of
``jax.local_devices()``.  A process without CUDA samples the host only.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, List, Optional

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def host_rss_bytes() -> Optional[int]:
    """Current resident set size from /proc/self/statm (Linux); None where
    procfs is unavailable (the sample just omits the field)."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return None


def _cuda():
    """``torch`` when a CUDA card is visible and initialised, else None.  A
    sample never imports torch or initialises CUDA on its own: a process
    that has not imported torch holds no card state, and the import (a
    second or more, most of it under the GIL) would stall the heartbeat
    thread beside the sample, which a supervisor then reads as a wedged
    process (a fleet worker's first span)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch
    except Exception:  # noqa: BLE001 — no CUDA: host-only sample
        pass
    return None


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card memory stats from ``torch.cuda``; [] on a process without
    an initialised CUDA card."""
    torch = _cuda()
    if torch is None:
        return []
    out = []
    try:
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
                _free, total = torch.cuda.mem_get_info(i)
            except Exception:  # noqa: BLE001 — per-device introspection varies
                continue
            out.append({
                "device": str(i),
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": int(total),
            })
    except Exception:  # noqa: BLE001
        return []
    return out


def live_array_bytes() -> Optional[int]:
    """Bytes of live tensors on the card (``torch.cuda.memory_allocated``,
    summed over the cards); None without an initialised CUDA card.  The
    counterpart of the JAX package's live-array sum, which its autotuner
    reads where a backend publishes no stats."""
    torch = _cuda()
    if torch is None:
        return None
    try:
        return sum(int(torch.cuda.memory_allocated(i))
                   for i in range(torch.cuda.device_count()))
    except Exception:  # noqa: BLE001
        return None


def _publish_gauges(rss: Optional[int],
                    devices: List[Dict[str, Any]]) -> None:
    """Mirror the watermarks into the metrics registry (``mem.hbm.*``, host
    RSS) so they ride the timeseries spool (``obs.timeseries``) — the live
    input the serving autotuner (``serve.autotune``) reads.  Fail-open;
    totals across cards."""
    try:
        from taboo_brittleness_tpu_torch.obs import metrics

        if rss is not None:
            metrics.gauge("mem.host.rss_bytes").set(rss)
        if devices:
            live = sum(d["bytes_in_use"] or 0 for d in devices)
            peak = sum(d["peak_bytes_in_use"] or 0 for d in devices)
            limit = sum(d["bytes_limit"] or 0 for d in devices)
            metrics.gauge("mem.hbm.live_bytes").set(live)
            if peak:
                metrics.gauge("mem.hbm.peak_bytes").set(peak)
            if limit:
                metrics.gauge("mem.hbm.limit_bytes").set(limit)
                metrics.gauge("mem.hbm.headroom_frac").set(
                    round(max(0.0, 1.0 - live / limit), 4))
    except Exception:  # noqa: BLE001 — publication is best-effort
        pass


def sample(*, compact: bool = False) -> Dict[str, Any]:
    """One watermark sample.  ``compact=True`` is the span-boundary form:
    megabytes, short keys, device list collapsed to totals — small enough to
    ride on every word/phase end event.  Every sample also refreshes the
    ``mem.*`` registry gauges (:func:`_publish_gauges`)."""
    rss = host_rss_bytes()
    devices = device_memory_stats()
    _publish_gauges(rss, devices)
    if not compact:
        out: Dict[str, Any] = {"rss_bytes": rss, "devices": devices}
        return out
    out = {}
    if rss is not None:
        out["rss_mb"] = round(rss / 1e6, 1)
    if devices:
        live = sum(d["bytes_in_use"] or 0 for d in devices)
        peak = sum(d["peak_bytes_in_use"] or 0 for d in devices)
        out["hbm_live_mb"] = round(live / 1e6, 1)
        if peak:
            out["hbm_peak_mb"] = round(peak / 1e6, 1)
    return out


def sampler_hz() -> float:
    """Background-sampler rate from ``TBX_OBS_MEM_HZ``; 0 (default) = off."""
    try:
        return max(0.0, float(os.environ.get("TBX_OBS_MEM_HZ", "0")))
    except ValueError:
        return 0.0


class MemorySampler:
    """Optional background watermark sampler: emits ``mem.sample`` point
    events through ``tracer`` at ``hz`` samples/second until stopped.
    Daemonized and fail-open; ``hz <= 0`` never starts a thread."""

    def __init__(self, tracer, hz: Optional[float] = None):
        self.tracer = tracer
        self.hz = sampler_hz() if hz is None else hz
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MemorySampler":
        if self.hz <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="tbx-obs-mem", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.tracer.event("mem.sample", **sample(compact=True))
            except Exception:  # noqa: BLE001 — sampling never crashes a run
                pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "MemorySampler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
