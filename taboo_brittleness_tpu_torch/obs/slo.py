"""Declarative SLOs evaluated as multi-window burn rates.

An SLO here is "at most ``budget`` of observations may violate
``value <op> threshold``".  Each timeseries window (``obs.timeseries``)
contributes a (bad, total) pair per target; the burn rate over a span of
windows is::

    burn = (bad / total) / budget

i.e. how many times faster than sustainable the error budget is being
consumed (1.0 = exactly on budget).  Alerting is SRE-style multi-window: a
target alerts only when BOTH a fast span (default 1 window — catches the
regression quickly) and a slow span (default 6 windows — suppresses
one-window blips) burn at or above ``alert_burn``.  The published
``slo.burn.<name>`` gauge is ``min(fast, slow)`` — the admission signal the
replica router will consume (ROADMAP: "a router that admits by per-replica
SLO burn"): it rises only when a regression is both current and sustained.

Three target sources cover the repo's signals:

- ``histogram`` — per-sample violation counting over the window's forked
  reservoir (``serve.latency.<scenario>`` ≤ threshold; a ``*`` in the
  metric name fans one target out per matching histogram).
- ``ratio`` — a per-window counter-delta quotient held to a floor/ceiling
  (speculation ``accept_rate`` = accepted/drafted ≥ threshold; serve
  goodput = completed/admitted).
- ``gauge`` — an instantaneous value held to a bound (HBM headroom
  fraction ≥ threshold, ``obs.memory``).

The PyTorch port's copy of the JAX package's ``obs/slo.py``: the same
targets, windows and burn arithmetic, so the two packages' heartbeats carry
the same ``slo`` block for the same metric windows.

Evaluation is in-process at window-roll time (raw reservoir samples never
leave the process); outputs are ``slo.burn.*`` gauges (which then ride the
next window of the spool), one ``obs.warn`` alert per sustained episode,
and the ``slo`` block the serve heartbeat carries.  Everything is
fail-open, stdlib-only, host-side.
"""

from __future__ import annotations

import collections
import dataclasses
import fnmatch
import json
import os
from typing import Any, Deque, Dict, List, Optional, Tuple

from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics

_SOURCES = ("histogram", "gauge", "ratio")
_OPS = ("le", "ge")

#: Floor for the error budget so a zero-budget target ("never violate")
#: yields a large finite burn instead of a division by zero.
_MIN_BUDGET = 1e-6


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One declarative objective.  ``metric`` may contain ``*`` (fnmatch)
    for histogram/gauge sources — the target fans out per matching
    instrument, suffixing the series name with the matched tail."""

    name: str
    source: str                 # histogram | gauge | ratio
    metric: str                 # instrument name/pattern (ratio: numerator)
    threshold: float
    op: str = "le"              # good when  value <op> threshold
    budget: float = 0.01        # tolerated bad fraction
    metric_b: str = ""          # ratio denominator counter
    fast_windows: int = 1
    slow_windows: int = 6
    alert_burn: float = 1.0

    def __post_init__(self):
        if self.source not in _SOURCES:
            raise ValueError(f"SLO {self.name!r}: unknown source "
                             f"{self.source!r} (one of {_SOURCES})")
        if self.op not in _OPS:
            raise ValueError(f"SLO {self.name!r}: unknown op {self.op!r}")
        if self.source == "ratio" and not self.metric_b:
            raise ValueError(f"SLO {self.name!r}: ratio needs metric_b")

    def good(self, value: float) -> bool:
        return (value <= self.threshold if self.op == "le"
                else value >= self.threshold)


def default_targets() -> List[SloTarget]:
    """The shipped objectives (overridable wholesale via ``TBX_SLO`` —
    inline JSON or a path to a JSON file with a list of target dicts)."""
    spec = os.environ.get("TBX_SLO")
    if spec:
        return load_targets(spec)
    try:
        latency_s = max(0.001, float(os.environ.get("TBX_SLO_LATENCY_S",
                                                    "2.5")))
    except ValueError:
        latency_s = 2.5
    try:
        ttft_s = max(0.001, float(os.environ.get("TBX_SLO_TTFT_S", "1.0")))
    except ValueError:
        ttft_s = 1.0
    return [
        # Per-scenario end-to-end serve latency: ≤ latency_s for all but 5%.
        SloTarget(name="serve_latency", source="histogram",
                  metric="serve.latency.*", threshold=latency_s,
                  op="le", budget=0.05),
        # Per-scenario time-to-first-token (submit → first emitted token,
        # re-timed on the surviving attempt after a re-spool): ≤ ttft_s for
        # all but 5% — the interactivity half of the latency story.
        SloTarget(name="serve_ttft", source="histogram",
                  metric="serve.ttft.*", threshold=ttft_s,
                  op="le", budget=0.05),
        # Goodput: ≥ 99% of admitted requests complete (per window).
        SloTarget(name="serve_goodput", source="ratio",
                  metric="serve.completed", metric_b="serve.admitted",
                  threshold=0.99, op="ge", budget=0.01),
        # Speculation health: accept_rate ≥ 0.2 — below it the (k, G)
        # calibration is stale and verify launches are mostly waste.
        SloTarget(name="spec_accept", source="ratio",
                  metric="serve.spec.accepted", metric_b="serve.spec.drafted",
                  threshold=0.2, op="ge", budget=0.05),
        # Fleet re-issue latency: a dropped unit back under lease ≤ 60 s.
        SloTarget(name="fleet_recovery", source="histogram",
                  metric="fleet.recovery_seconds", threshold=60.0,
                  op="le", budget=0.01),
        # HBM headroom: ≥ 5% of the device limit stays free.
        SloTarget(name="hbm_headroom", source="gauge",
                  metric="mem.hbm.headroom_frac", threshold=0.05,
                  op="ge", budget=0.01),
    ]


def load_targets(spec: str) -> List[SloTarget]:
    """Parse targets from inline JSON or a JSON file (a list of dicts with
    :class:`SloTarget`'s field names).  A malformed spec raises — a typo'd
    SLO config must fail loudly at startup, not silently guard nothing."""
    text = spec
    if not spec.lstrip().startswith("["):
        with open(spec) as f:
            text = f.read()
    raw = json.loads(text)
    if not isinstance(raw, list):
        raise ValueError("TBX_SLO must be a JSON list of target objects")
    return [SloTarget(**item) for item in raw]


def _series_key(target: SloTarget, metric_name: str) -> str:
    """`serve_latency` + pattern `serve.latency.*` matching
    `serve.latency.chat` → `serve_latency.chat` (the literal prefix/suffix
    around the ``*`` is stripped; an exact metric keeps the bare name)."""
    if "*" not in target.metric:
        return target.name
    head, _, tail = target.metric.partition("*")
    core = metric_name
    if head and core.startswith(head):
        core = core[len(head):]
    if tail and core.endswith(tail):
        core = core[:-len(tail)]
    return f"{target.name}.{core}" if core else target.name


class SloEngine:
    """Per-target sliding windows of (bad, total) pairs + burn/alert state.
    One engine per process surface (the serve loop, the sweep observer);
    feed it from ``TimeseriesRecorder(slo_engine=...)``."""

    def __init__(self, targets: Optional[List[SloTarget]] = None, *,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 emit_alerts: bool = True):
        self.targets = default_targets() if targets is None else list(targets)
        self.registry = registry or obs_metrics.registry()
        self.emit_alerts = emit_alerts
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}
        self._alerting: Dict[str, bool] = {}
        self._last_block: Dict[str, Dict[str, Any]] = {}

    # -- per-window observation --------------------------------------------

    def _observations(self, target: SloTarget, hists, counter_deltas,
                      gauges) -> List[Tuple[str, float, float, str]]:
        """(series key, bad, total, metric name) contributions of one
        window.  A series with nothing to say this window contributes
        (0, 0) implicitly by not appearing — idle windows age old badness
        out of the spans."""
        out: List[Tuple[str, float, float, str]] = []
        if target.source == "histogram":
            for name, win in hists.items():
                if not fnmatch.fnmatchcase(name, target.metric):
                    continue
                samples = win.get("samples") or []
                if not samples:
                    continue
                bad = sum(1 for v in samples if not target.good(v))
                out.append((_series_key(target, name), float(bad),
                            float(len(samples)), name))
        elif target.source == "gauge":
            for name, value in gauges.items():
                if not fnmatch.fnmatchcase(name, target.metric):
                    continue
                out.append((_series_key(target, name),
                            0.0 if target.good(value) else 1.0, 1.0, name))
        elif target.source == "ratio":
            den = counter_deltas.get(target.metric_b, 0.0)
            if den > 0:
                num = counter_deltas.get(target.metric, 0.0)
                out.append((target.name,
                            0.0 if target.good(num / den) else 1.0, 1.0,
                            target.metric))
        return out

    def observe_window(self, *, dur: float, hists: Dict[str, Any],
                       counter_deltas: Dict[str, float],
                       gauges: Dict[str, float]) -> Dict[str, Dict[str, Any]]:
        """Fold one rolled window into every target's spans; set the
        ``slo.burn.<series>`` gauges; emit at most one ``obs.warn`` per
        newly-sustained alert episode.  Returns the heartbeat block
        ``{series: {burn, fast, slow, ok}}``."""
        contributions: Dict[str, Tuple[SloTarget, float, float, str]] = {}
        for target in self.targets:
            for key, bad, total, metric in self._observations(
                    target, hists, counter_deltas, gauges):
                contributions[key] = (target, bad, total, metric)
        block: Dict[str, Dict[str, Any]] = {}
        # Every KNOWN series advances each window — absent = (0, 0) — so a
        # regression that stops the traffic entirely still ages out.
        keys = set(self._series) | set(contributions)
        for key in sorted(keys):
            target, bad, total, metric = contributions.get(
                key, (None, 0.0, 0.0, ""))
            series = self._series.get(key)
            if series is None:
                if target is None:
                    continue
                series = self._series[key] = collections.deque(
                    maxlen=max(1, target.slow_windows))
            series.append((bad, total))
            target = target or self._target_for(key)
            if target is None:
                continue
            fast = self._burn(series, target, target.fast_windows)
            slow = self._burn(series, target, target.slow_windows)
            burn = round(min(fast, slow), 4)
            ok = burn < target.alert_burn
            block[key] = {"burn": burn, "fast": round(fast, 4),
                          "slow": round(slow, 4), "ok": ok}
            if metric and target.source == "histogram":
                # Burn → trace exemplars: the window's worst trace ids for
                # this series ride the heartbeat block, so an operator can
                # jump straight from a burning row to ``tbx trace``.
                try:
                    from taboo_brittleness_tpu_torch.obs import reqtrace
                    exemplars = reqtrace.take_exemplars(metric)
                    if exemplars:
                        block[key]["exemplars"] = exemplars
                except Exception:  # noqa: BLE001 — fail-open
                    pass
            try:
                self.registry.gauge(f"slo.burn.{key}").set(burn)
            except Exception:  # noqa: BLE001 — fail-open
                pass
            self._maybe_alert(key, target, burn, ok)
        self._last_block = block
        return block

    def _target_for(self, key: str) -> Optional[SloTarget]:
        for target in self.targets:
            if key == target.name or key.startswith(target.name + "."):
                return target
        return None

    @staticmethod
    def _burn(series, target: SloTarget, span: int) -> float:
        recent = list(series)[-max(1, span):]
        total = sum(t for _, t in recent)
        if total <= 0:
            return 0.0
        frac = sum(b for b, _ in recent) / total
        return frac / max(target.budget, _MIN_BUDGET)

    def _maybe_alert(self, key: str, target: SloTarget, burn: float,
                     ok: bool) -> None:
        was = self._alerting.get(key, False)
        self._alerting[key] = not ok
        if ok or was or not self.emit_alerts:
            return
        try:
            from taboo_brittleness_tpu_torch import obs

            obs.warn(
                f"[slo] {key}: burn {burn:.2f}x over budget "
                f"(target {target.metric} {target.op} {target.threshold}, "
                f"budget {target.budget:.2%})",
                name="slo.alert", slo=key, burn=burn,
                threshold=target.threshold, budget=target.budget)
        except Exception:  # noqa: BLE001 — alerting must not kill the roll
            pass

    def last_block(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._last_block)


__all__ = [
    "SloEngine", "SloTarget", "default_targets", "load_targets",
]
