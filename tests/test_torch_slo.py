"""The port's SLO burn engine (``obs/slo.py``) against the JAX package's.

The same metric windows go through both ``SloEngine`` s (each with its own
registry): the burn blocks and the ``slo.burn.*`` gauges must be equal
(exactly: the arithmetic is the same stdlib float code), and so must the
alert latches (the ``obs.warn`` calls each engine makes).  Ratio,
histogram and gauge targets, the default targets and loading targets from
``TBX_SLO``; then the port's recorder feeding its engine, and the burn
block on the serve heartbeat.
"""

import json
import os
import sys

import pytest

from taboo_brittleness_tpu.obs import metrics as jmetrics
from taboo_brittleness_tpu.obs import slo as jslo
from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import slo, timeseries
from taboo_brittleness_tpu_torch.obs.progress import ProgressReporter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import trace_report  # noqa: E402


def _pair(targets, *, emit_alerts=False):
    """(JAX engine, port engine, JAX registry, port registry) over the same
    target dicts."""
    jreg, reg = jmetrics.MetricsRegistry(), obs_metrics.MetricsRegistry()
    return (jslo.SloEngine([jslo.SloTarget(**t) for t in targets],
                           registry=jreg, emit_alerts=emit_alerts),
            slo.SloEngine([slo.SloTarget(**t) for t in targets],
                          registry=reg, emit_alerts=emit_alerts),
            jreg, reg)


def _feed_both(pair, windows):
    """Feed each window to both engines; every block, and the burn gauges
    after it, must be equal.  Returns the port's blocks."""
    jeng, eng, jreg, reg = pair
    blocks = []
    for win in windows:
        want = jeng.observe_window(dur=10.0, **win)
        got = eng.observe_window(dur=10.0, **win)
        assert got == want
        burn = {k: v for k, v in reg.snapshot().get("gauges", {}).items()
                if k.startswith("slo.burn.")}
        assert burn == {k: v for k, v in jreg.snapshot().get(
            "gauges", {}).items() if k.startswith("slo.burn.")}
        blocks.append(got)
    assert eng.last_block() == jeng.last_block()
    return blocks


GOODPUT = dict(name="serve_goodput", source="ratio", metric="serve.completed",
               metric_b="serve.admitted", threshold=0.99, op="ge",
               budget=0.01, fast_windows=1, slow_windows=6)


def _ratio(admitted, completed):
    return dict(hists={}, gauges={},
                counter_deltas={"serve.admitted": admitted,
                                "serve.completed": completed})


def test_ratio_burn_rises_then_decays_alike():
    windows = [_ratio(100.0, 90.0)] + [_ratio(50.0, 50.0)] * 6
    blocks = _feed_both(_pair([GOODPUT]), windows)
    assert blocks[0]["serve_goodput"]["burn"] == pytest.approx(100.0)
    assert not blocks[0]["serve_goodput"]["ok"]
    assert blocks[1]["serve_goodput"]["fast"] == 0.0
    assert blocks[-1]["serve_goodput"] == {"burn": 0.0, "fast": 0.0,
                                           "slow": 0.0, "ok": True}


def test_histogram_target_fans_out_per_metric_alike():
    target = dict(name="serve_latency", source="histogram",
                  metric="serve.latency.*", threshold=1.0, op="le",
                  budget=0.05)
    chat = {"n": 10, "sum": 8.0, "min": 0.5, "max": 2.0,
            "samples": [0.5] * 8 + [2.0] * 2, "cum_n": 10}
    lens = {"n": 4, "sum": 2.0, "min": 0.5, "max": 0.5,
            "samples": [0.5] * 4, "cum_n": 4}
    windows = [dict(hists={"serve.latency.chat": chat,
                           "serve.latency.chat_lens": lens,
                           "serve.ttft.chat": chat},
                    counter_deltas={}, gauges={}),
               dict(hists={}, counter_deltas={}, gauges={})]
    blocks = _feed_both(_pair([target]), windows)
    assert blocks[0]["serve_latency.chat"]["burn"] == pytest.approx(4.0)
    assert blocks[0]["serve_latency.chat_lens"]["burn"] == 0.0
    assert "serve_ttft.chat" not in blocks[0]


def test_gauge_target_and_idle_windows_alike():
    target = dict(name="hbm_headroom", source="gauge",
                  metric="mem.hbm.headroom_frac", threshold=0.05, op="ge",
                  budget=0.01, slow_windows=3)
    windows = ([dict(hists={}, counter_deltas={},
                     gauges={"mem.hbm.headroom_frac": 0.01})]
               + [dict(hists={}, counter_deltas={}, gauges={})] * 3)
    blocks = _feed_both(_pair([target]), windows)
    assert blocks[0]["hbm_headroom"]["burn"] == pytest.approx(100.0)
    assert blocks[-1]["hbm_headroom"]["ok"]


def test_default_targets_on_mixed_windows_alike(monkeypatch):
    """The shipped targets over windows that exercise all three sources
    and the speculation ratio."""
    monkeypatch.delenv("TBX_SLO", raising=False)
    assert ([t.__dict__ for t in slo.default_targets()]
            == [t.__dict__ for t in jslo.default_targets()])
    jreg, reg = jmetrics.MetricsRegistry(), obs_metrics.MetricsRegistry()
    pair = (jslo.SloEngine(registry=jreg, emit_alerts=False),
            slo.SloEngine(registry=reg, emit_alerts=False), jreg, reg)
    slow = {"n": 3, "sum": 9.0, "min": 3.0, "max": 3.0,
            "samples": [3.0, 3.0, 0.1], "cum_n": 3}
    windows = [
        dict(hists={"serve.latency.chat": slow, "serve.ttft.chat": slow},
             counter_deltas={"serve.admitted": 8.0, "serve.completed": 8.0,
                             "serve.spec.drafted": 30.0,
                             "serve.spec.accepted": 3.0},
             gauges={"mem.hbm.headroom_frac": 0.5}),
        dict(hists={}, counter_deltas={"serve.spec.drafted": 10.0,
                                       "serve.spec.accepted": 9.0},
             gauges={"mem.hbm.headroom_frac": 0.02}),
    ]
    blocks = _feed_both(pair, windows)
    assert not blocks[0]["spec_accept"]["ok"]
    assert blocks[1]["spec_accept"]["fast"] == 0.0
    assert not blocks[1]["hbm_headroom"]["ok"]


def test_alert_latches_once_per_episode_alike(monkeypatch):
    import taboo_brittleness_tpu.obs as jobs_pkg

    jcalls, calls = [], []
    monkeypatch.setattr(jobs_pkg, "warn",
                        lambda msg, **kw: jcalls.append((msg, kw)))
    monkeypatch.setattr(obs, "warn", lambda msg, **kw: calls.append((msg, kw)))
    pair = _pair([dict(GOODPUT, slow_windows=1)], emit_alerts=True)
    bad, good = _ratio(10.0, 5.0), _ratio(10.0, 10.0)
    _feed_both(pair, [bad, bad, bad])
    assert len(calls) == len(jcalls) == 1
    assert calls[0][1]["name"] == "slo.alert"
    _feed_both(pair, [good, bad])
    assert len(calls) == len(jcalls) == 2      # recovery re-arms the latch
    assert calls == jcalls


def test_load_targets_from_env(monkeypatch, tmp_path):
    spec = [{"name": "x", "source": "gauge", "metric": "g",
             "threshold": 1.0, "op": "ge"}]
    monkeypatch.setenv("TBX_SLO", json.dumps(spec))
    assert [t.name for t in slo.default_targets()] == ["x"]
    p = tmp_path / "slo.json"
    p.write_text(json.dumps(spec))
    monkeypatch.setenv("TBX_SLO", str(p))
    assert ([t.__dict__ for t in slo.default_targets()]
            == [t.__dict__ for t in jslo.default_targets()])
    with pytest.raises((ValueError, TypeError)):
        slo.load_targets(json.dumps([{"name": "bad", "source": "nope",
                                      "metric": "m", "threshold": 1.0}]))
    with pytest.raises(ValueError, match="ratio needs metric_b"):
        slo.SloTarget(name="r", source="ratio", metric="a", threshold=1.0)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_recorder_feeds_engine_and_spools_burn(tmp_path):
    """The port's recorder rolls a seeded latency regression into a window
    whose burn block is nonzero; the burn gauge rides the next window, and
    the spool passes ``trace_report``'s metrics check."""
    reg = obs_metrics.MetricsRegistry()
    eng = slo.SloEngine([slo.SloTarget(
        name="serve_latency", source="histogram", metric="serve.latency.*",
        threshold=0.5, op="le", budget=0.05)], registry=reg,
        emit_alerts=False)
    clock = FakeClock()
    seen = []
    path = str(tmp_path / "_metrics.jsonl")
    rec = timeseries.TimeseriesRecorder(
        path, registry=reg, window_s=1.0, slo_engine=eng,
        on_window=seen.append, sample_memory=False, clock=clock)
    for _ in range(10):
        reg.histogram("serve.latency.chat").observe(5.0)
    clock.advance(1.0)
    rec.roll()
    clock.advance(1.0)
    rec.roll()
    rec.stop()
    assert seen[0]["slo"]["serve_latency.chat"]["burn"] == pytest.approx(20.0)
    assert rec.last_slo() is not None
    assert seen[1]["gauges"]["slo.burn.serve_latency.chat"] == pytest.approx(
        20.0)
    assert trace_report._check_metrics_file(path) == []


def test_burn_block_rides_the_serving_heartbeat(tmp_path):
    rep = ProgressReporter(str(tmp_path / "_progress.json"), total_words=0)
    eng = slo.SloEngine([slo.SloTarget(**GOODPUT)],
                        registry=obs_metrics.MetricsRegistry(),
                        emit_alerts=False)
    eng.observe_window(dur=10.0, **_ratio(10.0, 5.0))
    rep.serving_update(in_flight=1, completed=5, slo=eng.last_block())
    snap = rep.snapshot()
    assert snap["workload"] == "serve"
    assert snap["slo"]["serve_goodput"]["burn"] == pytest.approx(100.0)
    assert snap["slo"]["serve_goodput"]["ok"] is False
