"""The port's copy of the telemetry subsystem (``taboo_brittleness_tpu_torch/obs``)
held to the JAX package's obs contracts (``tests/test_obs.py``,
``tests/test_live_telemetry.py``, ``tests/test_reqtrace.py``), on the CPU.

Covers: span nesting and thread-safety, JSONL round-trip plus fail-open
behaviour under a fault-injected sink write (resilience site
``obs.event_write``), metrics registry snapshots, the ``_progress.json``
heartbeat and staleness detection, ``tools/trace_report.py`` rendered over
and checking a synthetic sweep's events, the windowed metrics spool
(conservation, resume, the ``obs.metrics_write`` fault site), the flight
recorder, the request-trace context and exemplars, and the memory sample
read from ``torch.cuda`` (host-only without a card).  The JAX package's
manifest test is not ported: the port has no run manifest yet.
"""

import json
import os
import sys
import threading
import time

import pytest

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import memory as obs_memory
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import progress as obs_progress
from taboo_brittleness_tpu_torch.obs import trace as obs_trace
from taboo_brittleness_tpu_torch.runtime import resilience
from taboo_brittleness_tpu_torch.runtime.resilience import FaultInjector

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import trace_report  # noqa: E402

FIXTURE_EVENTS = os.path.join(
    os.path.dirname(__file__), "fixtures", "obs", "_events.jsonl")


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Each test gets a pristine injector, metrics registry, and tracer
    stack (obs state is process-wide by design)."""
    resilience.set_injector(FaultInjector())
    obs_metrics.reset()
    yield
    while obs_trace.get_tracer() is not None:
        obs_trace.deactivate(obs_trace.get_tracer())
    resilience.set_injector(FaultInjector())
    obs_metrics.reset()


def _read_events(path):
    return list(obs.iter_events(path))


# ---------------------------------------------------------------------------
# Spans: nesting, attributes, thread-safety.
# ---------------------------------------------------------------------------

def test_span_nesting_and_round_trip(tmp_path):
    path = str(tmp_path / "_events.jsonl")
    t = obs.activate(path, run_id="run0")
    try:
        with t.span("sweep", kind="run", pipeline="test") as run:
            with t.span("word", kind="word", word="ship") as w:
                with t.span("decode", kind="program", rows=4) as p:
                    p.set(aot="hit")
                t.event("aot.build", entry="decode")
            assert w.parent_id == run.span_id
    finally:
        obs.deactivate(t)

    events = _read_events(path)
    starts = [e for e in events if e["ev"] == "start"]
    ends = [e for e in events if e["ev"] == "end"]
    points = [e for e in events if e["ev"] == "point"]
    assert [e["name"] for e in starts] == ["sweep", "word", "decode"]
    # Ends are innermost-first; each end carries dur + ok status.
    assert [e["name"] for e in ends] == ["decode", "word", "sweep"]
    assert all(e["status"] == "ok" and e["dur"] >= 0 for e in ends)
    # Parentage chains run -> word -> program; the point event parents to
    # the word span active on its thread.
    by_name = {e["name"]: e for e in starts}
    assert by_name["word"]["parent"] == by_name["sweep"]["id"]
    assert by_name["decode"]["parent"] == by_name["word"]["id"]
    assert points[0]["parent"] == by_name["word"]["id"]
    # Late attributes ride the end event; seq is strictly increasing.
    decode_end = next(e for e in ends if e["name"] == "decode")
    assert decode_end["attrs"]["aot"] == "hit"
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    # The run start carries the wall-clock anchor and run id.
    assert by_name["sweep"]["run_id"] == "run0"
    assert by_name["sweep"]["wall"] > 0


def test_span_error_status_and_idempotent_end(tmp_path):
    path = str(tmp_path / "_events.jsonl")
    t = obs.activate(path)
    try:
        with pytest.raises(ValueError):
            with t.span("word", kind="word", word="moon"):
                raise ValueError("boom")
        sp = t.span("explicit", kind="phase")
        sp.end()
        sp.end()  # idempotent: __exit__ after end() must not double-emit
    finally:
        obs.deactivate(t)
    events = _read_events(path)
    word_end = next(e for e in events
                    if e["ev"] == "end" and e["name"] == "word")
    assert word_end["status"] == "error"
    assert "ValueError: boom" in word_end["error"]
    assert sum(1 for e in events
               if e["ev"] == "end" and e["name"] == "explicit") == 1


def test_tracer_thread_safety(tmp_path):
    """Concurrent writers from many threads: every event lands as one whole
    JSON line, seq is gap-free, and per-thread parentage never crosses
    threads (a worker's span must not nest under another thread's)."""
    path = str(tmp_path / "_events.jsonl")
    t = obs.activate(path)
    n_threads, n_spans = 8, 25

    def worker(k):
        for i in range(n_spans):
            with t.span(f"w{k}", kind="phase", i=i) as sp:
                sp.event("tick", k=k)

    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        obs.deactivate(t)

    events = _read_events(path)
    # start+end+point per span iteration; nothing torn, nothing dropped.
    assert len(events) == n_threads * n_spans * 3
    assert t.dropped == 0
    seqs = sorted(e["seq"] for e in events)
    assert seqs == list(range(1, len(events) + 1))
    starts = {e["id"]: e for e in events if e["ev"] == "start"}
    for e in events:
        if e["ev"] == "start" and e.get("parent") is not None:
            # Parent (if any) must be a span of the same worker thread.
            assert starts[e["parent"]]["name"] == e["name"]


def test_module_level_api_is_noop_without_tracer(tmp_path):
    assert obs.get_tracer() is None
    sp = obs.span("anything")
    assert sp is obs.NULL_SPAN
    with sp:
        sp.set(x=1).event("nested")
    obs.event("orphan")  # must not raise
    assert obs.last_seq() is None


# ---------------------------------------------------------------------------
# Sink: atomicity/fail-open under fault injection, buffered flush, torn tail.
# ---------------------------------------------------------------------------

def test_event_write_fault_is_fail_open(tmp_path):
    """An injected fault at obs.event_write drops events, counts them, and
    never raises into the instrumented code path."""
    inj = FaultInjector()
    inj.arm("obs.event_write", times=2, kind="permanent")
    resilience.set_injector(inj)

    path = str(tmp_path / "_events.jsonl")
    t = obs.activate(path)
    try:
        for i in range(4):
            t.event(f"e{i}")  # first two hit the fault; never raises
    finally:
        obs.deactivate(t)

    events = _read_events(path)
    assert [e["name"] for e in events] == ["e2", "e3"]
    assert t.dropped == 2
    assert obs_metrics.counter("obs.events_dropped").value == 2


def test_sink_open_failure_keeps_span_timing(tmp_path):
    """An unwritable sink path degrades to a sink-less tracer: spans still
    time and nest, nothing raises."""
    bad = str(tmp_path / "not_a_dir_file")
    with open(bad, "w") as f:
        f.write("x")
    t = obs.activate(os.path.join(bad, "_events.jsonl"))
    try:
        with t.span("word", kind="word", word="ship") as sp:
            assert sp.span_id == 1
        assert t.last_seq() == 2  # start + end, counted despite no sink
    finally:
        obs.deactivate(t)


def test_buffered_events_flush_on_close_and_flush(tmp_path):
    path = str(tmp_path / "_events.jsonl")
    t = obs.activate(path)
    try:
        t.event("buffered")
        # Small event volume stays in the buffer until an explicit flush.
        assert os.path.getsize(path) == 0 if os.path.exists(path) else True
        t.flush()
        assert [e["name"] for e in _read_events(path)] == ["buffered"]
        t.event("second")
    finally:
        obs.deactivate(t)  # close() flushes the tail
    assert [e["name"] for e in _read_events(path)] == ["buffered", "second"]


def test_iter_events_skips_torn_tail_strict_raises(tmp_path):
    path = str(tmp_path / "_events.jsonl")
    lines = [json.dumps({"v": 1, "seq": 1, "t": 0.0, "ev": "point",
                         "name": "ok"})]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write('{"v": 1, "seq": 2, "t": 0.01, "ev": "po')  # killed mid-write
    assert [e["name"] for e in obs.iter_events(path)] == ["ok"]
    with pytest.raises(ValueError, match="unparseable"):
        list(obs.iter_events(path, strict=True))


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------

def test_metrics_snapshot_shapes():
    obs_metrics.counter("decode.launches").inc()
    obs_metrics.counter("decode.launches").inc(2)
    obs_metrics.gauge("aot.decode.hits").set(7)
    h = obs_metrics.histogram("word.seconds")
    for v in (1.0, 2.0, 3.0, 10.0):
        h.observe(v)

    snap = obs_metrics.snapshot()
    assert snap["counters"]["decode.launches"] == 3
    assert snap["gauges"]["aot.decode.hits"] == 7
    hist = snap["histograms"]["word.seconds"]
    assert hist["count"] == 4 and hist["sum"] == 16.0
    assert hist["min"] == 1.0 and hist["max"] == 10.0
    assert hist["p50"] in (2.0, 3.0)
    # JSON-serializable by construction (the manifest embeds it verbatim).
    json.dumps(snap)


def test_metrics_type_collision_raises_and_reset():
    obs_metrics.counter("x")
    with pytest.raises(TypeError):
        obs_metrics.gauge("x")
    obs_metrics.reset()
    obs_metrics.gauge("x")  # fine after reset


def test_histogram_reservoir_bounded_and_concurrent():
    h = obs_metrics.histogram("h")
    n = obs_metrics._RESERVOIR_CAP * 3

    def worker(base):
        for i in range(n // 4):
            h.observe(float(base + i))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert h.count == n
    assert len(h._sample) == obs_metrics._RESERVOIR_CAP
    assert h.quantile(0.5) is not None


# ---------------------------------------------------------------------------
# Progress heartbeat + staleness.
# ---------------------------------------------------------------------------

def test_progress_reporter_lifecycle(tmp_path):
    path = str(tmp_path / "_progress.json")
    clock = {"t": 100.0}
    rep = obs_progress.ProgressReporter(
        path, total_words=4, run_id="r1", interval=3600,
        min_write_interval=0.0, clock=lambda: clock["t"])
    rep.write_now()

    rep.word_started("ship")
    rep.phase("decode")
    snap = rep.snapshot()
    assert snap["current_word"] == "ship" and snap["phase"] == "decode"
    assert snap["eta_seconds"] is None  # no completed word yet

    clock["t"] += 10.0
    rep.word_done("ship")
    rep.word_skipped("moon")     # resumed: counts done, not toward the EMA
    rep.word_quarantined("lake")
    snap = rep.snapshot()
    assert snap["words_done"] == 2
    assert snap["words_quarantined"] == 1
    assert snap["word_seconds_ema"] == 10.0
    assert snap["eta_seconds"] == 10.0   # 1 remaining x 10 s EMA

    rep.finish("done")
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["status"] == "done" and on_disk["current_word"] is None


def test_progress_heartbeat_thread_rewrites_file(tmp_path):
    path = str(tmp_path / "_progress.json")
    rep = obs_progress.ProgressReporter(
        path, total_words=2, interval=0.05, min_write_interval=0.0)
    with rep:
        rep.word_started("ship")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    if json.load(f).get("current_word") == "ship":
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.02)
        else:
            pytest.fail("heartbeat never wrote the current word")
    data = obs_progress.read_progress(path)
    assert data["status"] == "done"
    assert data["stale"] is False      # finished runs are never stale


def test_progress_staleness_detection(tmp_path):
    path = str(tmp_path / "_progress.json")
    # tbx: wallclock-ok — forging an old cross-process epoch timestamp, the
    # one clock read_progress is specified against
    stale_state = {"v": 1, "updated_at": time.time() - 1000.0,
                   "heartbeat_seconds": 5.0, "status": "running"}
    with open(path, "w") as f:
        json.dump(stale_state, f)
    data = obs_progress.read_progress(path)
    assert data["stale"] is True
    assert data["age_seconds"] >= 999.0
    # A custom threshold larger than the age flips it back.
    assert obs_progress.read_progress(path, stale_after=2000)["stale"] is False


def test_progress_reports_last_event_age(tmp_path):
    t = obs.activate(str(tmp_path / "_events.jsonl"))
    try:
        t.event("tick")
        rep = obs_progress.ProgressReporter(
            str(tmp_path / "_progress.json"), total_words=1,
            interval=3600, tracer=t)
        snap = rep.snapshot()
        assert 0.0 <= snap["last_event_age_seconds"] < 60.0
    finally:
        obs.deactivate(t)


# ---------------------------------------------------------------------------
# Memory sampling.
# ---------------------------------------------------------------------------

def test_memory_sample_host_fields():
    s = obs_memory.sample()
    assert s["rss_bytes"] is None or s["rss_bytes"] > 0
    assert isinstance(s["devices"], list)  # CPU backend: usually empty
    compact = obs_memory.sample(compact=True)
    json.dumps(compact)
    if compact.get("rss_mb") is not None:
        assert compact["rss_mb"] > 0


# ---------------------------------------------------------------------------
# sweep_observer + trace_report on a synthetic sweep.
# ---------------------------------------------------------------------------

def _synthetic_sweep(out_dir, words=("ship", "moon")):
    with obs.sweep_observer(str(out_dir), pipeline="synthetic",
                            words=list(words)) as ob:
        assert ob.active
        for word in words:
            with ob.word(word) as wsp:
                wsp.set(attempts=1)
                with ob.phase("checkpoint.load"):
                    pass
                with ob.phase("compute:mode"):
                    with obs.span("decode", kind="program", rows=2):
                        pass
                ob.event("aot.build", entry="decode")


def test_sweep_observer_writes_events_and_progress(tmp_path):
    _synthetic_sweep(tmp_path)
    events_path = str(tmp_path / obs.EVENTS_FILENAME)
    progress_path = str(tmp_path / obs.PROGRESS_FILENAME)
    assert os.path.exists(events_path) and os.path.exists(progress_path)

    events = _read_events(events_path)
    run_starts = [e for e in events
                  if e["ev"] == "start" and e["kind"] == "run"]
    assert len(run_starts) == 1
    assert run_starts[0]["attrs"]["pipeline"] == "synthetic"
    word_spans = [e for e in events
                  if e["ev"] == "start" and e["kind"] == "word"]
    assert [e["attrs"]["word"] for e in word_spans] == ["ship", "moon"]

    progress = obs.read_progress(progress_path)
    assert progress["status"] == "done"
    assert progress["words_done"] == 2 and progress["words_total"] == 2
    # Word durations reached the metrics registry.
    assert obs_metrics.snapshot()["histograms"]["word.seconds"]["count"] == 2
    # The synthetic stream passes the schema gate the fixture is held to.
    assert trace_report.check(events_path) == []


def test_sweep_observer_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TBX_OBS", "0")
    with obs.sweep_observer(str(tmp_path), pipeline="x", words=["w"]) as ob:
        assert not ob.active
        with ob.word("w") as sp:
            assert sp is obs.NULL_SPAN
    assert not os.path.exists(tmp_path / obs.EVENTS_FILENAME)


def test_sweep_observer_nested_reuses_outer_tracer(tmp_path):
    outer_dir = tmp_path / "outer"
    inner_dir = tmp_path / "inner"
    with obs.sweep_observer(str(outer_dir), pipeline="outer",
                            words=["a"]) as outer:
        _synthetic_sweep(inner_dir, words=("b",))
        assert obs.get_tracer() is outer.tracer
    # The nested sweep's events land in the OUTER sink; inner gets progress
    # only.
    outer_events = _read_events(str(outer_dir / obs.EVENTS_FILENAME))
    assert sum(1 for e in outer_events
               if e["ev"] == "start" and e["kind"] == "run") == 2
    assert not os.path.exists(inner_dir / obs.EVENTS_FILENAME)
    assert os.path.exists(inner_dir / obs.PROGRESS_FILENAME)


def test_trace_report_renders_synthetic_sweep(tmp_path, capsys):
    _synthetic_sweep(tmp_path)
    events_path = str(tmp_path / obs.EVENTS_FILENAME)
    rc = trace_report.main([events_path, "--roofline", "none"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "run: synthetic" in out
    # Per-word x per-phase table with gap column + critical-path block.
    for token in ("ship", "moon", "checkpoint.load", "compute:mode",
                  "gap", "critical path:", "dispatch gap"):
        assert token in out
    # Program summary pools the decode spans.
    assert "decode" in out and "programs:" in out


def test_trace_report_roofline_join(tmp_path, capsys):
    _synthetic_sweep(tmp_path)
    detail = tmp_path / "bench_detail.json"
    detail.write_text(json.dumps({
        "sweep": {"phase_roofline": {"phases": {
            "decode": {"ceiling_seconds": 0.5}}}}}))
    rc = trace_report.main([str(tmp_path / obs.EVENTS_FILENAME),
                            "--roofline", str(detail)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "ratio_of_ceiling" in out and "ceiling_s" in out


def test_trace_report_check_catches_violations(tmp_path):
    path = str(tmp_path / "_events.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"v": 1, "seq": 1, "t": 0.0, "ev": "start",
                            "kind": "word", "name": "word", "id": 1}) + "\n")
        f.write(json.dumps({"v": 1, "seq": 1, "t": 0.1, "ev": "end",
                            "id": 2, "dur": 0.1, "status": "ok"}) + "\n")
    errors = trace_report.check(path)
    msgs = "\n".join(errors)
    assert "seq 1 not increasing" in msgs
    assert "unknown span id" in msgs
    assert "never ended" in msgs
    assert "no root run span" in msgs
    assert trace_report.main([path, "--check"]) == 1
    # And the committed fixture stays clean (the check.sh drift gate).
    assert trace_report.main([FIXTURE_EVENTS, "--check"]) == 0


def test_obs_warn_emits_event_and_stderr(tmp_path, capsys):
    t = obs.activate(str(tmp_path / "_events.jsonl"))
    try:
        obs.warn("[study] something soft-failed", name="study.warn", word="x")
    finally:
        obs.deactivate(t)
    events = _read_events(str(tmp_path / "_events.jsonl"))
    assert events[0]["name"] == "study.warn"
    assert events[0]["attrs"]["level"] == "warn"
    assert "soft-failed" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Memory sample from torch.cuda; the aot registry snapshot.
# ---------------------------------------------------------------------------

def test_memory_sample_is_host_only_without_a_card(monkeypatch):
    """No CUDA card: the device list is empty and no ``mem.hbm.*`` gauge is
    published, as the JAX package samples without a backend."""
    monkeypatch.setattr(obs_memory, "_cuda", lambda: None)
    s = obs_memory.sample()
    assert s["devices"] == []
    assert obs_memory.live_array_bytes() is None
    snap = obs_metrics.snapshot()["gauges"]
    assert not any(k.startswith("mem.hbm.") for k in snap)
    if s["rss_bytes"] is not None:
        assert snap["mem.host.rss_bytes"] == s["rss_bytes"]


def test_memory_sample_reads_torch_cuda_fields(monkeypatch):
    """On a card the sample reads ``torch.cuda.memory_stats`` and
    ``mem_get_info`` into the JAX fields and the gauges the autotuner
    reads (a stand-in ``torch.cuda`` here)."""
    class FakeCuda:
        @staticmethod
        def device_count():
            return 1

        @staticmethod
        def memory_stats(i):
            return {"allocated_bytes.all.current": 3 << 30,
                    "allocated_bytes.all.peak": 5 << 30}

        @staticmethod
        def mem_get_info(i):
            return (70 << 30, 80 << 30)

        @staticmethod
        def memory_allocated(i):
            return 3 << 30

    class FakeTorch:
        cuda = FakeCuda

    monkeypatch.setattr(obs_memory, "_cuda", lambda: FakeTorch)
    devices = obs_memory.device_memory_stats()
    assert devices == [{"device": "0", "bytes_in_use": 3 << 30,
                        "peak_bytes_in_use": 5 << 30,
                        "bytes_limit": 80 << 30}]
    assert obs_memory.live_array_bytes() == 3 << 30
    compact = obs_memory.sample(compact=True)
    assert compact["hbm_live_mb"] == round((3 << 30) / 1e6, 1)
    gauges = obs_metrics.snapshot()["gauges"]
    assert gauges["mem.hbm.live_bytes"] == 3 << 30
    assert gauges["mem.hbm.peak_bytes"] == 5 << 30
    assert gauges["mem.hbm.limit_bytes"] == 80 << 30
    assert gauges["mem.hbm.headroom_frac"] == pytest.approx(1 - 3 / 80, abs=1e-4)


def test_sweep_observer_publishes_aot_entries(tmp_path):
    """At close the graph registry's per-entry counters land in the metrics
    registry; its byte totals (plain numbers) are skipped."""
    from taboo_brittleness_tpu_torch.runtime import aot

    aot.reset()
    aot.entry("serve.step").hits = 3
    try:
        _synthetic_sweep(tmp_path)
        gauges = obs_metrics.snapshot()["gauges"]
        assert gauges["aot.serve.step.hits"] == 3
        assert not any(k.startswith("aot.pool_bytes") for k in gauges)
    finally:
        aot.reset()


# ---------------------------------------------------------------------------
# Windowed metrics spool.
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_window_and_exit_records_conserve(tmp_path):
    """The recorder's output satisfies every invariant the checker holds
    streams to: monotone seq/t0, exact counter conservation, and an exit
    record identical to the final window's snapshot."""
    from taboo_brittleness_tpu_torch.obs import timeseries

    reg = obs_metrics.MetricsRegistry()
    clock = FakeClock()
    path = str(tmp_path / "_metrics.jsonl")
    rec = timeseries.TimeseriesRecorder(path, registry=reg, window_s=10.0,
                                        sample_memory=False, clock=clock)
    reg.counter("work.units").inc(3)
    reg.gauge("work.depth").set(2.0)
    for v in (0.1, 0.2, 0.3):
        reg.histogram("work.latency").observe(v)
    clock.advance(10.0)
    rec.roll()
    reg.counter("work.units").inc(4)
    clock.advance(10.0)
    rec.roll()
    clock.advance(2.0)
    rec.stop()

    records = list(timeseries.iter_windows(path))
    assert [r["kind"] for r in records] == ["window", "window", "window", "exit"]
    w1, w2, w3, ex = records
    assert [r["seq"] for r in records] == [1, 2, 3, 4]
    assert w1["counters"]["work.units"] == {"total": 3.0, "delta": 3.0}
    assert w2["counters"]["work.units"] == {"total": 7.0, "delta": 4.0}
    assert w3["counters"]["work.units"] == {"total": 7.0, "delta": 0.0}
    assert w1["gauges"]["work.depth"] == 2.0
    h = w1["histograms"]["work.latency"]
    assert h["n"] == 3 and h["cum_n"] == 3
    assert w2["histograms"]["work.latency"]["n"] == 0
    assert ex["counters"]["work.units"] == w3["counters"]["work.units"]["total"]
    assert trace_report._check_metrics_file(path) == []


def test_seq_resumes_and_torn_tail_is_skipped(tmp_path):
    from taboo_brittleness_tpu_torch.obs import timeseries

    reg = obs_metrics.MetricsRegistry()
    clock = FakeClock()
    path = str(tmp_path / "_metrics.jsonl")
    rec = timeseries.TimeseriesRecorder(path, registry=reg, window_s=1.0,
                                        sample_memory=False, clock=clock)
    clock.advance(1.0)
    rec.roll()
    rec.stop()
    with open(path, "a") as f:
        f.write('{"v": 1, "kind": "window", "seq": 9999, "tr')  # torn tail
    assert timeseries._resume_seq(path) == 3
    assert [r["seq"] for r in timeseries.iter_windows(path)] == [1, 2, 3]
    with pytest.raises(ValueError):
        list(timeseries.iter_windows(path, strict=True))
    rec2 = timeseries.TimeseriesRecorder(path, registry=reg, window_s=1.0,
                                         sample_memory=False, clock=clock)
    clock.advance(1.0)
    rec2.roll()
    rec2.stop()
    seqs = [r["seq"] for r in timeseries.iter_windows(path)]
    assert seqs == sorted(seqs) and seqs[-1] > 3


def test_metrics_write_fault_drops_window_and_confesses(tmp_path, monkeypatch):
    """The ``obs.metrics_write`` fault site: an injected sink fault costs
    one window (drop-counted), the run survives, and the next window
    confesses the gap via ``obs.metrics_dropped``."""
    from taboo_brittleness_tpu_torch.obs import timeseries

    monkeypatch.setenv("TABOO_FAULT_PLAN", json.dumps(
        {"obs.metrics_write": {"mode": "fail", "kind": "permanent",
                               "times": 1}}))
    resilience.set_injector(None)               # rebuild from env
    clock = FakeClock()
    path = str(tmp_path / "_metrics.jsonl")
    rec = timeseries.TimeseriesRecorder(path, window_s=5.0,
                                        sample_memory=False, clock=clock)
    obs_metrics.counter("work.units").inc(2)
    clock.advance(5.0)
    assert rec.roll() is not None
    assert rec.dropped == 1
    assert obs_metrics.counter("obs.metrics_dropped").value == 1.0
    obs_metrics.counter("work.units").inc(5)
    clock.advance(5.0)
    rec.roll()
    rec.stop()
    records = list(timeseries.iter_windows(path))
    assert [r["kind"] for r in records] == ["window", "window", "exit"]
    assert records[0]["counters"]["work.units"]["total"] == 7.0
    assert records[0]["counters"]["obs.metrics_dropped"]["total"] == 1.0
    assert trace_report._check_metrics_file(path) == []


# ---------------------------------------------------------------------------
# Flight recorder and request traces.
# ---------------------------------------------------------------------------

def test_flightrec_ring_bounds_and_atomic_dump(tmp_path):
    from taboo_brittleness_tpu_torch.obs import flightrec

    fr = flightrec.FlightRecorder(capacity=4)
    assert fr.dump("early") is None             # unconfigured: no-op
    fr.configure(str(tmp_path))
    for i in range(7):
        fr.record("step", i=i)
    path = fr.dump("test", word="ship")
    assert path == str(tmp_path / "_flightrec.json")
    with open(path) as f:
        data = json.load(f)
    assert data["v"] == flightrec.SCHEMA_VERSION
    assert data["reason"] == "test" and data["capacity"] == 4
    assert [r["i"] for r in data["ring"]] == [3, 4, 5, 6]
    assert data["context"] == {"word": "ship"}
    assert trace_report.check_flightrec(str(tmp_path / "_events.jsonl")) == []
    off = flightrec.FlightRecorder(capacity=0)
    off.configure(str(tmp_path))
    off.record("step")
    assert off.snapshot() == [] and off.dump("test") is None


def test_request_trace_context_roundtrip():
    from taboo_brittleness_tpu_torch.obs import reqtrace

    ctx = reqtrace.mint()
    assert ctx["v"] == reqtrace.CTX_VERSION
    assert len(ctx["trace_id"]) == 16 and ctx["attempt"] == 0
    assert reqtrace.parse({reqtrace.CTX_KEY: ctx})["trace_id"] == ctx["trace_id"]
    newer = {**reqtrace.mint(), "v": reqtrace.CTX_VERSION + 1}
    assert reqtrace.parse({reqtrace.CTX_KEY: newer}) is None
    assert reqtrace.parse(None) is None
    payload, minted_ctx, minted = reqtrace.ensure({"id": "r0"}, synthetic=True)
    assert minted and minted_ctx["synthetic"] is True
    assert reqtrace.ensure(payload)[1]["trace_id"] == minted_ctx["trace_id"]
    child = reqtrace.for_attempt(ctx, 1, dead_holder="w1-i0")
    assert child["trace_id"] == ctx["trace_id"] and child["dead"] == ["w1-i0"]


def test_exemplars_keep_worst_k_and_drain(monkeypatch):
    from taboo_brittleness_tpu_torch.obs import reqtrace

    reqtrace.reset_exemplars()
    monkeypatch.setenv("TBX_TRACE_EXEMPLARS", "2")
    for tid, v in (("aa", 0.1), ("bb", 0.9), ("cc", 0.5)):
        reqtrace.note_exemplar("serve.latency.chat", tid, v)
    assert reqtrace.take_exemplars("serve.latency.chat") == ["bb", "cc"]
    assert reqtrace.take_exemplars("serve.latency.chat") == []
    assert reqtrace.peek_exemplars() == {"serve.latency.chat": ["bb", "cc"]}
    monkeypatch.setenv("TBX_TRACE_EXEMPLARS", "0")
    reqtrace.reset_exemplars()
    reqtrace.note_exemplar("serve.latency.chat", "aa", 1.0)
    assert reqtrace.peek_exemplars() == {}
