"""``top``: a live terminal view of one output directory's telemetry.

The PyTorch port's copy of the JAX package's ``obs/top.py`` (stdlib only;
its selfcheck renders the committed ``tests/fixtures/obs/{fleet,
serve_fleet}`` directories in place).

Everything the repo's observability stack writes is a file next to the run
(``_progress*.json`` heartbeats, the ``_metrics*.jsonl`` windowed spool,
``_fleet.json``, ``_flightrec*.json``), so "what is the fleet doing right
now" should never require attaching a debugger or a dashboard.  This module
renders those files as a compact text screen:

- one lane per progress heartbeat (the coordinator plus each fleet worker):
  status, current word/phase, done/total, heartbeat age, staleness;
- the serve block when a heartbeat carries ``workload: "serve"``: in-flight
  / completed / queued plus the WINDOWED per-scenario p99 next to the
  honestly-labeled cumulative one;
- the SLO burn table from the latest spool window (``obs.slo``), the
  speculation accept rate from the window's counter deltas, and the HBM
  live/peak/headroom gauges (``obs.memory``);
- spool health: windows seen, drop counters, flight-recorder dumps.

Stdlib-only, read-only, fail-open: a torn tail line or a missing file
renders as absent, never as a crash.  ``--once`` prints one frame and exits
(the CI smoke); the live loop redraws every ``--interval`` seconds until
interrupted.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Any, Dict, List, Optional

#: How much of a spool file's tail one frame parses (enough for the last
#: few windows of even a metric-heavy run, tiny against a long spool).
_TAIL_BYTES = 256 * 1024


# ---------------------------------------------------------------------------
# Collection: files → one state dict (pure, testable).
# ---------------------------------------------------------------------------


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def _tail_jsonl(path: str, max_bytes: int = _TAIL_BYTES) -> List[Dict[str, Any]]:
    """Parse the last ``max_bytes`` of a JSONL file, skipping the (possibly
    torn) first partial line and any torn tail — the reader's half of the
    whole-line O_APPEND contract."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            chunk = f.read()
    except OSError:
        return []
    if size > max_bytes:
        chunk = chunk.split(b"\n", 1)[-1]
    out: List[Dict[str, Any]] = []
    for line in chunk.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def collect(output_dir: str) -> Dict[str, Any]:
    """One frame's worth of state from ``output_dir`` (see module doc)."""
    from taboo_brittleness_tpu_torch.obs.progress import read_progress

    lanes: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(output_dir,
                                              "_progress*.json"))):
        data = read_progress(path, missing_ok=True)
        if data.get("status") == "absent":
            continue
        base = os.path.basename(path)
        lane = (base[len("_progress."):-len(".json")]
                if base != "_progress.json" else None)
        data["lane"] = data.get("worker") or lane or "main"
        lanes.append(data)

    # Latest window per (worker) lane across every spool file; the merged
    # _metrics.jsonl carries worker-stamped records, per-worker files don't.
    windows: Dict[str, Dict[str, Any]] = {}
    exits: Dict[str, Dict[str, Any]] = {}
    n_windows = 0
    for path in sorted(glob.glob(os.path.join(output_dir,
                                              "_metrics*.jsonl"))):
        base = os.path.basename(path)
        suffix = (base[len("_metrics."):-len(".jsonl")]
                  if base != "_metrics.jsonl" else None)
        for rec in _tail_jsonl(path):
            lane = str(rec.get("worker") or suffix or "main")
            if rec.get("kind") == "window":
                n_windows += 1
                windows[lane] = rec
            elif rec.get("kind") == "exit":
                exits[lane] = rec
    # The frame's headline window: the latest roll anywhere.
    latest = max(windows.values(), key=lambda r: float(r.get("wall", 0.0)),
                 default=None)

    recs = []
    for path in sorted(glob.glob(os.path.join(output_dir,
                                              "_flightrec*.json"))):
        data = _read_json(path)
        if data is not None:
            recs.append({"file": os.path.basename(path),
                         "reason": data.get("reason"),
                         "records": len(data.get("ring") or [])})

    return {
        "dir": output_dir,
        "lanes": lanes,
        "fleet": _read_json(os.path.join(output_dir, "_fleet.json")),
        "serve": _read_json(os.path.join(output_dir, "_serve.json")),
        "serve_fleet": _read_json(os.path.join(output_dir,
                                               "_serve_fleet.json")),
        "gateway": _read_json(os.path.join(output_dir, "_gateway.json")),
        "windows": windows,
        "exits": exits,
        "n_windows": n_windows,
        "latest": latest,
        "flightrec": recs,
    }


# ---------------------------------------------------------------------------
# Rendering: state dict → one text frame (pure, testable).
# ---------------------------------------------------------------------------


def _fmt_bytes(n: Optional[float]) -> str:
    if not n:
        return "-"
    for unit in ("B", "K", "M", "G", "T"):
        if abs(n) < 1024 or unit == "T":
            return (f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}")
        n /= 1024.0
    return "-"


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None else f"{float(v):.2f}s"


def _lane_line(lane: Dict[str, Any]) -> str:
    status = str(lane.get("status", "?"))
    if lane.get("stale"):
        status += " STALE"
    bits = [f"  {str(lane.get('lane', '?')):<10} {status:<14}"]
    if lane.get("workload") == "serve":
        sv = lane.get("serving") or {}
        bits.append(f"in-flight {sv.get('in_flight', 0)}  "
                    f"completed {sv.get('completed_requests', 0)}  "
                    f"queued {sv.get('queued', 0)}  "
                    f"step-age {_fmt_s(sv.get('last_step_age_seconds'))}")
        # Occupancy vs the autotuned admission width — the
        # second column the router steers by: active/width (+verdict when
        # the solver changed or abandoned the configured width).
        slots = sv.get("slots") or {}
        if slots:
            occ = f"slots {slots.get('active', 0)}/{slots.get('width', '?')}"
            verdict = str(slots.get("verdict", ""))
            if verdict and verdict not in ("ok", "off"):
                occ += f" ({verdict})"
            bits.append(occ)
        # The burn column the serve-fleet router steers by: the lane's
        # worst fast-window serve burn, straight off its own heartbeat.
        fast = None
        for key, cell in (lane.get("slo") or {}).items():
            if not str(key).startswith("serve"):
                continue
            try:
                val = float((cell or {}).get("fast", 0.0))
            except (TypeError, ValueError):
                continue
            fast = val if fast is None else max(fast, val)
        if fast is not None:
            bits.append(f"burn {fast:.2f}x")
    else:
        word = lane.get("current_word")
        phase = lane.get("phase")
        bits.append(f"{lane.get('words_done', 0)}/"
                    f"{lane.get('words_total', 0)} words")
        if lane.get("words_quarantined"):
            bits.append(f"quarantined {lane['words_quarantined']}")
        if word:
            bits.append(f"word={word}" + (f":{phase}" if phase else ""))
        if lane.get("eta_seconds") is not None:
            bits.append(f"eta {lane['eta_seconds']:.0f}s")
    bits.append(f"beat {lane.get('age_seconds', 0):.1f}s ago")
    return "  ".join(bits)


def _slo_lines(latest: Dict[str, Any]) -> List[str]:
    block = latest.get("slo") or {}
    if not block:
        return []
    out = ["slo burn (x over budget; fast/slow windows):"]
    for key in sorted(block):
        cell = block[key]
        flag = "ok" if cell.get("ok") else "ALERT"
        line = (f"  {key:<28} {cell.get('burn', 0):>8.2f}x  "
                f"fast {cell.get('fast', 0):.2f}  "
                f"slow {cell.get('slow', 0):.2f}  {flag}")
        exemplars = cell.get("exemplars") or []
        if exemplars:
            # Worst trace ids this window — feed them to ``tbx trace
            # <results_dir> --trace <id>`` for the full waterfall.
            line += "  traces: " + ",".join(str(t) for t in exemplars[:3])
        out.append(line)
    return out


def _latency_lines(lanes: List[Dict[str, Any]]) -> List[str]:
    for lane in lanes:
        lat = (lane.get("serving") or {}).get("latency") or {}
        scenarios = lat.get("scenarios") or {}
        if not scenarios:
            continue
        out = [f"serve latency (window {lat.get('window_s', '?')}s | "
               "cumulative):"]
        for name in sorted(scenarios):
            w = scenarios[name].get("window") or {}
            c = scenarios[name].get("cumulative") or {}
            out.append(f"  {name:<20} p99 {_fmt_s(w.get('p99_s')):>8} "
                       f"(n={w.get('n', 0)})  |  "
                       f"p99 {_fmt_s(c.get('p99_s')):>8} "
                       f"(n={c.get('n', 0)})")
        return out
    return []


def _window_extras(latest: Dict[str, Any]) -> List[str]:
    out = []
    counters = latest.get("counters") or {}
    drafted = (counters.get("serve.spec.drafted") or {}).get("delta", 0)
    accepted = (counters.get("serve.spec.accepted") or {}).get("delta", 0)
    if drafted:
        out.append(f"spec accept: {accepted / drafted:.2f} "
                   f"({int(accepted)}/{int(drafted)} this window)")
    gauges = latest.get("gauges") or {}
    live = gauges.get("mem.hbm.live_bytes")
    if live is not None:
        line = f"hbm: live {_fmt_bytes(live)}"
        if gauges.get("mem.hbm.peak_bytes") is not None:
            line += f"  peak {_fmt_bytes(gauges['mem.hbm.peak_bytes'])}"
        if gauges.get("mem.hbm.headroom_frac") is not None:
            line += f"  headroom {100 * gauges['mem.hbm.headroom_frac']:.1f}%"
        out.append(line)
    if gauges.get("mem.host.rss_bytes") is not None:
        out.append(f"rss: {_fmt_bytes(gauges['mem.host.rss_bytes'])}")
    return out


def render(state: Dict[str, Any]) -> str:
    lines = [f"tbx top — {state['dir']}",
             "=" * max(20, len(state["dir"]) + 10)]
    fleet = state.get("fleet")
    if fleet:
        lines.append(
            f"fleet: {fleet.get('status', '?')}  "
            f"committed {fleet.get('committed', 0)}/"
            f"{fleet.get('units_total', 0)}  "
            f"reissued {fleet.get('reissued', 0)}  "
            f"lease-expiries {fleet.get('lease_expiries', 0)}"
            + (f"  recovery {fleet['recovery_seconds']:.1f}s"
               if fleet.get("recovery_seconds") is not None else ""))
    sf = state.get("serve_fleet")
    if sf:
        lines.append(
            f"serve-fleet: {sf.get('status', '?')}  "
            f"answered {sf.get('completed', 0)}/"
            f"{sf.get('requests_total', 0)}  "
            f"shed {sf.get('shed', 0)}  "
            f"respooled {sf.get('respooled', 0)}  "
            f"lease-expiries {sf.get('lease_expiries', 0)}  "
            f"dupes {sf.get('duplicate_commits', 0)}"
            + (f"  recovery {sf['recovery_seconds']:.1f}s"
               if sf.get("recovery_seconds") is not None else ""))
    gw = state.get("gateway")
    if gw:
        win = gw.get("window") or {}
        shed = gw.get("shed") or {}
        line = (f"gateway: {'draining' if gw.get('draining') else 'up'}  "
                f"port {gw.get('port', '?')}  "
                f"streams {gw.get('open_streams', 0)}/"
                f"{win.get('limit', '?')}  "
                f"accepted {gw.get('accepted', 0)}  "
                f"done {gw.get('completed', 0)}  "
                f"canceled {gw.get('canceled', 0)}")
        if shed:
            line += "  shed " + ",".join(
                f"{k}={shed[k]}" for k in sorted(shed))
        lines.append(line)
        tenants = gw.get("tenants") or {}
        tenant_shed = {t: c.get("shed", 0) for t, c in tenants.items()
                       if c.get("shed", 0)}
        if tenant_shed:
            lines.append("  tenant shed: " + "  ".join(
                f"{t}={tenant_shed[t]}" for t in sorted(tenant_shed)))
    lanes = state.get("lanes") or []
    if lanes:
        lines.append("lanes:")
        lines.extend(_lane_line(ln) for ln in lanes)
    else:
        lines.append("lanes: (no _progress*.json yet)")
    lines.extend(_latency_lines(lanes))
    latest = state.get("latest")
    if latest is not None:
        lines.extend(_slo_lines(latest))
        lines.extend(_window_extras(latest))
        counters = latest.get("counters") or {}
        dropped = (counters.get("obs.metrics_dropped") or {}).get("total", 0)
        lines.append(
            f"spool: {state.get('n_windows', 0)} windows in tail "
            f"({len(state.get('windows') or {})} lane(s)); "
            f"dropped {int(dropped)}")
    else:
        lines.append("spool: (no _metrics*.jsonl windows yet)")
    for rec in state.get("flightrec") or []:
        lines.append(f"flightrec: {rec['file']}  reason={rec['reason']}  "
                     f"{rec['records']} records")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def run(output_dir: str, *, once: bool = False,
        interval: float = 2.0) -> int:
    while True:
        frame = render(collect(output_dir))
        if once:
            print(frame)  # tbx: TBX009-ok — CLI stdout contract (top frame)
            return 0
        # tbx: TBX009-ok — CLI stdout contract (live screen redraw)
        print("\x1b[2J\x1b[H" + frame, flush=True)
        try:
            time.sleep(max(0.2, interval))
        except KeyboardInterrupt:
            return 0


def default_fixture_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "tests", "fixtures", "obs", "fleet")


def default_serve_fleet_fixture_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "tests", "fixtures", "obs", "serve_fleet")


def main_selfcheck(fixture_dir: Optional[str] = None) -> int:
    """The smoke (``top --once --selfcheck``): render the committed fleet
    fixture and assert the frame carries the load-bearing sections — worker
    lanes and spool windows — so a silent collection regression fails the
    gate instead of rendering an empty screen forever.  When the serve-fleet
    fixture is committed too, render it and assert replica lanes plus the
    serve-fleet summary line."""
    fixture_dir = fixture_dir or default_fixture_dir()
    state = collect(fixture_dir)
    frame = render(state)
    print(frame)  # tbx: TBX009-ok — CLI stdout contract (selfcheck frame)
    problems = []
    if not state["lanes"]:
        problems.append("no progress lanes in fixture")
    if state["latest"] is None:
        problems.append("no metrics windows in fixture")
    if not state["flightrec"]:
        problems.append("no flight-recorder dump in fixture")
    sf_dir = default_serve_fleet_fixture_dir()
    if fixture_dir == default_fixture_dir() and os.path.isdir(sf_dir):
        sf_state = collect(sf_dir)
        sf_frame = render(sf_state)
        # tbx: TBX009-ok — CLI stdout contract (selfcheck frame)
        print(sf_frame)
        replica_lanes = [ln for ln in sf_state["lanes"]
                         if ln.get("workload") == "serve"]
        if len(replica_lanes) < 2:
            problems.append("serve_fleet fixture: fewer than 2 replica "
                            "serve lanes")
        if not sf_state.get("serve_fleet"):
            problems.append("serve_fleet fixture: no _serve_fleet.json "
                            "summary")
        elif "serve-fleet:" not in sf_frame:
            problems.append("serve_fleet fixture: summary line not "
                            "rendered")
        if not sf_state.get("gateway"):
            problems.append("serve_fleet fixture: no _gateway.json "
                            "heartbeat")
        elif "gateway:" not in sf_frame or "tenant shed:" not in sf_frame:
            problems.append("serve_fleet fixture: gateway lane not "
                            "rendered")
    if problems:
        # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict)
        print("top selfcheck FAILED: " + "; ".join(problems))
        return 1
    print("top selfcheck OK")  # tbx: TBX009-ok — CLI stdout contract
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="top", description=__doc__)
    p.add_argument("--dir", default=".", help="run output directory to watch")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (CI / piping)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="live-refresh period in seconds")
    p.add_argument("--selfcheck", action="store_true",
                   help="render the committed fleet fixture and verify the "
                        "frame (CI smoke)")
    args = p.parse_args(argv)
    if args.selfcheck:
        return main_selfcheck()
    return run(args.dir, once=args.once, interval=args.interval)


__all__ = ["collect", "render", "run", "main", "main_selfcheck"]
