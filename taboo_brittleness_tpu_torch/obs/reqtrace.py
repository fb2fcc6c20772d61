"""End-to-end request tracing: context propagation + per-request waterfalls.

The serving stack spans six processes per request — loadgen → spool → fleet
router → replica claim → scheduler/engine step → first-writer-wins commit,
with lease-expiry re-spools to a *different* replica on death — and every
telemetry stream is process-scoped.  This module is the request-centric
join:

**Trace context** (``CTX_KEY`` in the request JSON): a compact dict minted
once at submit (``RequestSpool.put`` / ``loadgen.build_schedule``) and
carried inside the request payload through assigned-routing, claim-by-
rename, lease re-spool and speculative duplicate dispatch, then stamped
into the Response and the ``responses/`` file — one request is ONE trace
across replica death::

    {"v": 1, "trace_id": "<16 hex>", "parent": <minting span id or None>,
     "attempt": 0}
    # + "synthetic": true    when minted at claim for a pre-trace payload
    # + "dead": ["<holder>"] holders whose lease expired (re-spool chain)

Versioning: ``v`` is CTX_VERSION.  Readers accept their own version and
older; unknown versions parse as *absent* (the legacy-payload path: a
synthetic context is minted at claim with a one-shot ``obs.warn``) so a
mid-upgrade spool keeps serving.

**Lifecycle spans**: the scheduler opens one ``kind="request"`` span per
(request, attempt) — ``serve.request``, off the per-thread stack
(``Tracer.span_detached``) because in-flight requests interleave — with a
``serve.first_token`` point marking TTFT (submit → first emitted token on
the serving attempt).  A replica killed mid-decode leaves the span
dangling; the fleet merge closes it with a synthesized ``status="error"``
end, which is exactly the first-attempt closure the waterfall renders.

**Exemplars**: completions register their trace_id per SLO series (capped
at ``TBX_TRACE_EXEMPLARS``, worst-latency-first); the SLO engine drains
them into each burn window's cells so ``tbx top`` and flightrec dumps link
a burning series straight to offending traces, resolvable by ``tbx trace``.

**Assembler / CLI**: :func:`assemble` folds event streams into
per-request attempt chains and :func:`render` draws one as a waterfall::

    trace <results_dir>                  # slowest-10 waterfalls
    trace <results_dir> --request RID    # one request's attempt chain
    trace <results_dir> --trace TID      # resolve an exemplar trace_id
    trace <results_dir> --slowest N
    trace --selfcheck                    # the committed fixture's gate

The PyTorch port's copy of the JAX package's ``obs/reqtrace.py``; the
selfcheck reads the committed ``tests/fixtures/obs/serve_fleet/`` streams
in place (data, not code).

stdlib-only and fail-open like the rest of obs.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from taboo_brittleness_tpu_torch.obs import trace as trace_mod

#: Request-payload key the context rides under.
CTX_KEY = "trace"

#: Bumped whenever the context gains/renames a REQUIRED key; readers accept
#: their own version and older, and treat newer as absent (synthetic mint).
CTX_VERSION = 1

#: Span/point names the scheduler emits (the assembler + checker key off
#: these).
REQUEST_SPAN = "serve.request"
FIRST_TOKEN_POINT = "serve.first_token"


# ---------------------------------------------------------------------------
# Context mint / parse / propagation.
# ---------------------------------------------------------------------------

def mint(*, attempt: int = 0, synthetic: bool = False) -> Dict[str, Any]:
    """A fresh trace context.  ``parent`` records the minting process's
    current span id (the loadgen/bench span submitting the request) purely
    as provenance — lifecycle spans parent under the SERVING process's run
    span."""
    t = trace_mod.get_tracer()
    cur = t.current_span() if t is not None else None
    ctx: Dict[str, Any] = {
        "v": CTX_VERSION,
        "trace_id": uuid.uuid4().hex[:16],
        "parent": cur.span_id if cur is not None else None,
        "attempt": int(attempt),
    }
    if synthetic:
        ctx["synthetic"] = True
    return ctx


def parse(payload: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The validated context carried by a request payload, or None (absent,
    malformed, or minted by a NEWER writer than this reader understands)."""
    if not isinstance(payload, dict):
        return None
    ctx = payload.get(CTX_KEY)
    if not isinstance(ctx, dict):
        return None
    try:
        if int(ctx.get("v", 0)) > CTX_VERSION:
            return None
        tid = str(ctx.get("trace_id", ""))
        if not tid:
            return None
        return {
            "v": int(ctx.get("v", CTX_VERSION)),
            "trace_id": tid,
            "parent": ctx.get("parent"),
            "attempt": int(ctx.get("attempt", 0)),
            **({"synthetic": True} if ctx.get("synthetic") else {}),
            **({"dead": list(ctx.get("dead", ()))} if ctx.get("dead") else {}),
        }
    except (TypeError, ValueError):
        return None


def ensure(payload: Dict[str, Any], *,
           synthetic: bool = False) -> Tuple[Dict[str, Any], Dict[str, Any],
                                             bool]:
    """(payload-with-context, context, minted?) — attach a context when the
    payload carries none (``synthetic=True`` marks a claim-time mint for a
    pre-trace/legacy payload)."""
    ctx = parse(payload)
    if ctx is not None:
        return payload, ctx, False
    ctx = mint(attempt=0, synthetic=synthetic)
    return {**payload, CTX_KEY: ctx}, ctx, True


#: HTTP header the gateway reads/propagates the context from.
#: Format is traceparent-style: ``<2-hex version>-<16..32 hex trace id>-
#: <16 hex parent span id or zeros>-<2 hex flags>``; the W3C field layout,
#: our 16-hex trace ids.
TRACE_HEADER = "x-tbx-trace"

_HEX = frozenset("0123456789abcdef")


def parse_header(value: Optional[str]) -> Optional[Dict[str, Any]]:
    """A trace context from a traceparent-style HTTP header, or None for a
    missing/malformed header (the caller re-mints with the one-shot warn —
    ``ensure_from_header``).  Longer (W3C 32-hex) trace ids are accepted
    and truncated to this repo's 16-hex form."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, parent, _flags = parts
    if len(ver) != 2 or not set(ver) <= _HEX:
        return None
    if not (16 <= len(tid) <= 32) or not set(tid) <= _HEX:
        return None
    if set(tid) == {"0"}:
        return None
    if len(parent) != 16 or not set(parent) <= _HEX:
        return None
    return {
        "v": CTX_VERSION,
        "trace_id": tid[:16],
        "parent": None if set(parent) == {"0"} else parent,
        "attempt": 0,
    }


def format_header(ctx: Dict[str, Any]) -> str:
    """The wire form of a context — what a socket client (``tbx loadgen
    --socket``) sends so its pre-minted trace survives the HTTP hop."""
    parent = str(ctx.get("parent") or "").lower()
    if len(parent) != 16 or not set(parent) <= _HEX:
        parent = "0" * 16
    return f"00-{ctx['trace_id']}-{parent}-01"


def ensure_from_header(payload: Dict[str, Any],
                       header: Optional[str]) -> Tuple[Dict[str, Any],
                                                       Dict[str, Any], bool]:
    """(payload-with-context, context, minted?) for a request arriving over
    HTTP: a valid header's context rides into the spool payload (the
    waterfall spans the socket hop); an absent or malformed header mints a
    fresh context HERE at the gateway — the trace's birthplace moves to the
    edge.  A context already in the payload body wins over the header
    (explicit beats transport)."""
    ctx = parse(payload)
    if ctx is not None:
        return payload, ctx, False
    ctx = parse_header(header)
    if ctx is not None:
        return {**payload, CTX_KEY: ctx}, ctx, False
    ctx = mint(attempt=0)
    return {**payload, CTX_KEY: ctx}, ctx, True


def for_attempt(ctx: Dict[str, Any], attempt: int,
                *, dead_holder: Optional[str] = None) -> Dict[str, Any]:
    """The re-spool child context: SAME trace_id, bumped attempt, the dead
    holder recorded — a retry child span under the same trace, never a new
    trace."""
    nxt = dict(ctx)
    nxt["attempt"] = int(attempt)
    if dead_holder:
        nxt["dead"] = sorted(set(nxt.get("dead", ())) | {str(dead_holder)})
    return nxt


# ---------------------------------------------------------------------------
# Exemplar registry (SLO burn window → trace_id join).
# ---------------------------------------------------------------------------

_EX_LOCK = threading.Lock()
#: metric name -> [(value, trace_id)] kept worst-first, capped at the knob.
_EX_CURRENT: Dict[str, List[Tuple[float, str]]] = {}
#: metric name -> the most recently drained window's trace ids (what a
#: flightrec dump attaches when the SLO engine already consumed the window).
_EX_LAST: Dict[str, List[str]] = {}


def exemplar_cap() -> int:
    """Exemplars kept per series per window (``TBX_TRACE_EXEMPLARS``,
    default 3; 0 disables the registry)."""
    try:
        return max(0, int(os.environ.get("TBX_TRACE_EXEMPLARS", "3")))
    except ValueError:
        return 3


def note_exemplar(metric: str, trace_id: Optional[str],
                  value: float) -> None:
    """Register one observation's trace_id against a histogram series.
    Keeps the K WORST (largest) values in the current window — the traces
    an operator chasing a burning latency SLO actually wants."""
    cap = exemplar_cap()
    if not trace_id or cap <= 0:
        return
    try:
        v = float(value)
    except (TypeError, ValueError):
        return
    with _EX_LOCK:
        cur = _EX_CURRENT.setdefault(metric, [])
        cur.append((v, str(trace_id)))
        cur.sort(key=lambda p: -p[0])
        del cur[cap:]


def take_exemplars(metric: str) -> List[str]:
    """Drain the current window's exemplars for one series (the SLO engine,
    once per observe_window) — worst-first trace ids."""
    with _EX_LOCK:
        cur = _EX_CURRENT.pop(metric, None)
        if not cur:
            return []
        ids = [tid for _v, tid in cur]
        _EX_LAST[metric] = ids
        return ids


def peek_exemplars() -> Dict[str, List[str]]:
    """Non-draining snapshot across every series: the current window's
    exemplars merged over the last drained window's (flightrec dumps fire
    between windows, so either alone can be empty)."""
    with _EX_LOCK:
        out: Dict[str, List[str]] = {}
        for metric, ids in _EX_LAST.items():
            out[metric] = list(ids)
        for metric, cur in _EX_CURRENT.items():
            seen = out.setdefault(metric, [])
            for _v, tid in cur:
                if tid not in seen:
                    seen.append(tid)
        return {k: v[:max(1, exemplar_cap())] for k, v in out.items() if v}


def reset_exemplars() -> None:
    """Tests only: drop all registered exemplars."""
    with _EX_LOCK:
        _EX_CURRENT.clear()
        _EX_LAST.clear()


# ---------------------------------------------------------------------------
# Causal assembler: merged + per-worker event streams → per-request
# waterfalls.
# ---------------------------------------------------------------------------

#: Coordinator point events joined into a trace by their ``request`` attr.
#: The gateway.* points extend the waterfall across the socket
#: hop: accept → spooled → stream start/done (or shed/cancel) bracket the
#: replica-side lifecycle.
_COORD_POINTS = ("serve_fleet.route", "serve_fleet.respool",
                 "serve_fleet.reroute", "serve_fleet.lease_expired",
                 "serve_fleet.shed", "serve.respond", "serve.claim",
                 "gateway.accept", "gateway.shed", "gateway.cancel",
                 "gateway.stream_done")


def find_event_files(path: str) -> List[str]:
    """Event streams for one results dir (or a direct ``_events.jsonl``
    path).  A merged ``_events.jsonl`` already holds every per-worker
    stream (the fleet merge folds and renumbers them), so it is read
    alone; otherwise the per-worker ``_events.<wid>.jsonl`` files are read
    together."""
    if os.path.isfile(path):
        return [path]
    merged = os.path.join(path, trace_mod.EVENTS_FILENAME)
    if os.path.exists(merged):
        return [merged]
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return []
    return [os.path.join(path, n) for n in names
            if n.startswith("_events.") and n.endswith(".jsonl")]


class Attempt:
    """One (request, attempt) lifecycle span plus its parented points."""

    __slots__ = ("request", "number", "worker", "span_id", "t0", "dur",
                 "status", "error", "attrs", "first_token", "synthesized")

    def __init__(self, ev: Dict[str, Any]):
        attrs = ev.get("attrs") or {}
        self.request = str(attrs.get("request", ""))
        self.number = int(attrs.get("attempt", 0) or 0)
        self.worker = ev.get("worker")
        self.span_id = ev.get("id")
        self.t0 = float(ev.get("t", 0.0))
        self.dur: Optional[float] = None
        self.status: Optional[str] = None
        self.error: Optional[str] = None
        self.attrs: Dict[str, Any] = dict(attrs)
        self.first_token: Optional[Dict[str, Any]] = None
        self.synthesized = False

    @property
    def terminal(self) -> bool:
        return bool(self.attrs.get("terminal"))

    @property
    def latency(self) -> Optional[float]:
        v = self.attrs.get("latency_seconds")
        try:
            return float(v) if v is not None else None
        except (TypeError, ValueError):
            return None


class RequestTrace:
    """Every attempt + coordinator point sharing one trace_id."""

    __slots__ = ("trace_id", "request", "attempts", "coord")

    def __init__(self, trace_id: str, request: str):
        self.trace_id = trace_id
        self.request = request
        self.attempts: List[Attempt] = []
        self.coord: List[Dict[str, Any]] = []

    @property
    def terminal_attempt(self) -> Optional[Attempt]:
        done = [a for a in self.attempts if a.terminal and a.dur is not None]
        # Worst case a duplicate dispatch double-terminates; prefer the ok
        # one (the first-writer-wins winner is not knowable span-side).
        done.sort(key=lambda a: (a.status != "ok", a.number))
        return done[0] if done else None

    @property
    def latency(self) -> Optional[float]:
        a = self.terminal_attempt
        return a.latency if a is not None else None

    @property
    def ttft(self) -> Optional[float]:
        a = self.terminal_attempt
        if a is None:
            return None
        v = a.attrs.get("ttft_seconds")
        try:
            return float(v) if v is not None else None
        except (TypeError, ValueError):
            return None


def assemble(paths: Sequence[str]) -> Dict[str, RequestTrace]:
    """trace_id → :class:`RequestTrace` over one or more event streams.

    Request-kind spans carry their trace context as attrs; coordinator
    points (route / respool / lease_expired / shed / respond / claim) join
    by their ``request`` attr — via the request→trace map the spans
    establish, so a trace survives streams whose points predate the span
    (claim fires before submit)."""
    traces: Dict[str, RequestTrace] = {}
    by_request: Dict[str, str] = {}
    attempts_by_span: Dict[Tuple[str, Any], Attempt] = {}
    pending_points: List[Tuple[str, Dict[str, Any]]] = []
    for path in paths:
        stream = os.path.basename(path)
        try:
            events = list(trace_mod.iter_events(path))
        except OSError:
            continue
        for ev in events:
            kind, name = ev.get("kind"), str(ev.get("name", ""))
            if kind == "request" and name == REQUEST_SPAN:
                if ev.get("ev") == "start":
                    a = Attempt(ev)
                    tid = str(a.attrs.get("trace", "")) or a.request
                    if not a.request:
                        continue
                    tr = traces.get(tid)
                    if tr is None:
                        tr = traces[tid] = RequestTrace(tid, a.request)
                    by_request.setdefault(a.request, tid)
                    tr.attempts.append(a)
                    attempts_by_span[(stream, ev.get("id"))] = a
                elif ev.get("ev") == "end":
                    a = attempts_by_span.get((stream, ev.get("id")))
                    if a is None:
                        continue
                    a.dur = float(ev.get("dur", 0.0) or 0.0)
                    a.status = ev.get("status")
                    a.error = ev.get("error")
                    a.attrs.update(ev.get("attrs") or {})
                    a.synthesized = bool(
                        (ev.get("attrs") or {}).get("synthesized"))
            elif ev.get("ev") == "point":
                if name == FIRST_TOKEN_POINT:
                    a = attempts_by_span.get((stream, ev.get("parent")))
                    if a is not None:
                        a.first_token = ev
                elif name in _COORD_POINTS:
                    req = str((ev.get("attrs") or {}).get("request", ""))
                    if req:
                        pending_points.append((req, ev))
    for req, ev in pending_points:
        tid = by_request.get(req)
        if tid is None:
            # Routed/shed but never admitted anywhere (or the admitting
            # replica died before its span start flushed): the request is
            # still a trace, anchored by its coordinator points alone.
            tid = by_request[req] = f"(request {req})"
            traces[tid] = RequestTrace(tid, req)
        traces[tid].coord.append(ev)
    for tr in traces.values():
        tr.attempts.sort(key=lambda a: (a.number, a.t0))
        tr.coord.sort(key=lambda ev: (float(ev.get("t", 0.0)),
                                      int(ev.get("seq", 0))))
    return traces


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.3f}s"


def _critical_path(a: Attempt) -> List[Tuple[str, float]]:
    """(segment, seconds) decomposition of the terminal attempt: queue wait
    → prefill+first decode step (TTFT minus queue) → decode tail.  The
    waterfall's critical-path attribution — largest segment first."""
    try:
        queue = float(a.attrs.get("queue_seconds", 0.0) or 0.0)
        latency = float(a.attrs.get("latency_seconds", 0.0) or 0.0)
    except (TypeError, ValueError):
        return []
    segs: List[Tuple[str, float]] = []
    ttft = a.attrs.get("ttft_seconds")
    try:
        ttft = float(ttft) if ttft is not None else None
    except (TypeError, ValueError):
        ttft = None
    if ttft is not None and latency >= ttft >= queue:
        segs = [("queue", queue), ("prefill+first-token", ttft - queue),
                ("decode-tail", latency - ttft)]
    elif latency >= queue:
        segs = [("queue", queue), ("decode", latency - queue)]
    return sorted(segs, key=lambda s: -s[1])


def render(tr: RequestTrace) -> str:
    """One trace's waterfall: coordinator hops, per-attempt lifecycle with
    TTFT, and critical-path attribution.  Times are per-stream monotonic
    (each process's clock starts at its own zero) — offsets within one
    attempt are exact; cross-process rows are ordered, not aligned."""
    term = tr.terminal_attempt
    head = (f"trace {tr.trace_id}  request {tr.request}"
            f"  attempts {len(tr.attempts)}")
    if term is not None:
        head += (f"  status {term.status}"
                 f"  finish {term.attrs.get('finish', '?')}"
                 f"  latency {_fmt_s(term.latency)}"
                 f"  ttft {_fmt_s(tr.ttft)}")
    elif tr.attempts:
        head += "  status open"
    lines = [head]
    for ev in tr.coord:
        attrs = ev.get("attrs") or {}
        who = ev.get("worker") or "coord"
        brief = ", ".join(
            f"{k}={attrs[k]}" for k in ("worker", "attempt", "holder",
                                        "reason", "duplicate", "synthetic")
            if k in attrs)
        lines.append(f"  [{who}] t={float(ev.get('t', 0.0)):.3f}"
                     f"  {ev.get('name')}  {brief}")
    for a in tr.attempts:
        who = a.worker or "?"
        if a.dur is None:
            lines.append(f"  attempt {a.number} @{who}: OPEN "
                         "(span never ended — live or lost stream)")
            continue
        if a.synthesized:
            lines.append(
                f"  attempt {a.number} @{who}: DIED mid-flight after "
                f"{a.dur:.3f}s (closed by fleet merge, synthesized error)")
            continue
        seg = (f"queue {_fmt_s(a.attrs.get('queue_seconds'))}"
               if a.attrs.get("queue_seconds") is not None else "")
        ft = (f"  ttft {_fmt_s(a.attrs.get('ttft_seconds'))}"
              if a.attrs.get("ttft_seconds") is not None else "")
        err = f"  error {a.error}" if a.error else ""
        lines.append(
            f"  attempt {a.number} @{who}: {a.status}"
            f"  finish {a.attrs.get('finish', '?')}  {seg}{ft}"
            f"  total {_fmt_s(a.latency)}  steps {a.attrs.get('steps', '?')}"
            f"{err}")
        if a.terminal:
            segs = _critical_path(a)
            total = sum(s for _n, s in segs) or None
            if segs and total:
                lines.append("    critical path: " + ", ".join(
                    f"{n} {s / total:.0%} ({s:.3f}s)" for n, s in segs))
    return "\n".join(lines)


def slowest(traces: Dict[str, RequestTrace], n: int) -> List[RequestTrace]:
    done = [t for t in traces.values() if t.latency is not None]
    done.sort(key=lambda t: -(t.latency or 0.0))
    return done[:max(0, n)]


# ---------------------------------------------------------------------------
# CLI (``trace``) and the fixture selfcheck.
# ---------------------------------------------------------------------------

def default_fixture_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "tests", "fixtures", "obs", "serve_fleet")


def selfcheck(fixture_dir: Optional[str] = None) -> int:
    """Render the committed serve-fleet fixture's slowest-5 waterfalls and
    assert the request-trace invariants parse end-to-end: every terminal
    attempt chain is attempt-ordered under ONE trace_id, and every ok
    terminal attempt that emitted tokens carries a parseable TTFT."""
    d = fixture_dir or default_fixture_dir()
    paths = find_event_files(d)
    if not paths:
        print(f"tbx trace --selfcheck: no event streams under {d}",  # tbx: TBX009-ok — CLI stderr contract (selfcheck failure)
              file=sys.stderr)
        return 1
    traces = assemble(paths)
    errors: List[str] = []
    with_spans = {t.request: t for t in traces.values() if t.attempts}
    if not with_spans:
        errors.append(f"{d}: no request-kind spans in the fixture — "
                      "regenerate it via tools/make_fleet_fixture.py")
    for tr in with_spans.values():
        tids = {str(a.attrs.get("trace", "")) for a in tr.attempts}
        if len(tids) > 1:
            errors.append(f"request {tr.request}: attempts span multiple "
                          f"trace ids {sorted(tids)}")
        nums = [a.number for a in tr.attempts]
        if nums != sorted(nums):
            errors.append(f"request {tr.request}: attempt chain out of "
                          f"order: {nums}")
        term = tr.terminal_attempt
        if term is None:
            continue
        emitted = term.attrs.get("emitted", term.attrs.get("steps", 0))
        if term.status == "ok" and emitted:
            if tr.ttft is None:
                errors.append(f"request {tr.request}: completed decode "
                              "without a parseable ttft_seconds")
            elif term.first_token is None and len(paths) == 1:
                errors.append(f"request {tr.request}: ttft attr present "
                              f"but no {FIRST_TOKEN_POINT} point parented "
                              "to the terminal span")
    for tr in slowest(traces, 5):
        print(render(tr))  # tbx: TBX009-ok — CLI stdout contract (waterfall render)
        print()  # tbx: TBX009-ok — CLI stdout contract (waterfall separator)
    if errors:
        for e in errors:
            print(f"tbx trace --selfcheck: {e}", file=sys.stderr)  # tbx: TBX009-ok — CLI stderr contract (selfcheck violations)
        return 1
    n_term = sum(1 for t in traces.values()
                 if t.terminal_attempt is not None)
    print(f"tbx trace --selfcheck: OK ({len(traces)} traces, "  # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict)
          f"{n_term} terminal, {len(paths)} stream(s))")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace",
        description="Per-request waterfalls from a serve run's event "
                    "streams: attempt chains across replica death, TTFT, "
                    "critical-path attribution.")
    ap.add_argument("dir", nargs="?",
                    help="results dir (or a direct _events.jsonl path)")
    ap.add_argument("--request", default=None, metavar="RID",
                    help="render one request id's trace")
    ap.add_argument("--trace", default=None, metavar="TID",
                    help="render one trace_id (e.g. a tbx top exemplar)")
    ap.add_argument("--slowest", type=int, default=10, metavar="N",
                    help="render the N slowest completed traces (default)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="gate the committed serve_fleet fixture")
    args = ap.parse_args(argv)
    if args.selfcheck:
        return selfcheck(args.dir)
    if not args.dir:
        ap.error("a results dir is required (or --selfcheck)")
    paths = find_event_files(args.dir)
    if not paths:
        print(f"tbx trace: no _events*.jsonl under {args.dir}",  # tbx: TBX009-ok — CLI stderr contract (missing input)
              file=sys.stderr)
        return 2
    traces = assemble(paths)
    if args.trace is not None:
        tr = traces.get(args.trace)
        if tr is None:
            print(f"tbx trace: trace {args.trace!r} not found "  # tbx: TBX009-ok — CLI stderr contract (lookup miss)
                  f"({len(traces)} traces in {len(paths)} stream(s))",
                  file=sys.stderr)
            return 1
        print(render(tr))  # tbx: TBX009-ok — CLI stdout contract (waterfall render)
        return 0
    if args.request is not None:
        hits = [t for t in traces.values() if t.request == args.request]
        if not hits:
            print(f"tbx trace: request {args.request!r} not found",  # tbx: TBX009-ok — CLI stderr contract (lookup miss)
                  file=sys.stderr)
            return 1
        for tr in hits:
            print(render(tr))  # tbx: TBX009-ok — CLI stdout contract (waterfall render)
        return 0
    picked = slowest(traces, args.slowest)
    if not picked:
        print(f"tbx trace: no completed request traces in {args.dir} "  # tbx: TBX009-ok — CLI stderr contract (empty result)
              f"({len(traces)} open/route-only)", file=sys.stderr)
        return 1
    for tr in picked:
        print(render(tr))  # tbx: TBX009-ok — CLI stdout contract (waterfall render)
        print()  # tbx: TBX009-ok — CLI stdout contract (waterfall separator)
    return 0


if __name__ == "__main__":
    sys.exit(main())
