"""The long-lived ``serve`` process: spool intake, drain, resume.

The PyTorch port's copy of the single-server half of the JAX package's
``serve/server.py``.  Transport is a file spool, deliberately: the repo's
process-boundary contracts (atomic tmp + rename writes, resume of claimed
work, incarnation relaunch under ``supervise``) all speak filesystem, so a
server that speaks it too inherits them, and the two packages' spools are
interchangeable (a request either package's ``RequestSpool.put`` writes is
answered by either server).

Layout under ``<output_dir>``::

    requests/<id>.json             a submitted request (atomic write)
    requests/<id>.json.claimed     ...claimed by the server (rename); removed
                                   once the response exists
    responses/<id>.json            the response (atomic write)
    streams/<id>.jsonl             per-token emission stream (append-mode
                                   whole-line JSONL), removed with the claim
    cancel/<id>.json               client-cancel tombstone (observed between
                                   steps, which for the speculative engine
                                   are verify blocks)
    _progress.json                 serving-mode heartbeat (obs.progress)
    _events.jsonl                  span/point stream (obs.trace)
    _metrics.jsonl                 windowed metrics with the SLO burn block
    _serve.json                    exit summary, with the step programs'
                                   registry stats (``aot``) and, for the
                                   speculative engine, the ``spec`` block

Request schema: ``{"id": str, "prompt": str, "scenario": str,
"seed": int?, "max_new_tokens": int?, "word": str?, "priority": int?,
"deadline_at": float?}``; ``scenario`` names an entry of the server's
scenario table (``scheduler.default_scenarios``), ``word`` one of a
multi-word engine's resident words (a word the engine does not hold is
rejected explicitly).

Lifecycle contracts:

- **Claim-then-respond.**  A request is claimed by RENAME (crash-atomic);
  the response is written atomically.  On startup the server re-queues any
  claimed-but-unanswered request, so a killed incarnation drops nothing.
- **Drain.**  A latched SIGTERM/SIGINT (``runtime.supervise``) flips the
  scheduler to draining: the current step finishes, nothing new is
  admitted, in-flight and already-queued sessions run to completion and
  get their responses, then :func:`serve_forever` returns exit 75
  (``EX_TEMPFAIL``): ``supervise`` relaunches and the next incarnation
  picks up the rest of the spool.
- **Heartbeat.**  ``_progress.json`` carries ``workload: "serve"`` with
  in-flight / completed / last-step age and the SLO burn block, so an
  IDLE server is never classified as wedged (``supervise._wedge_reason``)
  and a crashed server's exit 1 is never taken for a sweep's quarantine.

Not ported here: the replica-fleet layout and its methods (assigned /
claimed / leases, first-writer-wins responses, ``ServeLeaseKeeper``,
``runtime/fleet.py``) with ``replica=True``, which raises; the per-worker
telemetry file names that go with it; and the tensor-parallel selfcheck.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import flightrec, reqtrace
from taboo_brittleness_tpu_torch.obs.progress import (
    PROGRESS_FILENAME,
    ProgressReporter,
)
from taboo_brittleness_tpu_torch.obs.trace import EVENTS_FILENAME
from taboo_brittleness_tpu_torch.runtime import supervise
from taboo_brittleness_tpu_torch.runtime.resilience import (
    atomic_json_dump,
    current_worker_id,
)
from taboo_brittleness_tpu_torch.serve import autotune
from taboo_brittleness_tpu_torch.serve.engine import ServeEngine
from taboo_brittleness_tpu_torch.serve.scheduler import (
    FINISH_CANCELED,
    FINISH_DEADLINE,
    REJECT_UNKNOWN_SCENARIO,
    Request,
    Response,
    Scenario,
    SlotScheduler,
)

SERVE_SUMMARY_FILENAME = "_serve.json"
REQUESTS_DIRNAME = "requests"
RESPONSES_DIRNAME = "responses"
CLAIMED_SUFFIX = ".claimed"
STREAMS_DIRNAME = "streams"
CANCEL_DIRNAME = "cancel"

#: ``RequestSpool.put`` size guard: the serialized payload may not exceed
#: this many bytes (``TBX_SPOOL_MAX_BYTES``).
SPOOL_MAX_BYTES_ENV = "TBX_SPOOL_MAX_BYTES"
DEFAULT_SPOOL_MAX_BYTES = 256 * 1024

#: How often the serve loop sweeps resolved ``.claimed`` tombstones.
_GC_INTERVAL_S = 2.0


def spool_max_bytes() -> int:
    try:
        return int(os.environ.get(SPOOL_MAX_BYTES_ENV,
                                  DEFAULT_SPOOL_MAX_BYTES))
    except ValueError:
        return DEFAULT_SPOOL_MAX_BYTES


class SpoolValidationError(ValueError):
    """A payload :meth:`RequestSpool.put` refuses.

    ``reason`` is the typed cause: ``"oversized"`` (serialized payload over
    the ``TBX_SPOOL_MAX_BYTES`` cap) or ``"invalid"`` (not a JSON object
    with a non-empty string ``prompt``)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason


class RequestSpool:
    """Filesystem request/response exchange (see the module docstring).
    ``fleet=True`` (the replica-fleet layout) is not ported and raises."""

    def __init__(self, root: str, *, fleet: bool = False):
        if fleet:
            raise NotImplementedError(
                "the replica-fleet spool (serve-fleet) is not ported yet "
                "(ROADMAP Queue 1 item 3b); run a single server")
        self.root = root
        self.requests_dir = os.path.join(root, REQUESTS_DIRNAME)
        self.responses_dir = os.path.join(root, RESPONSES_DIRNAME)
        self.streams_dir = os.path.join(root, STREAMS_DIRNAME)
        self.cancel_dir = os.path.join(root, CANCEL_DIRNAME)
        self._last_gc: Optional[float] = None
        for d in (self.requests_dir, self.responses_dir, self.streams_dir,
                  self.cancel_dir):
            os.makedirs(d, exist_ok=True)

    # -- client side --------------------------------------------------------

    def put(self, payload: Dict[str, Any]) -> str:
        """Submit one request (loadgen / an external client); returns the
        id.  Mints the request-trace context (``obs.reqtrace``) unless the
        client carries one.  Raises :class:`SpoolValidationError` for a
        payload that is not a JSON object with a non-empty string
        ``prompt`` (``"invalid"``) or whose serialization exceeds
        ``TBX_SPOOL_MAX_BYTES`` (``"oversized"``)."""
        if not isinstance(payload, dict):
            raise SpoolValidationError(
                "invalid", "request payload must be a JSON object")
        prompt = payload.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise SpoolValidationError(
                "invalid",
                "request payload needs a non-empty string 'prompt'")
        rid = str(payload.get("id") or uuid.uuid4().hex[:12])
        payload, _ctx, _minted = reqtrace.ensure({**payload, "id": rid})
        try:
            blob = json.dumps(payload).encode("utf-8")
        except (TypeError, ValueError) as exc:
            raise SpoolValidationError(
                "invalid", f"payload not JSON-serializable: {exc}") from exc
        cap = spool_max_bytes()
        if len(blob) > cap:
            raise SpoolValidationError(
                "oversized",
                f"serialized request is {len(blob)} bytes > {cap} cap")
        atomic_json_dump(payload,
                         os.path.join(self.requests_dir, f"{rid}.json"))
        return rid

    def response_path(self, rid: str) -> str:
        return os.path.join(self.responses_dir, f"{rid}.json")

    def stream_path(self, rid: str) -> str:
        """Per-request token emission file (append-mode whole-line JSONL,
        written by :class:`TokenStreamWriter`)."""
        return os.path.join(self.streams_dir, f"{rid}.jsonl")

    def cancel(self, rid: str) -> str:
        """Drop a cancellation tombstone (idempotent).  The server observes
        it between steps: an unclaimed request is answered ``canceled`` at
        claim, an in-flight one releases its slot at the next step."""
        path = os.path.join(self.cancel_dir, f"{rid}.json")
        # tbx: wallclock-ok — tombstone timestamps cross processes (epoch)
        atomic_json_dump({"id": rid, "canceled_at": time.time()}, path)
        return path

    def is_canceled(self, rid: str) -> bool:
        return os.path.exists(os.path.join(self.cancel_dir, f"{rid}.json"))

    def canceled_ids(self) -> List[str]:
        try:
            names = os.listdir(self.cancel_dir)
        except OSError:
            return []
        return sorted(n[:-5] for n in names if n.endswith(".json"))

    def get_response(self, rid: str) -> Optional[Dict[str, Any]]:
        return self._parse(self.response_path(rid))

    # -- server side --------------------------------------------------------

    def _parse(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def claim(self, limit: int) -> List[Dict[str, Any]]:
        """Claim up to ``limit`` pending requests (rename = crash-atomic
        ownership).  A torn or unparseable file is left in place: the
        writer's atomic rename means it is mid-flight, not corrupt."""
        if limit <= 0:
            return []
        try:
            names = sorted(os.listdir(self.requests_dir))
        except OSError:
            return []
        out: List[Dict[str, Any]] = []
        for name in names:
            if len(out) >= limit:
                break
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.requests_dir, name)
            payload = self._parse(path)
            if payload is None or "prompt" not in payload:
                continue
            try:
                os.replace(path, path + CLAIMED_SUFFIX)
            except OSError:
                continue            # raced another pickup / vanished
            out.append(payload)
        return out

    def _claimed(self) -> List[tuple]:
        """``(path, rid, payload)`` of every ``.claimed`` tombstone."""
        try:
            names = sorted(os.listdir(self.requests_dir))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(CLAIMED_SUFFIX):
                continue
            path = os.path.join(self.requests_dir, name)
            payload = self._parse(path)
            rid = str((payload or {}).get("id")
                      or name[:-len(CLAIMED_SUFFIX)].rsplit(".json", 1)[0])
            out.append((path, rid, payload))
        return out

    def recover(self) -> List[Dict[str, Any]]:
        """Claimed-but-unanswered requests of a dead predecessor
        incarnation, re-queued at startup so a kill drops nothing."""
        return [payload for _, rid, payload in self._claimed()
                if payload is not None and "prompt" in payload
                and self.get_response(str(payload.get("id"))) is None]

    def respond(self, resp: Response) -> None:
        atomic_json_dump(resp.to_dict(), self.response_path(resp.id))

    def completed_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.responses_dir)
                       if n.endswith(".json"))
        except OSError:
            return 0

    def claimed_unanswered(self) -> List[str]:
        """Ids of ``.claimed`` tombstones with no response yet: in flight
        here, or ORPHANED by a process that died (the mid-run audit
        subtracts the scheduler's active set to tell them apart)."""
        return [rid for _, rid, _ in self._claimed()
                if rid and self.get_response(rid) is None]

    def gc_claimed(self, *, force: bool = False) -> Optional[int]:
        """Remove ``.claimed`` tombstones (and cancel tombstones and token
        streams) whose response exists.  Throttled to every
        ``_GC_INTERVAL_S`` unless ``force`` (the exit path sweeps
        unconditionally); returns the number removed, or None when the
        throttle skipped the sweep."""
        now = time.monotonic()
        if (not force and self._last_gc is not None
                and now - self._last_gc < _GC_INTERVAL_S):
            return None
        self._last_gc = now
        removed = 0
        for path, rid, _ in self._claimed():
            if rid and self.get_response(rid) is not None:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        # A reader tailing a stream holds an open fd, so the unlink never
        # truncates it (POSIX); the response file is authoritative anyway.
        for d, suffix in ((self.cancel_dir, ".json"),
                          (self.streams_dir, ".jsonl")):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if (name.endswith(suffix)
                        and self.get_response(name[:-len(suffix)]) is not None):
                    try:
                        os.unlink(os.path.join(d, name))
                        removed += 1
                    except OSError:
                        pass
        return removed


class TokenStreamWriter:
    """Per-request token emission files under ``streams/``: the scheduler's
    ``on_token`` hook appends one ``{"n", "tok", "piece"}`` line per emitted
    token and flushes, so a tailing reader only sees whole lines.  One open
    file per in-flight request, closed when the request resolves."""

    def __init__(self, spool: RequestSpool, decode=None):
        self.spool = spool
        self.decode = decode            # tok.decode, for text pieces
        self._files: Dict[str, Any] = {}

    def emit(self, rid: str, tok: int, n: int) -> None:
        f = self._files.get(rid)
        if f is None:
            f = open(self.spool.stream_path(rid), "a")
            self._files[rid] = f
        line: Dict[str, Any] = {"n": int(n), "tok": int(tok)}
        if self.decode is not None:
            try:
                line["piece"] = self.decode([int(tok)])
            except Exception:  # noqa: BLE001 — pieces are cosmetic; ids rule
                pass
        f.write(json.dumps(line) + "\n")
        f.flush()

    def finish(self, rid: str) -> None:
        f = self._files.pop(rid, None)
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def close(self) -> None:
        for rid in list(self._files):
            self.finish(rid)


@dataclasses.dataclass
class ServeResult:
    exit_code: int
    status: str             # done | drained
    completed: int
    steps: int


def _to_request(payload: Dict[str, Any],
                scenarios: Dict[str, Scenario]) -> Optional[Request]:
    name = str(payload.get("scenario", "chat"))
    sc = scenarios.get(name)
    if sc is None:
        return None
    max_new = payload.get("max_new_tokens")
    if max_new is not None:
        sc = dataclasses.replace(sc, max_new_tokens=int(max_new))
    word = payload.get("word")
    try:
        priority = int(payload.get("priority", 0) or 0)
    except (TypeError, ValueError):
        priority = 0
    try:
        deadline_at = (float(payload["deadline_at"])
                       if payload.get("deadline_at") is not None else None)
    except (TypeError, ValueError):
        deadline_at = None
    return Request(id=str(payload.get("id") or uuid.uuid4().hex[:12]),
                   prompt=str(payload.get("prompt", "")),
                   scenario=sc, seed=int(payload.get("seed", 0) or 0),
                   word=str(word) if word is not None else None,
                   priority=priority, deadline_at=deadline_at,
                   trace=reqtrace.parse(payload))


def serve_forever(
    engine: ServeEngine,
    scenarios: Dict[str, Scenario],
    output_dir: str,
    *,
    lens_target_id: int = -1,
    queue_limit: int = 64,
    max_requests: Optional[int] = None,
    poll_s: float = 0.05,
    replica: bool = False,
    idle_sleep=time.sleep,
    clock=time.monotonic,
) -> ServeResult:
    """The serve loop: poll the spool -> admit -> step -> respond, under
    the drain contract.  Returns when ``max_requests`` responses exist on
    disk (exit 0) or a drain completes (exit 75); runs forever otherwise.

    ``max_requests`` counts responses ON DISK, prior incarnations'
    included, so a supervised relaunch resumes toward the same goal.
    ``replica=True`` (a serve-fleet replica) is not ported and raises."""
    if replica:
        raise NotImplementedError(
            "serve --replica (the replica fleet) is not ported yet "
            "(ROADMAP Queue 1 item 3b); run a single server")
    os.makedirs(output_dir, exist_ok=True)
    spool = RequestSpool(output_dir)
    wid = current_worker_id()
    tracer = (obs.activate(os.path.join(output_dir, EVENTS_FILENAME),
                           run_id=uuid.uuid4().hex[:12])
              if obs.enabled() else None)
    run_span = None
    reporter = None
    recorder = None
    slo_engine = None
    if tracer is not None:
        from taboo_brittleness_tpu_torch.obs import slo, timeseries
        from taboo_brittleness_tpu_torch.runtime.resilience import (
            current_incarnation,
        )

        inc = current_incarnation()
        run_span = tracer.span(
            "serve", kind="run", pipeline="serve",
            slots=engine.ec.slots, scenarios=sorted(scenarios),
            **({"incarnation": inc} if inc else {}),
            **({"worker": wid} if wid else {}))
        reporter = ProgressReporter(
            os.path.join(output_dir, PROGRESS_FILENAME),
            total_words=0, run_id=tracer.run_id, tracer=tracer).start()
        reporter.serving_update(in_flight=0,
                                completed=spool.completed_count())
        # Live telemetry: the windowed metrics spool, the SLO burn engine
        # it feeds, and the crash flight recorder.  The burn block rides
        # each heartbeat.
        try:
            flightrec.configure(output_dir)
            slo_engine = slo.SloEngine()
            recorder = timeseries.TimeseriesRecorder(
                os.path.join(output_dir, timeseries.METRICS_FILENAME),
                slo_engine=slo_engine)
            recorder.start()
        except Exception:  # noqa: BLE001 — telemetry must never block serving
            recorder = None
            slo_engine = None

    # Per-token stream files, default on; TBX_SERVE_STREAM=0 turns them off.
    streams: Optional[TokenStreamWriter] = None
    if os.environ.get("TBX_SERVE_STREAM", "1") == "1":
        streams = TokenStreamWriter(spool,
                                    decode=getattr(engine, "tok", None)
                                    and engine.tok.decode)

    def _respond(resp: Response) -> None:
        if streams is not None:
            streams.finish(resp.id)
        spool.respond(resp)

    sched = SlotScheduler(engine, queue_limit=queue_limit,
                          lens_target_id=lens_target_id,
                          on_complete=_respond, clock=clock,
                          on_token=((lambda req, tok, n:
                                     streams.emit(req.id, tok, n))
                                    if streams is not None else None))
    warm = engine.warm_start()
    obs.event("serve.warm_start", **{k: v for k, v in warm.items()
                                     if k in ("source", "seconds")})

    # The slot width is solved after warm start, when the resident
    # footprint (params, bank, widened cache) and the programs exist, and
    # caps ADMISSION only (the step keeps its shape); fail-open.
    tuned: Optional[autotune.AutotunePlan] = None
    try:
        tuned = autotune.solve(engine)
        sched.set_slot_limit(tuned.width)
        obs.event("serve.autotune", **tuned.to_dict())
    except Exception as exc:  # noqa: BLE001 — never a correctness dependency
        obs.event("serve.autotune",
                  verdict="error", error=f"{type(exc).__name__}: {exc}"[:200])

    def _slots_block() -> Dict[str, Any]:
        block = dict(sched.occupancy())
        block["verdict"] = tuned.verdict if tuned is not None else "off"
        return block

    warned_pretrace = [False]

    def _take(payload: Dict[str, Any]) -> None:
        """A claimed request ALWAYS gets a response: submit it, or answer a
        rejection (unknown scenario, over-capacity prompt or budget,
        canceled, expired) explicitly instead of dropping it.  A payload
        without a trace context gets a ``synthetic`` one here, with a
        one-shot warning."""
        payload, ctx, minted = reqtrace.ensure(payload, synthetic=True)
        if minted and not warned_pretrace[0]:
            warned_pretrace[0] = True
            obs.warn(
                "[serve] request without a trace context (pre-trace "
                "client/spool?) — minted a synthetic one at claim; "
                "responses stay traceable from this hop on",
                name="serve.pretrace_request",
                request=str(payload.get("id")))
        rid = str(payload.get("id"))
        typed = dict(trace_id=ctx.get("trace_id"),
                     attempt=int(ctx.get("attempt", 0)), replica=wid)
        if spool.is_canceled(rid):
            _respond(Response(id=rid, ok=False,
                              scenario=str(payload.get("scenario", "chat")),
                              finish=FINISH_CANCELED, **typed))
            return
        deadline = payload.get("deadline_at")
        if deadline is not None:
            try:
                # tbx: wallclock-ok — deadlines are cross-process epoch stamps
                expired = time.time() > float(deadline)
            except (TypeError, ValueError):
                expired = False
            if expired:
                _respond(Response(
                    id=rid, ok=False,
                    scenario=str(payload.get("scenario", "chat")),
                    finish=FINISH_DEADLINE,
                    error="deadline expired before claim", **typed))
                return
        req = _to_request(payload, scenarios)
        if req is None:
            _respond(Response(
                id=rid, ok=False, scenario=str(payload.get("scenario")),
                finish="rejected", reject_reason=REJECT_UNKNOWN_SCENARIO,
                error="unknown scenario", **typed))
            return
        if not sched.submit(req):
            reason = sched.last_reject_reason
            _respond(Response(
                id=req.id, ok=False, scenario=req.scenario.name,
                finish="rejected", replica=wid, reject_reason=reason,
                error="admission rejected "
                      f"({reason or 'capacity envelope or draining'})",
                trace_id=req.trace_id, attempt=req.attempt))

    # Resume: a predecessor's claimed-but-unanswered requests come first.
    for payload in spool.recover():
        _take(payload)

    warned_orphans: set = set()

    def _audit_orphans() -> None:
        """Warn once per request about a ``.claimed`` file with no response
        that this scheduler does not own: some other (dead) process
        claimed it, and startup recovery never sees it."""
        active = set(sched.active_ids())
        for rid in spool.claimed_unanswered():
            if rid in active or rid in warned_orphans:
                continue
            warned_orphans.add(rid)
            obs.warn(
                f"[serve] request {rid!r} is claimed but unanswered and "
                "not owned by this server — claimed by a dead process? "
                "single-server recovery only runs at startup",
                name="serve.claimed_unanswered", request=rid)

    status, exit_code = "done", 0
    try:
        while True:
            if supervise.drain_requested() and not sched.draining:
                sched.drain()
            # Cancel tombstones, observed between steps (for the
            # speculative engine: between verify blocks).
            for rid in spool.canceled_ids():
                sched.cancel(rid)
            if not sched.draining:
                for payload in spool.claim(queue_limit - sched.queue_depth):
                    _take(payload)
            stepped = False
            resolved = 0
            if sched.in_flight or sched.queue_depth:
                # Publish in-flight BEFORE stepping: if the step wedges,
                # the heartbeat already says there is work, so the
                # supervisor's classifier does not read it as idle.
                if reporter is not None:
                    reporter.serving_update(
                        in_flight=sched.in_flight,
                        completed=spool.completed_count(),
                        queued=sched.queue_depth, slots=_slots_block())
                resolved = len(sched.step())
                stepped = True
            completed = spool.completed_count()
            if spool.gc_claimed() is not None:
                _audit_orphans()
            if reporter is not None:
                reporter.serving_update(
                    in_flight=sched.in_flight, completed=completed,
                    queued=sched.queue_depth, stepped=stepped,
                    latency=(sched.latency_percentiles() if resolved
                             else None),
                    slo=(slo_engine.last_block() if slo_engine is not None
                         else None),
                    slots=_slots_block())
            if sched.draining and sched.idle:
                status, exit_code = "drained", supervise.EXIT_DRAINED
                break
            if (max_requests is not None and sched.idle
                    and completed >= max_requests):
                break
            if not stepped:
                idle_sleep(poll_s)
    finally:
        if streams is not None:
            streams.close()
        spool.gc_claimed(force=True)
        summary: Dict[str, Any] = {
            "status": status,
            "completed_responses": spool.completed_count(),
            "engine_steps": engine.steps,
            "admitted": sched.admitted,
            "rejected": sched.rejected,
            "quarantined": sched.quarantined,
            "canceled": sched.canceled,
            "deadline_expired": sched.deadline_expired,
            "aot": _step_program_stats(engine),
        }
        if tuned is not None:
            summary["autotune"] = {**tuned.to_dict(), "plan": tuned.plan}
        if getattr(engine, "speculative", False):
            summary["spec"] = {**engine.accept_stats(),
                               "scenarios": sched.accept_summary()}
        try:
            atomic_json_dump(summary, os.path.join(output_dir,
                                                   SERVE_SUMMARY_FILENAME))
        except OSError:
            pass
        if recorder is not None:
            # Final window + exit record BEFORE the reporter's last write,
            # so the closing heartbeat's slo block is the final window's.
            try:
                recorder.stop()
            except Exception:  # noqa: BLE001 — fail-open
                pass
        if reporter is not None:
            reporter.serving_update(
                in_flight=sched.in_flight,
                completed=spool.completed_count(),
                latency=sched.latency_percentiles(),
                slo=(slo_engine.last_block() if slo_engine is not None
                     else None),
                slots=_slots_block())
            reporter.stop(status="preempted" if status == "drained"
                          else "done")
        if run_span is not None:
            if status == "drained":
                run_span.set(drained=True)
            run_span.end()
        if tracer is not None:
            obs.deactivate(tracer)
    return ServeResult(exit_code=exit_code, status=status,
                       completed=spool.completed_count(),
                       steps=engine.steps)


def _step_program_stats(engine: ServeEngine) -> Dict[str, Any]:
    """The registry stats of the engine's step program (``serve.step``,
    ``serve.step.multi``, or the speculative engine's verify), the
    zero-miss gate of the summary; a speculative engine adds its draft
    program's under ``draft``."""
    from taboo_brittleness_tpu_torch.runtime import aot

    stats = aot.stats()
    out = dict(stats.get(getattr(engine, "aot_name", "serve.step"), {}))
    draft = getattr(engine, "aot_draft", None)
    if draft is not None:
        out["draft"] = dict(stats.get(draft, {}))
    return out
