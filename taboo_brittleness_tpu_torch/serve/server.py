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
    responses/<id>.json            the response (atomic write; in fleet mode
                                   an os.link first-writer-wins commit)
    streams/<id>.jsonl             per-token emission stream (append-mode
                                   whole-line JSONL; the gateway's SSE
                                   source), removed with the claim
    cancel/<id>.json               client-cancel tombstone (the gateway
                                   writes one on a disconnect; observed
                                   between steps, which for the speculative
                                   engine are verify blocks)
    _progress.json                 serving-mode heartbeat (obs.progress)
    _events.jsonl                  span/point stream (obs.trace)
    _metrics.jsonl                 windowed metrics with the SLO burn block
    _serve.json                    exit summary, with the step programs'
                                   registry stats (``aot``) and, for the
                                   speculative engine, the ``spec`` block

Replica-fleet mode (``serve-fleet`` / ``serve.replica``) adds the leased
ownership layout of ``runtime.fleet``, applied to requests::

    assigned/<wid>/<id>.a<k>.json  request routed to replica <wid> at
                                   attempt k (wrapper: id / attempt /
                                   excluded / request payload)
    claimed/<id>.a<k>.<holder>.json  ...claimed by one replica incarnation
                                   (rename; exactly one winner)
    leases/<id>.a<k>.json          time-bounded ownership, renewed by the
                                   replica's ServeLeaseKeeper thread; an
                                   expired lease lets the coordinator
                                   RE-SPOOL the request with the dead
                                   holder excluded
    responses/_duplicates/         first-writer-wins losers (benign)
    _stop                          the coordinator's "goal reached" marker

A replica's telemetry lands in per-worker files (``_progress.<wid>.json``,
``_events.<wid>.jsonl``, ``_metrics.<wid>.jsonl``, ``_serve.<wid>.json``)
as the sweep fleet's workers' do, so ``supervise(worker_id=)`` and the
fleet merge apply unchanged.  Both packages' fleet spools are
interchangeable too.

Request schema: ``{"id": str, "prompt": str, "scenario": str,
"seed": int?, "max_new_tokens": int?, "word": str?, "priority": int?,
"deadline_at": float?}``; ``scenario`` names an entry of the server's
scenario table (``scheduler.default_scenarios``), ``word`` one of a
multi-word engine's resident words (a word the engine does not hold is
rejected explicitly).

Lifecycle contracts:

- **Claim-then-respond.**  A request is claimed by RENAME (crash-atomic);
  the response is written atomically.  On startup the single server
  re-queues any claimed-but-unanswered request, so a killed incarnation
  drops nothing; a replica skips that, since lease expiry is its rescue.
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

**The tensor-parallel A/B gate** (:func:`tp_selfcheck`, ``serve
--selfcheck``): one mixed-scenario request batch through a ``--tp 2``
server (two ranks) and a ``--tp 2 --tp-no-shard`` server; the response
streams must agree.  A tp engine's summary carries its ``mesh`` record and
the ``aot`` block says whether its steps replay graphs (``graphed``; a
rank of a multi-rank mesh steps eagerly, with the reason).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import flightrec, reqtrace
from taboo_brittleness_tpu_torch.obs.progress import (
    PROGRESS_FILENAME,
    ProgressReporter,
)
from taboo_brittleness_tpu_torch.obs.trace import EVENTS_FILENAME
from taboo_brittleness_tpu_torch.runtime import resilience, supervise
from taboo_brittleness_tpu_torch.runtime.fleet import (
    LeaseStore,
    exclusive_commit,
    holder_token,
    lease_seconds,
)
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
ASSIGNED_DIRNAME = "assigned"
CLAIMED_DIRNAME = "claimed"
LEASES_DIRNAME = "leases"
DUPLICATES_DIRNAME = "_duplicates"
STOP_MARKER = "_stop"
STREAMS_DIRNAME = "streams"
CANCEL_DIRNAME = "cancel"

#: ``RequestSpool.put`` size guard: the serialized payload may not exceed
#: this many bytes (``TBX_SPOOL_MAX_BYTES``).
SPOOL_MAX_BYTES_ENV = "TBX_SPOOL_MAX_BYTES"
DEFAULT_SPOOL_MAX_BYTES = 256 * 1024

#: How often the serve loop sweeps resolved ``.claimed`` tombstones.
_GC_INTERVAL_S = 2.0

_ASSIGNED_RE = re.compile(r"(.+)\.a(\d+)\.json$")
_CLAIMED_RE = re.compile(r"(.+)\.a(\d+)\.(.+)\.json$")


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

    ``fleet=True`` grows the replica-fleet layout: routed assignments,
    holder-stamped leased claims, first-writer-wins responses (the
    ``runtime.fleet`` ownership machinery applied to requests)."""

    def __init__(self, root: str, *, fleet: bool = False):
        self.root = root
        self.fleet = bool(fleet)
        self.requests_dir = os.path.join(root, REQUESTS_DIRNAME)
        self.responses_dir = os.path.join(root, RESPONSES_DIRNAME)
        self.assigned_dir = os.path.join(root, ASSIGNED_DIRNAME)
        self.claimed_dir = os.path.join(root, CLAIMED_DIRNAME)
        self.leases_dir = os.path.join(root, LEASES_DIRNAME)
        self.duplicates_dir = os.path.join(self.responses_dir,
                                           DUPLICATES_DIRNAME)
        self.streams_dir = os.path.join(root, STREAMS_DIRNAME)
        self.cancel_dir = os.path.join(root, CANCEL_DIRNAME)
        self.lease_store = LeaseStore(self.leases_dir)
        self._last_gc: Optional[float] = None
        dirs = [self.requests_dir, self.responses_dir, self.streams_dir,
                self.cancel_dir]
        if self.fleet:
            dirs += [self.assigned_dir, self.claimed_dir, self.leases_dir,
                     self.duplicates_dir]
        for d in dirs:
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


    # -- stop marker (fleet coordinator -> replicas) -------------------------

    def write_stop(self) -> None:
        atomic_json_dump({"stopped": True},
                         os.path.join(self.root, STOP_MARKER))

    def clear_stop(self) -> None:
        try:
            os.unlink(os.path.join(self.root, STOP_MARKER))
        except OSError:
            pass

    def stopped(self) -> bool:
        return os.path.exists(os.path.join(self.root, STOP_MARKER))

    # -- fleet coordinator side (serve.replica) ------------------------------

    def route_intake(self, rid: str) -> Optional[Dict[str, Any]]:
        """Claim one intake file for ROUTING (coordinator side): rename to
        the ``.claimed`` tombstone (exactly one winner), return the payload.
        The tombstone stays until the response lands (then removed), so a
        coordinator crash between route and assign is recoverable: the
        resume pass re-routes claimed-but-unassigned requests."""
        path = os.path.join(self.requests_dir, f"{rid}.json")
        payload = self._parse(path)
        if payload is None or "prompt" not in payload:
            return None
        try:
            os.replace(path, path + CLAIMED_SUFFIX)
        except OSError:
            return None
        return payload

    def intake_ids(self) -> List[str]:
        """Unrouted intake request ids (parseable, prompt present)."""
        try:
            names = sorted(os.listdir(self.requests_dir))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue
            payload = self._parse(os.path.join(self.requests_dir, name))
            if payload is not None and "prompt" in payload:
                out.append(str(payload.get("id") or name[:-5]))
        return out

    def assign(self, rid: str, payload: Dict[str, Any], worker: str, *,
               attempt: int = 0, excluded: Any = ()) -> str:
        """Issue (or re-spool) one request to ``assigned/<worker>/``.
        Atomic write; re-spools are new files at ``attempt + 1`` carrying
        the holders excluded from reclaiming it."""
        d = os.path.join(self.assigned_dir, worker)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{rid}.a{int(attempt)}.json")
        atomic_json_dump({"v": 1, "id": rid, "attempt": int(attempt),
                          "excluded": sorted(set(excluded)),
                          "request": payload}, path)
        return path

    def assigned_entries(self, worker: Optional[str] = None,
                         ) -> List[Dict[str, Any]]:
        """Parsed assignment wrappers (``_path`` / ``_worker`` added), for
        one replica or all of them."""
        try:
            workers = [worker] if worker else sorted(
                os.listdir(self.assigned_dir))
        except OSError:
            return []
        out = []
        for wid in workers:
            d = os.path.join(self.assigned_dir, wid)
            try:
                names = sorted(os.listdir(d))
            except OSError:
                continue
            for name in names:
                if not _ASSIGNED_RE.match(name):
                    continue
                rec = self._parse(os.path.join(d, name))
                if rec is not None:
                    rec["_path"] = os.path.join(d, name)
                    rec["_worker"] = wid
                    out.append(rec)
        return out

    def claimed_markers(self) -> List[Dict[str, Any]]:
        """``[{id, attempt, holder, _path}]`` parsed from claimed/ names."""
        try:
            names = sorted(os.listdir(self.claimed_dir))
        except OSError:
            return []
        out = []
        for name in names:
            m = _CLAIMED_RE.match(name)
            if m:
                out.append({"id": m.group(1), "attempt": int(m.group(2)),
                            "holder": m.group(3),
                            "_path": os.path.join(self.claimed_dir, name)})
        return out

    # -- fleet replica side --------------------------------------------------

    def claim_assigned(self, worker: str, holder: str,
                       limit: int) -> List[Dict[str, Any]]:
        """Claim up to ``limit`` of this replica's assignments by rename
        (the ``serve.claim`` fault site fires per attempt).  Assignments of
        already-answered requests are removed on the way; assignments that
        exclude this holder (a restarted predecessor's re-spools) are left
        for the coordinator to reroute."""
        if limit <= 0:
            return []
        d = os.path.join(self.assigned_dir, worker)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        out: List[Dict[str, Any]] = []
        for name in names:
            if len(out) >= limit:
                break
            if not _ASSIGNED_RE.match(name):
                continue
            src = os.path.join(d, name)
            rec = self._parse(src)
            if rec is None:
                continue                    # mid-flight assign; later poll
            rid = str(rec.get("id", ""))
            if not rid:
                continue
            if self.get_response(rid) is not None:
                # A stale re-spooled copy of an answered request: remove it
                # instead of decoding it again.
                try:
                    os.unlink(src)
                except OSError:
                    pass
                continue
            if holder in rec.get("excluded", ()):
                continue
            resilience.fire("serve.claim", request=rid, worker=worker,
                            holder=holder)
            dst = os.path.join(
                self.claimed_dir,
                f"{rid}.a{int(rec.get('attempt', 0))}.{holder}.json")
            try:
                os.replace(src, dst)
            except OSError:
                continue                    # raced / vanished; scan on
            flightrec.record("serve.claim", request=rid,
                             attempt=int(rec.get("attempt", 0)),
                             worker=worker)
            out.append(rec)
        return out

    def respond_exclusive(self, resp: Response, *, holder: str) -> bool:
        """First-writer-wins response commit (``os.link``, through
        ``fleet.exclusive_commit``): duplicate completions from re-spooled
        or raced replicas park in ``responses/_duplicates/``.  The
        ``serve.respond`` fault site fires BEFORE the link: a ``die`` here
        is the replica killed at its first commit."""
        resilience.fire("serve.respond", request=resp.id,
                        worker=current_worker_id() or "", holder=holder)
        won = exclusive_commit(self.response_path(resp.id), resp.to_dict(),
                               holder=holder,
                               duplicates_dir=self.duplicates_dir)
        flightrec.record("serve.respond", request=resp.id, won=won)
        return won

    def release_claimed(self, rid: str, attempt: int, holder: str) -> None:
        """Post-response cleanup: drop the lease and the claimed marker."""
        self.lease_store.drop_lease(rid, attempt)
        try:
            os.unlink(os.path.join(self.claimed_dir,
                                   f"{rid}.a{attempt}.{holder}.json"))
        except OSError:
            pass

    def duplicate_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.duplicates_dir)
                       if n.endswith(".json"))
        except OSError:
            return 0


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


class ServeLeaseKeeper:
    """ONE renewal thread for ALL of a replica's held request leases (the
    per-unit ``runtime.fleet.LeaseKeeper`` generalized to a holder of many
    requests: a replica holds up to ``queue_limit`` leases).

    The thread touches files only, never the card: it may run beside a
    replica's graph replays and captures.  Renewal is fail-open: a failed
    renewal (transient IO, an injected ``serve.lease_renew`` fault) lets
    that request's lease expire and the coordinator re-spool it; first
    writer wins makes the double completion a counted duplicate.  A
    ``die``-mode fault at the renewal site kills the whole replica.
    ``max_gap_s`` is the longest time between two renewal passes, the
    measure of how far the serving loop starves this thread."""

    def __init__(self, store: LeaseStore, *, holder: str, worker: str,
                 lease_s: float):
        self.store = store
        self.holder = holder
        self.worker = worker
        self.lease_s = float(lease_s)
        self.max_gap_s = 0.0
        self._held: Dict[Tuple[str, int], float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, rid: str, attempt: int) -> None:
        """Start leasing one claimed request (the first lease is written
        here, so ownership is on disk before the request is admitted)."""
        # tbx: wallclock-ok — cross-process lease timestamps use the epoch
        now = time.time()
        with self._lock:
            self._held[(rid, int(attempt))] = now
        self.store.write_lease(rid, int(attempt), self.holder, self.worker,
                               self.lease_s, claimed_at=now)

    def remove(self, rid: str, attempt: int) -> None:
        with self._lock:
            self._held.pop((rid, int(attempt)), None)

    def start(self) -> "ServeLeaseKeeper":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"serve-lease-{self.worker}",
                daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(0.1, self.lease_s / 3.0)
        last = time.monotonic()
        while not self._stop.wait(interval):
            now = time.monotonic()
            self.max_gap_s = max(self.max_gap_s, now - last)
            last = now
            with self._lock:
                held = dict(self._held)
            for (rid, attempt), claimed_at in sorted(held.items()):
                try:
                    resilience.fire("serve.lease_renew", request=rid,
                                    worker=self.worker, holder=self.holder)
                    self.store.write_lease(rid, attempt, self.holder,
                                           self.worker, self.lease_s,
                                           claimed_at=claimed_at)
                    flightrec.record("serve.lease_renew", request=rid,
                                     attempt=attempt)
                except Exception:  # noqa: BLE001 — fail-open; expiry is benign
                    pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        # Any lease still held at shutdown is dropped so the coordinator
        # re-spools at once instead of waiting out the expiry.
        with self._lock:
            held = sorted(self._held)
            self._held.clear()
        for rid, attempt in held:
            self.store.drop_lease(rid, attempt)


@dataclasses.dataclass
class ServeResult:
    exit_code: int
    status: str             # done | drained
    completed: int
    steps: int
    #: Replica mode: the longest gap between two lease renewal passes.
    lease_max_gap_s: Optional[float] = None


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
    lease_s: Optional[float] = None,
    idle_sleep=time.sleep,
    clock=time.monotonic,
) -> ServeResult:
    """The serve loop: poll the spool -> admit -> step -> respond, under
    the drain contract.  Returns when ``max_requests`` responses exist on
    disk (exit 0) or a drain completes (exit 75); runs forever otherwise.

    ``max_requests`` counts responses ON DISK, prior incarnations'
    included, so a supervised relaunch resumes toward the same goal.

    ``replica=True`` is fleet mode (launched by ``serve.replica`` under
    ``supervise(worker_id=)``): instead of claiming raw intake the loop
    claims its ``assigned/<wid>/`` routed requests under time-bounded
    leases (one :class:`ServeLeaseKeeper`, started after the warm start,
    renews them all), commits responses first-writer-wins, and exits 0
    when the coordinator writes the ``_stop`` marker.  Startup recovery is
    skipped: a dead replica's claims come back through lease expiry and
    the coordinator's re-spool, never through self-rescue."""
    os.makedirs(output_dir, exist_ok=True)
    spool = RequestSpool(output_dir, fleet=replica)
    # A worker's telemetry is per-worker (the sweep fleet's contract), so N
    # replicas share the directory and the supervisor watches its file.
    wid = current_worker_id()
    events_name = (EVENTS_FILENAME if wid is None
                   else f"_events.{wid}.jsonl")
    progress_name = (PROGRESS_FILENAME if wid is None
                     else f"_progress.{wid}.json")
    tracer = (obs.activate(os.path.join(output_dir, events_name),
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
            os.path.join(output_dir, progress_name),
            total_words=0, run_id=tracer.run_id, tracer=tracer).start()
        reporter.serving_update(in_flight=0,
                                completed=spool.completed_count())
        # Live telemetry: the windowed metrics spool, the SLO burn engine
        # it feeds, and the crash flight recorder.  The burn block rides
        # each heartbeat, where the fleet router and the gateway read it.
        try:
            flightrec.configure(output_dir, worker_id=wid)
            slo_engine = slo.SloEngine()
            recorder = timeseries.TimeseriesRecorder(
                os.path.join(output_dir, timeseries.metrics_filename(wid)),
                slo_engine=slo_engine)
            recorder.start()
        except Exception:  # noqa: BLE001 — telemetry must never block serving
            recorder = None
            slo_engine = None

    worker = wid or "serve"
    holder = holder_token(worker) if replica else None
    keeper: Optional[ServeLeaseKeeper] = None
    held: Dict[str, int] = {}       # rid -> attempt (this holder's claims)

    # Per-token stream files, default on; TBX_SERVE_STREAM=0 turns them off.
    streams: Optional[TokenStreamWriter] = None
    if os.environ.get("TBX_SERVE_STREAM", "1") == "1":
        streams = TokenStreamWriter(spool,
                                    decode=getattr(engine, "tok", None)
                                    and engine.tok.decode)

    def _respond(resp: Response) -> None:
        """Plain atomic write for the single server; first-writer-wins
        commit plus lease and claim release for a replica."""
        if streams is not None:
            streams.finish(resp.id)
        if not replica:
            spool.respond(resp)
            return
        attempt = held.pop(resp.id, 0)
        won = spool.respond_exclusive(resp, holder=holder)
        if keeper is not None:
            keeper.remove(resp.id, attempt)
        spool.release_claimed(resp.id, attempt, holder)
        obs.event("serve.respond", request=resp.id, attempt=attempt,
                  duplicate=not won,
                  **({"trace": resp.trace_id} if resp.trace_id else {}))

    sched = SlotScheduler(engine, queue_limit=queue_limit,
                          lens_target_id=lens_target_id,
                          on_complete=_respond, clock=clock,
                          on_token=((lambda req, tok, n:
                                     streams.emit(req.id, tok, n))
                                    if streams is not None else None))
    warm = engine.warm_start()
    obs.event("serve.warm_start", **{k: v for k, v in warm.items()
                                     if k in ("source", "seconds")})
    if replica:
        # After the warm start: the keeper thread makes no CUDA call, but
        # nothing beside a capture should run that needs not to.
        keeper = ServeLeaseKeeper(
            spool.lease_store, holder=holder, worker=worker,
            lease_s=lease_s if lease_s is not None
            else lease_seconds()).start()

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
                # An expired request never costs a decode slot.
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

    def _claim_into_scheduler() -> None:
        limit = queue_limit - sched.queue_depth
        if not replica:
            for payload in spool.claim(limit):
                _take(payload)
            return
        try:
            wrappers = spool.claim_assigned(worker, holder, limit)
        except Exception as exc:  # noqa: BLE001 — serve.claim fault / IO
            obs.event("serve.claim_failed", worker=worker,
                      error=f"{type(exc).__name__}: {exc}"[:200])
            return
        for rec in wrappers:
            rid = str(rec.get("id"))
            attempt = int(rec.get("attempt", 0))
            held[rid] = attempt
            keeper.add(rid, attempt)
            payload = dict(rec.get("request") or {})
            ctx = reqtrace.parse(payload)
            if ctx is not None and int(ctx.get("attempt", 0)) != attempt:
                # Keep the context honest against the wrapper (the re-spool
                # writer bumps both; a hand-written assign might not).
                payload[reqtrace.CTX_KEY] = ctx = reqtrace.for_attempt(
                    ctx, attempt)
            obs.event("serve.claim", request=rid, attempt=attempt,
                      **({"trace": ctx.get("trace_id")} if ctx else {}))
            _take(payload)

    # Resume: a predecessor's claimed-but-unanswered requests come first.
    # A replica skips this: its recovery route is lease expiry.
    if not replica:
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
                "single-server recovery only runs at startup; use the "
                "replica fleet (serve-fleet) for lease-expiry rescue",
                name="serve.claimed_unanswered", request=rid)

    status, exit_code = "done", 0
    try:
        while True:
            if supervise.drain_requested() and not sched.draining:
                sched.drain()
            # Cancel tombstones, observed between steps (for the
            # speculative engine: between verify blocks).  Owned requests
            # release their slot now; unclaimed ones are answered at claim.
            for rid in spool.canceled_ids():
                sched.cancel(rid)
            if not sched.draining:
                _claim_into_scheduler()
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
            if spool.gc_claimed() is not None and not replica:
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
            if (replica and sched.idle and spool.stopped()
                    and not spool.assigned_entries(worker)):
                break
            if (max_requests is not None and sched.idle
                    and completed >= max_requests):
                break
            if not stepped:
                idle_sleep(poll_s)
    finally:
        if keeper is not None:
            keeper.stop()
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
        if getattr(engine, "mesh", None) is not None:
            summary["mesh"] = {**dict(engine.mesh.shape),
                               "backend": engine.mesh.backend,
                               "reason": engine.mesh.reason,
                               "staging": engine.mesh.staging}
        if tuned is not None:
            summary["autotune"] = {**tuned.to_dict(), "plan": tuned.plan}
        if getattr(engine, "speculative", False):
            summary["spec"] = {**engine.accept_stats(),
                               "scenarios": sched.accept_summary()}
        if replica:
            summary["replica"] = worker
            summary["duplicate_responses"] = spool.duplicate_count()
            summary["lease_max_gap_s"] = round(keeper.max_gap_s, 6)
        # Fleet replicas write per-worker summaries (N of them share the
        # directory); the coordinator's _serve_fleet.json owns the merge.
        summary_name = (SERVE_SUMMARY_FILENAME if wid is None
                        else f"_serve.{wid}.json")
        try:
            atomic_json_dump(summary, os.path.join(output_dir, summary_name))
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
                       steps=engine.steps,
                       lease_max_gap_s=(keeper.max_gap_s
                                        if keeper is not None else None))


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
    record = getattr(engine, "graph_record", None)
    if record is not None:
        out.update(record())
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel A/B selfcheck (the `serve --selfcheck` gate).
# ---------------------------------------------------------------------------

_TP_MIX_SCENARIOS = ("chat", "sae_ablate", "forcing")

#: Lens probabilities of the two arms agree within this (the sharded
#: readout merges per-shard partials; JAX's gate uses the same bound).
TP_LENS_ATOL = 1e-6


def tp_selfcheck(output_dir: str, *, tp: int = 2, n_requests: int = 9,
                 max_wall_s: float = 600.0,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """The mesh-mode exactness gate: spool the SAME mixed-scenario request
    batch into two ``serve --synthetic`` servers, one tensor-parallel over
    ``tp`` ranks and one unsharded from the identical config and params
    (``--tp-no-shard``); run both to completion and compare the response
    streams (tokens, text, finish, scenario; lens probabilities within
    :data:`TP_LENS_ATOL`), with zero registry misses on the sharded arm.
    Pure subprocess orchestration; ``device`` goes to both servers."""
    import subprocess
    import sys as _sys

    arms = {"tp": ["--tp", str(int(tp))],
            "ref": ["--tp", str(int(tp)), "--tp-no-shard"]}
    spools: Dict[str, RequestSpool] = {}
    procs: Dict[str, subprocess.Popen] = {}
    env = {**os.environ, "TBX_OBS_PROGRESS_S": "0.2"}
    env.pop("TBX_SERVE_TP", None)          # the --tp flag is the contract
    dev = ["--device", str(device)] if device else []
    for arm, flags in arms.items():
        arm_dir = os.path.join(output_dir, arm)
        spool = RequestSpool(arm_dir)
        for i in range(int(n_requests)):
            spool.put({
                "id": f"r{i:03d}",
                "prompt": ("Give me a hint" if i % 2
                           else "Give me a clue about the word"),
                "scenario": _TP_MIX_SCENARIOS[i % len(_TP_MIX_SCENARIOS)],
                "seed": i})
        spools[arm] = spool
        procs[arm] = subprocess.Popen(
            [_sys.executable, "-m", "taboo_brittleness_tpu_torch", "serve",
             "--synthetic", "--output-dir", arm_dir,
             "--slots", "4", "--max-new-tokens", "6",
             "--max-requests", str(int(n_requests)),
             "--poll", "0.05", *flags, *dev],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    problems: List[str] = []
    for arm, proc in procs.items():
        try:
            rc = proc.wait(timeout=max_wall_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            problems.append(f"{arm} arm timed out after {max_wall_s:.0f}s")
            continue
        if rc != 0:
            problems.append(f"{arm} arm exited {rc}")

    compared = 0
    if not problems:
        for i in range(int(n_requests)):
            rid = f"r{i:03d}"
            a = spools["tp"].get_response(rid)
            b = spools["ref"].get_response(rid)
            if a is None or b is None:
                problems.append(f"{rid}: missing response "
                                f"(tp={a is not None} ref={b is not None})")
                continue
            for field in ("ok", "finish", "tokens", "text", "scenario"):
                if a.get(field) != b.get(field):
                    problems.append(f"{rid}.{field}: tp={a.get(field)!r} "
                                    f"ref={b.get(field)!r}")
            pa = a.get("lens_probs") or []
            pb = b.get("lens_probs") or []
            if len(pa) != len(pb) or any(
                    abs(x - y) > TP_LENS_ATOL for x, y in zip(pa, pb)):
                problems.append(f"{rid}.lens_probs diverged: {pa} vs {pb}")
            compared += 1

    summary: Dict[str, Any] = {}
    try:
        with open(os.path.join(output_dir, "tp",
                               SERVE_SUMMARY_FILENAME)) as f:
            summary = json.load(f)
    except (OSError, ValueError):
        problems.append("tp arm wrote no serve summary")
    aot_stats = summary.get("aot") or {}
    if int(aot_stats.get("misses", -1)) != 0:
        problems.append(f"tp arm registry misses != 0: {aot_stats}")
    mesh = summary.get("mesh") or {}
    if int(mesh.get("tp", 0)) != int(tp):
        problems.append(f"tp arm summary mesh block wrong: {mesh}")
    autotuned = summary.get("autotune") or {}
    if not autotuned.get("verdict"):
        problems.append("tp arm summary has no autotune verdict")
    return {
        "ok": not problems,
        "problems": problems,
        "compared": compared,
        "tp": int(tp),
        "mesh": mesh,
        "aot": aot_stats,
        "autotune": {k: autotuned.get(k) for k in
                     ("verdict", "source", "width", "spec_block")},
    }


def main_tp_selfcheck(*, tp: int = 2, n_requests: int = 9,
                      device: Optional[str] = None) -> int:
    """``serve --selfcheck``: run :func:`tp_selfcheck` in a temporary
    directory and print the verdict JSON; exit 0 when it holds."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="tbx-serve-tp-selfcheck-")
    try:
        verdict = tp_selfcheck(os.path.join(tmp, "ab"), tp=tp,
                               n_requests=n_requests, device=device)
        # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict)
        print(json.dumps(verdict, indent=2))
        return 0 if verdict["ok"] else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
