"""Replica-fleet serving: leased request ownership and burn-rate routing.

The PyTorch port's copy of the JAX package's ``serve/replica.py``.  A
single ``serve`` is one resident engine per spool directory: a killed or
wedged server takes every claimed request down with it until a restart.
This module applies the sweep fleet's ownership machinery
(``runtime.fleet``: time-bounded leases, expiry -> re-issue,
first-writer-wins commits, per-worker supervision) to serve REQUESTS:

- **N supervised replicas.**  Each replica is a ``serve --replica`` child
  (resident engine and scheduler) under ``supervise(worker_id=wid)``, with
  per-worker ``_progress.<wid>.json`` / ``_events.<wid>.jsonl`` /
  ``_metrics.<wid>.jsonl``, wedge detection and bounded restarts.
- **Leased claims.**  A replica claims its routed assignments by rename
  and renews ``leases/<id>.a<k>.json`` from one keeper thread
  (``server.ServeLeaseKeeper``).  A replica's death stops renewal; the
  coordinator expires the lease and RE-SPOOLS the request to a live
  replica with the dead holder excluded.  Responses commit
  first-writer-wins (``os.link``), so duplicate completions are benign.
- **Burn-rate admission router.**  The coordinator reads each replica's
  ``slo`` burn block and heartbeat age off ``_progress.<wid>.json`` and
  steers new requests toward healthy replicas, weighted by fast-burn
  headroom (``weight = 1 - fast / TBX_ROUTER_BURN_CAP``).  When every live
  replica burns past the cap, intake is SHED with a typed rejection
  (``all-replicas-burning``).  A stale or absent heartbeat weighs zero: a
  dead or restarting replica gets no new work until it heartbeats again.
- **Drain.**  SIGTERM on the coordinator latches the shared drain flag;
  each per-replica supervisor forwards it, replicas finish in-flight work
  and exit 75, and the coordinator exits 75 itself.  Unclaimed
  assignments stay on disk and the next coordinator re-routes them.

One round of the coordinator (route, lease-expiry scan, orphaned claims,
recovery clock) is :meth:`FleetCoordinator.round`, which
:func:`run_serve_fleet` calls in its loop and which a caller that hosts a
replica in its own process may call from a thread of its own.

Fault sites ``serve.claim`` / ``serve.lease_renew`` / ``serve.respond``
(``TABOO_FAULT_PLAN``) make it chaos-provable: :func:`selfcheck` kills one
replica at its first response commit and asserts every request is
answered exactly once through the lease-expiry -> re-spool path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import reqtrace
from taboo_brittleness_tpu_torch.obs.progress import read_progress
from taboo_brittleness_tpu_torch.runtime import fleet as fleet_mod
from taboo_brittleness_tpu_torch.runtime import supervise
from taboo_brittleness_tpu_torch.runtime.resilience import (
    RetryPolicy,
    atomic_json_dump,
)
from taboo_brittleness_tpu_torch.serve.scheduler import (
    REJECT_ALL_REPLICAS_BURNING,
    REJECT_FLEET_SATURATED,
    Response,
)
from taboo_brittleness_tpu_torch.serve.server import CLAIMED_SUFFIX, RequestSpool

__all__ = [
    "BurnRouter", "FleetCoordinator", "SERVE_FLEET_SUMMARY_FILENAME",
    "ServeFleetResult", "main_selfcheck", "reroute_orphans",
    "run_serve_fleet", "selfcheck",
]

SERVE_FLEET_SUMMARY_FILENAME = "_serve_fleet.json"

#: The coordinator's holder identity for shed (router-rejected) responses.
ROUTER_HOLDER = "router"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def router_burn_cap() -> float:
    """Fast-burn ceiling (``TBX_ROUTER_BURN_CAP``): at this multiple of the
    SLO budget a replica's admission weight reaches zero and it counts as
    burning.  2.0 = twice the budgeted burn rate, the usual fast-window
    page threshold."""
    return max(0.1, _env_float("TBX_ROUTER_BURN_CAP", 2.0))


# ---------------------------------------------------------------------------
# The burn-rate admission router.
# ---------------------------------------------------------------------------


class BurnRouter:
    """Steers intake toward healthy replicas using ONLY what every serve
    heartbeat publishes (``_progress.<wid>.json``): liveness (status and
    staleness), the ``slo`` burn block, and queue occupancy.

    Per replica: ``fast`` = the worst fast-window burn over the heartbeat's
    serve SLO series; ``weight = max(0, 1 - fast / burn_cap)``.  Routing is
    seeded weighted-random (``random.Random(f"tbx-router:{seed}")``, as in
    the JAX package, so one seed and one view pick the same replica in both
    packages).  With the heartbeat's ``slots`` block (the autotuner's
    admission width) the weight is scaled by ``free / width``; a replica
    both full and backlogged counts as SATURATED, and when every live
    replica is saturated intake is shed as ``fleet-saturated``."""

    def __init__(self, output_dir: str, replica_ids: Sequence[str], *,
                 burn_cap: Optional[float] = None, seed: int = 0):
        self.output_dir = output_dir
        self.replica_ids = list(replica_ids)
        self.burn_cap = (float(burn_cap) if burn_cap is not None
                         else router_burn_cap())
        self._rng = random.Random(f"tbx-router:{seed}")
        self.routed: Dict[str, int] = {}
        self.sheds = 0

    def view(self) -> Dict[str, Dict[str, Any]]:
        """One admission snapshot per replica (a pure read)."""
        out: Dict[str, Dict[str, Any]] = {}
        for wid in self.replica_ids:
            p = read_progress(
                os.path.join(self.output_dir, f"_progress.{wid}.json"),
                missing_ok=True)
            alive = p.get("status") == "running" and not p.get("stale")
            fast = 0.0
            for key, cell in (p.get("slo") or {}).items():
                if not str(key).startswith("serve"):
                    continue
                try:
                    fast = max(fast, float((cell or {}).get("fast", 0.0)))
                except (TypeError, ValueError):
                    continue
            burning = bool(alive and fast >= self.burn_cap)
            weight = 0.0 if not alive else max(
                0.0, 1.0 - fast / self.burn_cap)
            serving = p.get("serving") or {}
            queued = int(serving.get("queued", 0) or 0)
            slots = serving.get("slots") or {}
            saturated = False
            free = width = None
            if slots:
                try:
                    width = max(0, int(slots.get("width", 0) or 0))
                    free = max(0, int(slots.get("free", 0) or 0))
                except (TypeError, ValueError):
                    free = width = None
            if width:
                weight *= min(1.0, free / width)
                saturated = bool(alive and free == 0 and queued > 0)
            out[wid] = {
                "alive": alive,
                "burning": burning,
                "saturated": saturated,
                "fast_burn": round(fast, 4),
                "weight": round(weight, 4),
                "heartbeat_age": p.get("age_seconds"),
                "in_flight": int(serving.get("in_flight", 0) or 0),
                "queued": queued,
                "completed": int(serving.get("completed_requests", 0) or 0),
                **({"slots_width": width, "slots_free": free}
                   if width is not None else {}),
            }
        return out

    @staticmethod
    def any_alive(view: Dict[str, Dict[str, Any]]) -> bool:
        return any(v["alive"] for v in view.values())

    @staticmethod
    def all_burning(view: Dict[str, Dict[str, Any]]) -> bool:
        """True when there ARE live replicas and every one is past the cap
        (the typed-shed condition).  No live replica is NOT burning: that is
        startup or a rolling restart, and intake waits."""
        live = [v for v in view.values() if v["alive"]]
        return bool(live) and all(v["burning"] for v in live)

    @staticmethod
    def all_saturated(view: Dict[str, Dict[str, Any]]) -> bool:
        """True when there ARE live replicas and every one reports its
        admission width full WITH a backlog (the occupancy twin of
        :meth:`all_burning`)."""
        live = [v for v in view.values() if v["alive"]]
        return bool(live) and all(v.get("saturated") for v in live)

    def pick(self, view: Optional[Dict[str, Dict[str, Any]]] = None, *,
             exclude: Sequence[str] = ()) -> Optional[str]:
        """Weighted choice among live, non-excluded replicas with headroom;
        None when nothing is routable (the caller tells wait from shed with
        :meth:`any_alive` / :meth:`all_burning`)."""
        view = self.view() if view is None else view
        weighted = {w: v["weight"] for w, v in view.items()
                    if v["alive"] and v["weight"] > 0 and w not in exclude}
        if not weighted:
            return None
        total = sum(weighted.values())
        r = self._rng.random() * total
        acc = 0.0
        chosen = None
        for w in sorted(weighted):
            acc += weighted[w]
            if chosen is None and r <= acc:
                chosen = w
        chosen = chosen or sorted(weighted)[-1]
        self.routed[chosen] = self.routed.get(chosen, 0) + 1
        return chosen


# ---------------------------------------------------------------------------
# Coordinator.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeFleetResult:
    """Coordinator outcome.  ``status`` / ``reissue_chains`` /
    ``lease_expiries`` / ``duplicate_commits`` match ``fleet.FleetResult``
    so ``fleet.merge_ledgers`` folds the re-spool chains unchanged."""

    status: str                    # done | drained | stalled
    exit_code: int
    requests_total: int
    completed: int
    shed: int
    respooled: int
    lease_expiries: int
    duplicate_commits: int
    recovery_seconds: Optional[float]
    wall_seconds: float
    replicas: List[Dict[str, Any]]
    reissue_chains: Dict[str, List[Dict[str, Any]]]
    router: Dict[str, Any]

    @property
    def shed_rate(self) -> float:
        return round(self.shed / self.requests_total, 4) \
            if self.requests_total else 0.0

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["version"] = 1
        out["shed_rate"] = self.shed_rate
        return out


def reroute_orphans(spool: RequestSpool, router: BurnRouter, worker: str, *,
                    view: Optional[Dict[str, Dict[str, Any]]] = None,
                    ob: Any = None) -> int:
    """Move a PERMANENTLY dead replica's unclaimed assignments to live
    replicas (nothing a drained or budget-exhausted replica never claimed
    is lost).  Returns how many moved; stops early when no live target
    exists (retried next round)."""
    moved = 0
    for rec in spool.assigned_entries(worker):
        target = router.pick(view, exclude=(worker,))
        if target is None:
            break
        rid = str(rec.get("id"))
        spool.assign(rid, dict(rec.get("request") or {}), target,
                     attempt=int(rec.get("attempt", 0)),
                     excluded=rec.get("excluded", ()))
        try:
            os.unlink(rec["_path"])
        except OSError:
            pass
        moved += 1
        if ob is not None:
            ob.event("serve_fleet.reroute", request=rid, worker=target,
                     from_worker=worker)
    return moved


def _tombstone_payloads(spool: RequestSpool) -> Dict[str, Dict[str, Any]]:
    """Payloads of routed-but-unanswered intake tombstones: the resume
    pass re-routes any that never reached assigned/ or claimed/."""
    try:
        names = sorted(os.listdir(spool.requests_dir))
    except OSError:
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    for name in names:
        if not name.endswith(CLAIMED_SUFFIX):
            continue
        payload = spool._parse(os.path.join(spool.requests_dir, name))
        if payload is None or "prompt" not in payload:
            continue
        rid = str(payload.get("id") or "")
        if rid and spool.get_response(rid) is None:
            out[rid] = payload
    return out


def _shed(spool: RequestSpool, rid: str, payload: Dict[str, Any],
          reason: str = REJECT_ALL_REPLICAS_BURNING) -> None:
    """Typed load-shed response (the client sees WHY), committed
    first-writer-wins like any response so a racing late replica
    completion stays benign."""
    ctx = reqtrace.parse(payload)
    spool.respond_exclusive(
        Response(id=rid, ok=False,
                 scenario=str(payload.get("scenario", "chat")),
                 finish="rejected",
                 reject_reason=reason,
                 error=f"admission rejected ({reason})",
                 trace_id=ctx.get("trace_id") if ctx else None,
                 attempt=int(ctx.get("attempt", 0)) if ctx else 0),
        holder=ROUTER_HOLDER)


class _NoObserver:
    def event(self, name: str, **attrs: Any) -> None:
        obs.event(name, **attrs)


class FleetCoordinator:
    """The coordinator's state and one round of its loop: (1) route intake
    and the resume queue by burn weight (shed typed when every live replica
    burns or is saturated; wait when none is live), (2) expire leases and
    re-spool with the dead holder excluded, (3) re-spool orphaned claims
    (a claimed marker with no lease, older than a lease), (5) the recovery
    clock.  (4), a dead replica's backlog, is :meth:`reroute_dead`.
    ``ob`` is the sweep observer whose events the rounds emit (default:
    the active tracer's ``obs.event``).  ``pins`` maps request ids to the
    replica that must take them: a pinned request skips the router and
    waits in intake until its replica is alive (the chaos selfcheck pins
    one request to the replica its fault kills)."""

    def __init__(self, spool: RequestSpool, router: BurnRouter, *,
                 lease_s: float, ob: Any = None,
                 pins: Optional[Dict[str, str]] = None):
        self.spool = spool
        self.router = router
        self.lease_s = float(lease_s)
        self.ob = ob if ob is not None else _NoObserver()
        self.pins = dict(pins or {})
        self.issued: Dict[str, int] = {}          # rid -> latest attempt
        self.reissue_chains: Dict[str, List[Dict[str, Any]]] = {}
        self.reissued_ids: set = set()
        self.rerouted_dead: set = set()
        self.lease_expiries = 0
        self.respooled = 0
        self.shed = 0
        self.first_expiry_mono: Optional[float] = None
        self.recovery_seconds: Optional[float] = None
        # Resume pass: a prior coordinator's routed-but-unassigned
        # tombstones (a crash between route_intake and assign) go back into
        # the route queue.
        known = ({e["id"] for e in spool.assigned_entries()}
                 | {m["id"] for m in spool.claimed_markers()})
        self.reroute_queue: Dict[str, Dict[str, Any]] = {
            rid: payload for rid, payload in _tombstone_payloads(spool).items()
            if rid not in known}

    def _respool(self, rid: str, attempt: int, holder: str, lworker: str,
                 wrapper: Dict[str, Any], target: str, reason: str) -> None:
        excluded = sorted(set(wrapper.get("excluded", ())) | {holder})
        nxt = attempt + 1
        payload = dict(wrapper.get("request") or {})
        # The re-spool is a retry child under the SAME trace: bump the
        # carried context's attempt and record the dead holder.
        ctx = reqtrace.parse(payload)
        if ctx is not None:
            payload[reqtrace.CTX_KEY] = ctx = reqtrace.for_attempt(
                ctx, nxt, dead_holder=holder)
        self.spool.assign(rid, payload, target, attempt=nxt,
                          excluded=excluded)
        self.spool.release_claimed(rid, attempt, holder)
        self.issued[rid] = nxt
        self.reissued_ids.add(rid)
        self.respooled += 1
        self.reissue_chains.setdefault(rid, []).append({
            "holder": holder, "worker": lworker,
            "from_attempt": attempt, "to_attempt": nxt,
            "reason": reason,
            # tbx: wallclock-ok — serialized metadata for humans
            "at": time.time()})
        self.ob.event("serve_fleet.respool", request=rid, worker=target,
                      attempt=nxt, excluded=excluded, reason=reason,
                      dead_holder=holder,
                      **({"trace": ctx.get("trace_id")} if ctx else {}))

    def round(self, view: Optional[Dict[str, Dict[str, Any]]] = None,
              ) -> Dict[str, Dict[str, Any]]:
        """Steps (1), (2), (3) and (5) once; returns the router view used."""
        spool, router, ob = self.spool, self.router, self.ob
        now_mono = time.monotonic()
        view = router.view() if view is None else view

        # (1) Admission.
        if BurnRouter.any_alive(view):
            shed_reason = (
                REJECT_ALL_REPLICAS_BURNING
                if BurnRouter.all_burning(view)
                else REJECT_FLEET_SATURATED
                if BurnRouter.all_saturated(view) else None)
            if shed_reason is not None:
                for rid in spool.intake_ids():
                    payload = spool.route_intake(rid)
                    if payload is None:
                        continue
                    _shed(spool, rid, payload, shed_reason)
                    self.shed += 1
                    router.sheds += 1
                    self.issued.setdefault(rid, 0)
                    ob.event("serve_fleet.shed", request=rid,
                             reason=shed_reason)
            else:
                for rid, payload in list(self.reroute_queue.items()):
                    target = router.pick(view)
                    if target is None:
                        break
                    spool.assign(rid, payload, target, attempt=0)
                    self.issued.setdefault(rid, 0)
                    del self.reroute_queue[rid]
                    ob.event("serve_fleet.route", request=rid,
                             worker=target, resumed=True)
                for rid in spool.intake_ids():
                    target = self.pins.get(rid)
                    if target is not None:
                        if not view.get(target, {}).get("alive"):
                            continue    # waits for its replica
                        router.routed[target] = \
                            router.routed.get(target, 0) + 1
                    else:
                        target = router.pick(view)
                        if target is None:
                            break
                    payload = spool.route_intake(rid)
                    if payload is None:
                        continue
                    spool.assign(rid, payload, target, attempt=0)
                    self.issued.setdefault(rid, 0)
                    ob.event("serve_fleet.route", request=rid,
                             worker=target,
                             fast_burn=view[target]["fast_burn"])

        # (2) Lease expiry -> re-spool with the dead holder excluded.
        # tbx: wallclock-ok — lease deadlines are cross-process epoch
        now = time.time()
        leased_keys = set()
        for lr in spool.lease_store.leases():
            rid = str(lr.get("uid", ""))
            attempt = int(lr.get("attempt", 0))
            holder = str(lr.get("holder", ""))
            leased_keys.add((rid, attempt))
            if float(lr.get("expires_at", 0.0)) > now:
                continue
            if spool.get_response(rid) is not None:
                spool.release_claimed(rid, attempt, holder)
                continue
            marker = os.path.join(
                spool.claimed_dir, f"{rid}.a{attempt}.{holder}.json")
            wrapper = spool._parse(marker)
            if wrapper is None:
                spool.lease_store.drop_lease(rid, attempt)
                continue
            target = router.pick(view)
            if target is None:
                continue       # no live replica; the lease stays expired
            self.lease_expiries += 1
            if self.first_expiry_mono is None:
                self.first_expiry_mono = now_mono
            ob.event("serve_fleet.lease_expired", request=rid,
                     holder=holder, worker=str(lr.get("worker", "")),
                     attempt=attempt)
            self._respool(rid, attempt, holder, str(lr.get("worker", "")),
                          wrapper, target, "lease-expired")

        # (3) Orphaned claims: a claimed marker with NO lease (the replica
        # died between its claim and its first lease, or dropped its leases
        # at shutdown).  Markers younger than a lease may still be getting
        # their first lease written.
        for m in spool.claimed_markers():
            rid, attempt = m["id"], m["attempt"]
            if (rid, attempt) in leased_keys:
                continue
            if spool.get_response(rid) is not None:
                spool.release_claimed(rid, attempt, m["holder"])
                continue
            try:
                age = now - os.path.getmtime(m["_path"])
            except OSError:
                continue
            if age <= self.lease_s:
                continue
            target = router.pick(view)
            if target is None:
                continue
            if self.first_expiry_mono is None:
                self.first_expiry_mono = now_mono
            wrapper = spool._parse(m["_path"]) or {}
            ob.event("serve_fleet.lease_expired", request=rid,
                     holder=m["holder"], worker="", attempt=attempt,
                     orphaned=True)
            self.lease_expiries += 1
            self._respool(rid, attempt, m["holder"], "", wrapper, target,
                          "orphaned-claim")

        # (5) Recovery clock: first expiry -> every re-spooled request
        # answered.
        if (self.first_expiry_mono is not None
                and self.recovery_seconds is None and self.reissued_ids
                and all(spool.get_response(r) is not None
                        for r in self.reissued_ids)):
            self.recovery_seconds = now_mono - self.first_expiry_mono
            ob.event("serve_fleet.recovered",
                     requests=sorted(self.reissued_ids),
                     seconds=round(self.recovery_seconds, 3))
            obs_metrics.histogram(
                "fleet.recovery_seconds").observe(self.recovery_seconds)

        completed = spool.completed_count()
        obs_metrics.gauge("serve_fleet.completed").set(completed)
        obs_metrics.gauge("serve_fleet.shed").set(self.shed)
        return view

    def reroute_dead(self, wid: str,
                     view: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        """(4) A replica whose supervisor FINISHED is gone for good: its
        unclaimed backlog moves to live replicas."""
        if wid in self.rerouted_dead:
            return
        if (reroute_orphans(self.spool, self.router, wid, view=view,
                            ob=self.ob)
                or not self.spool.assigned_entries(wid)):
            self.rerouted_dead.add(wid)

    def goal_reached(self, max_requests: Optional[int]) -> bool:
        return (max_requests is not None
                and self.spool.completed_count() >= max_requests
                and not self.spool.intake_ids() and not self.reroute_queue)

    def unanswered(self) -> List[str]:
        return [rid for rid in sorted(self.issued)
                if self.spool.get_response(rid) is None]


def run_serve_fleet(
    output_dir: str,
    *,
    replica_argv: Callable[[str], Sequence[str]],
    n_replicas: int = 3,
    replica_ids: Optional[Sequence[str]] = None,
    replica_env: Optional[Dict[str, str]] = None,
    lease_s: Optional[float] = None,
    poll_s: float = 0.2,
    max_requests: Optional[int] = None,
    max_wall_s: Optional[float] = None,
    max_incarnations: Optional[int] = None,
    supervise_poll: Optional[float] = None,
    grace: Optional[float] = None,
    wedge_after: Optional[float] = None,
    policy: Optional[RetryPolicy] = None,
    burn_cap: Optional[float] = None,
    router_seed: int = 0,
    pins: Optional[Dict[str, str]] = None,
    sleep=time.sleep,
) -> ServeFleetResult:
    """Run N supervised serve replicas over one shared request spool until
    ``max_requests`` responses exist (status ``done``), a drain lands
    (``drained``, exit 75), or the fleet stalls (every supervisor dead or
    ``max_wall_s`` exceeded; exit 1).  ``pins``: request ids routed to
    a given replica (:class:`FleetCoordinator`).  See the module
    docstring."""
    t_start = time.monotonic()
    lease_s = float(lease_s) if lease_s is not None \
        else fleet_mod.lease_seconds()
    wids = (list(replica_ids) if replica_ids
            else [f"w{i}" for i in range(int(n_replicas))])
    spool = RequestSpool(output_dir, fleet=True)
    spool.clear_stop()
    router = BurnRouter(output_dir, wids, burn_cap=burn_cap,
                        seed=router_seed)

    results: Dict[str, supervise.SuperviseResult] = {}

    def _supervise_one(wid: str) -> None:
        results[wid] = supervise.supervise(
            list(replica_argv(wid)), output_dir, worker_id=wid,
            max_incarnations=max_incarnations, poll_interval=supervise_poll,
            grace=grace, wedge_after=wedge_after, policy=policy,
            env=dict(replica_env or {}))

    threads: List[threading.Thread] = []
    for wid in wids:
        t = threading.Thread(target=_supervise_one, args=(wid,),
                             name=f"serve-replica-{wid}", daemon=True)
        t.start()
        threads.append(t)

    status = "stalled"
    with obs.sweep_observer(output_dir, pipeline="serve-fleet") as ob:
        coord = FleetCoordinator(spool, router, lease_s=lease_s, ob=ob,
                                 pins=pins)
        ob.event("serve_fleet.start", replicas=list(wids), lease_s=lease_s,
                 **({"max_requests": max_requests}
                    if max_requests is not None else {}))
        while True:
            now_mono = time.monotonic()
            view = coord.round()
            for wid, t in zip(wids, threads):
                if not t.is_alive():
                    coord.reroute_dead(wid, view)
            if supervise.drain_requested():
                status = "drained"
                ob.mark_drained()
                break
            if coord.goal_reached(max_requests):
                status = "done"
                break
            if all(not t.is_alive() for t in threads):
                status = "stalled"
                break
            if max_wall_s is not None and now_mono - t_start > max_wall_s:
                status = "stalled"
                break
            sleep(poll_s)

        # Goal reached (or fleet abandoned): stop the replicas and wait for
        # their supervisors to fold per-worker artifacts.
        spool.write_stop()
        for t in threads:
            t.join(timeout=max(60.0, 6.0 * lease_s))

        unanswered = coord.unanswered()
        if status == "done" and unanswered:
            status = "stalled"
        ob.event("serve_fleet.exit", status=status,
                 completed=spool.completed_count(), shed=coord.shed,
                 respooled=coord.respooled,
                 lease_expiries=coord.lease_expiries,
                 duplicates=spool.duplicate_count(),
                 unanswered=len(unanswered))

    if status == "drained":
        exit_code = supervise.EXIT_DRAINED
    else:
        exit_code = 0 if status == "done" else 1
    result = ServeFleetResult(
        status=status, exit_code=exit_code,
        requests_total=len(coord.issued), completed=spool.completed_count(),
        shed=coord.shed, respooled=coord.respooled,
        lease_expiries=coord.lease_expiries,
        duplicate_commits=spool.duplicate_count(),
        recovery_seconds=(round(coord.recovery_seconds, 3)
                          if coord.recovery_seconds is not None else None),
        wall_seconds=round(time.monotonic() - t_start, 3),
        replicas=[{
            "worker_id": wid,
            "status": results[wid].status if wid in results else "unknown",
            "exit_code": (results[wid].exit_code
                          if wid in results else None),
            "incarnations": (len(results[wid].incarnations)
                             if wid in results else 0),
        } for wid in wids],
        reissue_chains=coord.reissue_chains,
        router={"burn_cap": router.burn_cap, "routed": dict(router.routed),
                "sheds": router.sheds})
    merge_serve_fleet_artifacts(output_dir, wids, result=result)
    return result


def merge_serve_fleet_artifacts(output_dir: str, worker_ids: Sequence[str],
                                *, result: ServeFleetResult) -> None:
    """Fold the per-replica streams into the run-level views (the fleet
    mergers; ServeFleetResult has the fields ``merge_ledgers`` reads) and
    write ``_serve_fleet.json``.  Fail-open: a merge failure must not eat
    the fleet's result."""
    for step in (
            lambda: fleet_mod.merge_events(output_dir, worker_ids),
            lambda: fleet_mod.merge_metrics(output_dir, worker_ids),
            lambda: fleet_mod.merge_ledgers(output_dir, worker_ids,
                                            result=result)):
        try:
            step()
        except Exception:  # noqa: BLE001 — merge is best-effort
            pass
    try:
        atomic_json_dump(result.to_dict(),
                         os.path.join(output_dir,
                                      SERVE_FLEET_SUMMARY_FILENAME))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Chaos selfcheck (``serve-fleet --selfcheck``).
# ---------------------------------------------------------------------------

_MIX_SCENARIOS = ("chat", "sae_ablate", "forcing")


def replica_command(output_dir: str, *, lease_s: float,
                    device: Optional[str] = None,
                    extra: Sequence[str] = ()) -> List[str]:
    """The argv of one synthetic port replica (``serve --synthetic
    --replica``), with ``--device`` forwarded when given."""
    argv = [sys.executable, "-m", "taboo_brittleness_tpu_torch", "serve",
            "--synthetic", "--output-dir", output_dir, "--replica",
            "--slots", "4", "--queue-limit", "6",
            "--max-new-tokens", "4", "--poll", "0.05",
            "--lease", str(lease_s), *extra]
    return argv + (["--device", str(device)] if device else [])


def chaos_smoke(output_dir: str, *, n_requests: int = 12,
                n_replicas: int = 3, lease_s: float = 3.0,
                max_wall_s: float = 600.0,
                fault_plan: Optional[Dict[str, Any]] = None,
                device: Optional[str] = None,
                env: Optional[Dict[str, str]] = None,
                ) -> ServeFleetResult:
    """One chaos round over synthetic replicas: spool ``n_requests`` mixed
    requests once every replica heartbeats, kill replica w1 at its FIRST
    response commit (``serve.respond`` die, incarnation 0), and run the
    fleet to completion.  The serve fleet has no speculative re-dispatch:
    recovery MUST go through lease expiry -> re-spool.

    The first request is pinned to w1 (``run_serve_fleet(pins=...)``), so
    the fault always has a commit to die on: the burn router alone may
    send every request elsewhere (a weighted draw, and a heartbeat older
    than three intervals reads as dead, which a loaded host makes likely
    at the moment of routing), and then nothing dies and no lease
    expires."""
    spool = RequestSpool(output_dir, fleet=True)

    def _feed() -> None:
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline:
            views = [read_progress(
                os.path.join(output_dir, f"_progress.w{i}.json"),
                missing_ok=True) for i in range(int(n_replicas))]
            if all(v.get("status") == "running" for v in views):
                break
            time.sleep(0.1)
        for i in range(int(n_requests)):
            spool.put({"id": f"r{i:03d}",
                       "prompt": f"selfcheck request {i}",
                       "scenario": _MIX_SCENARIOS[i % len(_MIX_SCENARIOS)],
                       "seed": i})

    feeder = threading.Thread(target=_feed, name="serve-fleet-feeder",
                              daemon=True)
    feeder.start()
    plan = fault_plan if fault_plan is not None else {
        "serve.respond": [
            {"mode": "die", "times": 1, "match": "w1", "incarnation": 0}]}
    child_env = {
        "TABOO_FAULT_PLAN": json.dumps(plan),
        "TBX_OBS_PROGRESS_S": "0.2",
        "TBX_SUPERVISE_BACKOFF_S": "0",
        **(env or {}),
    }
    try:
        return run_serve_fleet(
            output_dir,
            replica_argv=lambda wid: replica_command(
                output_dir, lease_s=lease_s, device=device),
            n_replicas=n_replicas, replica_env=child_env, lease_s=lease_s,
            poll_s=0.2, max_requests=int(n_requests), max_wall_s=max_wall_s,
            max_incarnations=4, supervise_poll=0.2, grace=2.0,
            wedge_after=60.0,
            policy=RetryPolicy(max_retries=6, base_delay=0.0),
            pins={"r000": "w1"} if fault_plan is None else None)
    finally:
        feeder.join(timeout=310.0)


def selfcheck(output_dir: str, *, n_requests: int = 12,
              device: Optional[str] = None) -> Dict[str, Any]:
    """Assert the chaos contract: every spooled request answered EXACTLY
    once (duplicates parked, not merged), recovery through the lease path
    (>= 1 expiry, >= 1 re-spool), nothing on disk corrupt."""
    result = chaos_smoke(output_dir, n_requests=n_requests, device=device)
    spool = RequestSpool(output_dir, fleet=True)
    problems: List[str] = []
    if result.status != "done" or result.exit_code != 0:
        problems.append(
            f"fleet status {result.status} exit {result.exit_code}")
    rids = [f"r{i:03d}" for i in range(n_requests)]
    unanswered = [r for r in rids if spool.get_response(r) is None]
    if unanswered:
        problems.append(f"unanswered requests: {unanswered}")
    try:
        n_responses = sum(1 for n in os.listdir(spool.responses_dir)
                          if n.endswith(".json"))
    except OSError:
        n_responses = -1
    if n_responses != n_requests:
        problems.append(
            f"expected exactly {n_requests} responses, found {n_responses} "
            "(duplicates must park in _duplicates/, never merge)")
    if result.lease_expiries < 1:
        problems.append("no lease expiry — the die fault did not bite")
    if result.respooled < 1:
        problems.append("no re-spool — recovery did not use the lease path")
    corrupt = [os.path.join(r, n) for r, _, files in os.walk(output_dir)
               for n in files if n.endswith(".corrupt")]
    if corrupt:
        problems.append(f"corrupt artifacts: {corrupt}")
    return {
        "ok": not problems,
        "problems": problems,
        "result": result.to_dict(),
    }


def main_selfcheck(device: Optional[str] = None) -> int:
    """``serve-fleet --selfcheck``: the chaos smoke in a temp dir; prints
    the verdict."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="tbx-serve-fleet-selfcheck-")
    try:
        verdict = selfcheck(os.path.join(tmp, "fleet"), device=device)
        out = {"ok": verdict["ok"], "problems": verdict["problems"],
               "status": verdict["result"]["status"],
               "completed": verdict["result"]["completed"],
               "respooled": verdict["result"]["respooled"],
               "lease_expiries": verdict["result"]["lease_expiries"],
               "duplicate_responses": verdict["result"]["duplicate_commits"],
               "recovery_seconds": verdict["result"]["recovery_seconds"]}
        # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict)
        print(json.dumps(out, indent=2))
        return 0 if verdict["ok"] else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
