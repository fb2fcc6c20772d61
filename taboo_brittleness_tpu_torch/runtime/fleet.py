"""Elastic fleet execution: lease-based work stealing over a durable spool.

The Gemma-Scope depth x width grid (``grid/``) and any long word sweep are
many independent units of work, where "worker 3 died mid-unit" and "worker
1 is a straggler holding the whole sweep" are steady-state events.
``runtime.resilience`` retries and quarantines within a process and
``runtime.supervise`` restarts one child through preemptions; this module
is the layer above both: a **coordinator** that decomposes a sweep into
``(word, readout_config)`` work units in a durable filesystem spool, and N
**workers** that claim units under time-bounded leases.

The PyTorch port's copy of the JAX package's ``runtime/fleet.py``.  The
spool layout and every JSON schema are the JAX package's, so either
package's workers can claim the other's units.  Workers are separate
processes started by exec (``python -m taboo_brittleness_tpu_torch worker``,
never a fork of a process that touched CUDA); each opens its own CUDA
context, graph pool and ``runtime.aot`` pool cap.

Spool layout under ``<output_dir>/spool/`` (every transition is an atomic
write or a rename — the proven ``serve.server`` claim-by-rename pattern)::

    config.json                        what the workers should compute
    units/<uid>.a<k>.json              issuable unit, attempt k (atomic put)
    claimed/<uid>.a<k>.<holder>.json   ...claimed by <holder> (rename)
    leases/<uid>.a<k>.json             heartbeat-renewed lease (atomic write)
    done/<uid>.json                    committed result (link = first writer
                                       WINS; later commits are duplicates)
    duplicates/<uid>.<holder>.json     a benign losing commit (audit trail)
    quarantined/<uid>.a<k>.json        terminal per-unit failure
    _stop                              coordinator's "fleet is done" marker

Execution contracts:

- **Claim.**  A worker claims a unit by renaming it into ``claimed/`` (the
  rename either succeeds for exactly one claimant or raced and lost), then
  writes a lease with ``expires_at = now + lease_s`` and renews it from a
  keeper thread every ``lease_s / 3``.
- **Death / wedge.**  A worker that dies (SIGKILL, OOM, ``die`` fault)
  stops renewing; a WEDGED worker keeps renewing until its per-worker
  supervisor (``runtime.supervise``'s two-signal classifier over
  ``_progress.<worker_id>.json``) kills it — either way the lease expires
  and the coordinator re-issues the unit at ``attempt+1`` with the dead
  *holder* (``worker-i<incarnation>``) in the unit's exclusion list, so a
  half-dead process cannot immediately reclaim its own unit while a
  restarted incarnation (new holder token) still can.
- **Stragglers.**  A claimed unit whose lease age exceeds a
  percentile-based deadline (``TBX_FLEET_SPEC_PCT`` of completed unit
  durations × ``TBX_FLEET_SPEC_FACTOR``) is speculatively re-issued to a
  different worker; whichever attempt commits first wins atomically
  (``os.link`` is exclusive) and the loser parks in ``duplicates/``.
- **Exactly-once artifacts.**  ``done/<uid>.json`` is created exactly once
  per unit no matter how many attempts raced; duplicate completions are
  counted, never merged.
- **Supervision.**  Each worker runs under ``supervise.supervise(...,
  worker_id=...)`` — crash restart within an incarnation budget, wedge
  kill, drain (SIGTERM → finish the current unit → exit 75) — so the fleet
  tolerates both SIGKILL-style death and clean preemption.  A drained
  coordinator leaves the spool resumable: a relaunch re-issues orphaned
  claims and continues.
- **One coherent run view.**  Workers write per-worker telemetry
  (``_events.<wid>.jsonl`` / ``_failures.<wid>.json`` /
  ``_progress.<wid>.json``, all stamped with ``worker_id``); at fleet end
  :func:`merge_fleet_artifacts` folds them into the coordinator's
  ``_events.jsonl`` (seq renumbered so the merged stream stays strictly
  monotone, span ids remapped, a killed worker's dangling spans closed with
  ``status="error"``) and a merged ``_failures.json`` whose ``fleet`` block
  records every lease-expiry → re-issue chain.

Fault sites (``TABOO_FAULT_PLAN``): ``fleet.claim`` / ``fleet.lease_renew``
/ ``fleet.commit`` — the chaos harness arms ``die`` at ``fleet.commit`` to
kill a worker mid-word and ``delay`` to wedge one.

Env knobs: ``TBX_FLEET_LEASE_S`` (default 10), ``TBX_FLEET_POLL_S``
(default 0.5), ``TBX_FLEET_SPEC_PCT`` (default 75), ``TBX_FLEET_SPEC_FACTOR``
(default 3.0, ``0`` disables speculation), ``TBX_FLEET_SPEC_MIN_S``
(default 5).

Everything here is stdlib host-side control flow (nothing imports torch);
the unit *computation* is a callable the worker entry point supplies.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from taboo_brittleness_tpu_torch.obs import flightrec
from taboo_brittleness_tpu_torch.runtime import supervise
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FailureLedger, RetryPolicy, atomic_json_dump, current_incarnation,
    run_guarded)
from taboo_brittleness_tpu_torch.runtime import resilience

__all__ = [
    "FleetResult", "FleetSpool", "LeaseKeeper", "LeaseStore", "WorkerResult",
    "exclusive_commit", "holder_token", "main_selfcheck",
    "merge_fleet_artifacts", "merge_metrics", "run_fleet", "run_worker",
    "unit_id",
]

SPOOL_DIRNAME = "spool"
STOP_MARKER = "_stop"
FLEET_SUMMARY_FILENAME = "_fleet.json"
CONFIG_FILENAME = "config.json"

_UID_SANITIZE = re.compile(r"[^A-Za-z0-9_@-]+")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def lease_seconds() -> float:
    return max(0.5, _env_float("TBX_FLEET_LEASE_S", 10.0))


def unit_id(word: str, readout: Dict[str, Any]) -> str:
    """Deterministic filesystem-safe id for a ``(word, readout_config)``
    unit: ``<word>@L<layer>`` for the common depth-grid case, with every
    non-filename character folded to ``-``."""
    layer = readout.get("layer")
    key = readout.get("key") or (f"L{layer}" if layer is not None else "r0")
    return _UID_SANITIZE.sub("-", f"{word}@{key}")


def holder_token(worker_id: str, incarnation: Optional[int] = None) -> str:
    """One process-generation's claim identity: ``<worker>-i<incarnation>``.
    Exclusion lists carry holders, not workers, so a restarted incarnation
    of a dead worker may reclaim the unit its predecessor dropped while the
    (possibly still half-alive) predecessor itself may not."""
    inc = current_incarnation() if incarnation is None else int(incarnation)
    return f"{worker_id}-i{inc}"


# ---------------------------------------------------------------------------
# Lease core: unit-type-agnostic ownership machinery.
#
# A "lease" knows nothing about what it protects — only that some holder
# claimed item ``uid`` at attempt ``attempt`` and must renew before
# ``expires_at`` or lose it.  Factoring the file machinery out of FleetSpool
# lets serve.server.RequestSpool lease REQUESTS with the exact same expiry /
# re-issue / exclusion semantics the sweep fleet chaos-proved.
# ---------------------------------------------------------------------------


class LeaseStore:
    """The leases/ directory: one JSON file per held ``(uid, attempt)``.

    Expiry is a CROSS-PROCESS deadline, so every timestamp here is epoch
    wall-clock: the coordinator compares ``expires_at`` against its own
    clock — monotonic bases do not transfer between processes."""

    def __init__(self, leases_dir: str):
        self.leases_dir = leases_dir

    def ensure(self) -> "LeaseStore":
        os.makedirs(self.leases_dir, exist_ok=True)
        return self

    def lease_path(self, uid: str, attempt: int) -> str:
        return os.path.join(self.leases_dir, f"{uid}.a{attempt}.json")

    def write_lease(self, uid: str, attempt: int, holder: str, worker: str,
                    lease_s: float, *,
                    claimed_at: Optional[float] = None) -> None:
        # tbx: wallclock-ok — cross-process lease deadline (see class doc)
        now = time.time()
        atomic_json_dump({"v": 1, "uid": uid, "attempt": attempt,
                          "holder": holder, "worker": worker,
                          "pid": os.getpid(),
                          "claimed_at": claimed_at if claimed_at is not None
                          else now,
                          "renewed_at": now,
                          "expires_at": now + float(lease_s)},
                         self.lease_path(uid, attempt))

    def drop_lease(self, uid: str, attempt: int) -> None:
        try:
            os.unlink(self.lease_path(uid, attempt))
        except OSError:
            pass

    def leases(self) -> List[Dict[str, Any]]:
        out = []
        try:
            names = sorted(os.listdir(self.leases_dir))
        except OSError:
            return []
        for n in names:
            if not n.endswith(".json"):
                continue
            path = os.path.join(self.leases_dir, n)
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            rec["_path"] = path
            out.append(rec)
        return out


def exclusive_commit(dst_path: str, payload: Dict[str, Any], *,
                     holder: str, duplicates_dir: str) -> bool:
    """First-writer-wins commit of ``payload`` to ``dst_path``: write a
    holder-private tmp next to it, then ``os.link`` — creation is exclusive,
    so exactly one racer wins.  The loser's payload parks in
    ``duplicates_dir`` (duplicate completions are expected under speculative
    or re-issued work, never a conflict).  Returns True when THIS call
    created ``dst_path``."""
    d = os.path.dirname(dst_path)
    base = os.path.basename(dst_path)
    tmp = os.path.join(d, f".{base}.{holder}.tmp")
    stem = base[:-5] if base.endswith(".json") else base
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    try:
        os.link(tmp, dst_path)
        won = True
    except FileExistsError:
        won = False
        try:
            os.makedirs(duplicates_dir, exist_ok=True)
            os.replace(tmp, os.path.join(duplicates_dir,
                                         f"{stem}.{holder}.json"))
        except OSError:
            pass
    except OSError:
        # No hardlink support: fall back to the create-exclusive dance.
        won = not os.path.exists(dst_path)
        if won:
            os.replace(tmp, dst_path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return won


# ---------------------------------------------------------------------------
# The durable spool.
# ---------------------------------------------------------------------------


class FleetSpool:
    """Filesystem work-unit exchange (see module docstring for the layout).

    Every method is safe to call concurrently from many processes: state
    transitions are renames (exactly-one-winner) or atomic writes, and
    readers treat a torn/unparseable file as "mid-flight, retry later" —
    the same stance as ``serve.server.RequestSpool``.
    """

    def __init__(self, root: str):
        self.root = root
        self.units_dir = os.path.join(root, "units")
        self.claimed_dir = os.path.join(root, "claimed")
        self.leases_dir = os.path.join(root, "leases")
        self.done_dir = os.path.join(root, "done")
        self.duplicates_dir = os.path.join(root, "duplicates")
        self.quarantined_dir = os.path.join(root, "quarantined")
        self.lease_store = LeaseStore(self.leases_dir)

    def ensure(self) -> "FleetSpool":
        for d in (self.units_dir, self.claimed_dir, self.leases_dir,
                  self.done_dir, self.duplicates_dir, self.quarantined_dir):
            os.makedirs(d, exist_ok=True)
        return self

    # -- shared helpers ------------------------------------------------------

    @staticmethod
    def _parse(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _listdir(self, d: str) -> List[str]:
        try:
            return sorted(os.listdir(d))
        except OSError:
            return []

    # -- config / stop -------------------------------------------------------

    def write_config(self, cfg: Dict[str, Any]) -> None:
        atomic_json_dump(cfg, os.path.join(self.root, CONFIG_FILENAME))

    def read_config(self) -> Dict[str, Any]:
        return self._parse(os.path.join(self.root, CONFIG_FILENAME)) or {}

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

    # -- resolution state ----------------------------------------------------

    def done_path(self, uid: str) -> str:
        return os.path.join(self.done_dir, f"{uid}.json")

    def is_done(self, uid: str) -> bool:
        return os.path.exists(self.done_path(uid))

    def done_uids(self) -> List[str]:
        return [n[:-5] for n in self._listdir(self.done_dir)
                if n.endswith(".json")]

    def quarantined_uids(self) -> List[str]:
        out = set()
        for n in self._listdir(self.quarantined_dir):
            m = re.match(r"(.+)\.a\d+\.json$", n)
            if m:
                out.add(m.group(1))
        return sorted(out)

    def is_resolved(self, uid: str) -> bool:
        return self.is_done(uid) or uid in set(self.quarantined_uids())

    def duplicate_count(self) -> int:
        return sum(1 for n in self._listdir(self.duplicates_dir)
                   if n.endswith(".json"))

    # -- coordinator side ----------------------------------------------------

    def put(self, uid: str, unit: Dict[str, Any], *, attempt: int = 0,
            excluded: Sequence[str] = ()) -> str:
        """Issue (or re-issue) one unit.  Atomic write; a unit file is
        immutable once issued — re-issues are new files at ``attempt+1``."""
        path = os.path.join(self.units_dir, f"{uid}.a{attempt}.json")
        atomic_json_dump({"v": 1, "uid": uid, "unit": unit,
                          "attempt": attempt,
                          "excluded": sorted(set(excluded))}, path)
        return path

    def pending(self) -> List[Dict[str, Any]]:
        out = []
        for n in self._listdir(self.units_dir):
            if not n.endswith(".json"):
                continue
            rec = self._parse(os.path.join(self.units_dir, n))
            if rec is not None:
                out.append(rec)
        return out

    def claimed_entries(self) -> List[Dict[str, Any]]:
        """``[{uid, attempt, holder, mtime}]`` parsed from claimed/ names."""
        out = []
        for n in self._listdir(self.claimed_dir):
            m = re.match(r"(.+)\.a(\d+)\.(.+)\.json$", n)
            if not m:
                continue
            path = os.path.join(self.claimed_dir, n)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            out.append({"uid": m.group(1), "attempt": int(m.group(2)),
                        "holder": m.group(3), "mtime": mtime})
        return out

    def leases(self) -> List[Dict[str, Any]]:
        return self.lease_store.leases()

    def drop_lease(self, uid: str, attempt: int) -> None:
        self.lease_store.drop_lease(uid, attempt)

    # -- worker side ---------------------------------------------------------

    def claim(self, holder: str, worker: str) -> Optional[Dict[str, Any]]:
        """Claim one issuable unit (skipping resolved uids and units that
        exclude this holder).  Rename is the atomicity: a raced claim simply
        loses and scans on."""
        for n in self._listdir(self.units_dir):
            if not n.endswith(".json"):
                continue
            src = os.path.join(self.units_dir, n)
            rec = self._parse(src)
            if rec is None:
                continue                    # mid-flight put; later poll
            uid = str(rec.get("uid", ""))
            if not uid or self.is_resolved(uid):
                # A stale speculative/re-issued copy of a finished unit:
                # garbage-collect it instead of computing it again.
                try:
                    os.unlink(src)
                except OSError:
                    pass
                continue
            if holder in rec.get("excluded", ()):
                continue
            resilience.fire("fleet.claim", uid=uid, worker=worker,
                            holder=holder)
            dst = os.path.join(
                self.claimed_dir,
                f"{uid}.a{int(rec.get('attempt', 0))}.{holder}.json")
            try:
                os.replace(src, dst)
            except OSError:
                continue                    # raced another worker; scan on
            flightrec.record("fleet.claim", uid=uid,
                             attempt=int(rec.get("attempt", 0)),
                             worker=worker)
            return rec
        return None

    def lease_path(self, uid: str, attempt: int) -> str:
        return self.lease_store.lease_path(uid, attempt)

    def write_lease(self, uid: str, attempt: int, holder: str, worker: str,
                    lease_s: float, *,
                    claimed_at: Optional[float] = None) -> None:
        self.lease_store.write_lease(uid, attempt, holder, worker, lease_s,
                                     claimed_at=claimed_at)

    def commit(self, uid: str, payload: Dict[str, Any], *,
               holder: str) -> bool:
        """First-writer-wins atomic commit (:func:`exclusive_commit`).
        Returns True when THIS call created ``done/<uid>.json``; False means
        another attempt already committed and this result parked in
        ``duplicates/`` — benign by design (speculative re-dispatch makes
        duplicate completions expected, not exceptional)."""
        won = exclusive_commit(self.done_path(uid), payload, holder=holder,
                               duplicates_dir=self.duplicates_dir)
        flightrec.record("fleet.commit", uid=uid, won=won)
        return won

    def quarantine_unit(self, uid: str, attempt: int, *, worker: str,
                        error: str) -> None:
        atomic_json_dump(
            {"uid": uid, "attempt": attempt, "worker": worker,
             # tbx: wallclock-ok — serialized metadata for humans
             "at": time.time(), "error": error[:500]},
            os.path.join(self.quarantined_dir, f"{uid}.a{attempt}.json"))

    def release(self, uid: str, attempt: int, holder: str) -> None:
        """Post-resolution cleanup: drop the lease and the claimed marker."""
        self.drop_lease(uid, attempt)
        try:
            os.unlink(os.path.join(self.claimed_dir,
                                   f"{uid}.a{attempt}.{holder}.json"))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Worker: claim → lease-keep → compute → commit.
# ---------------------------------------------------------------------------


class LeaseKeeper:
    """Renews one claimed unit's lease from a daemon thread every
    ``lease_s / 3`` until stopped.  Renewal is fail-open: a failed renewal
    (transient IO, injected ``fleet.lease_renew`` fault) lets the lease
    expire and the unit get re-issued — the first-writer-wins commit makes
    that a duplicate, never a conflict.  A ``die``-mode fault at the
    renewal site kills the whole process, the crash the harness simulates.

    ``spool`` only needs ``write_lease``/``drop_lease`` — a bare
    :class:`LeaseStore` works; the serve fleet's multi-request keeper
    (``serve.server.ServeLeaseKeeper``) builds on the store directly."""

    def __init__(self, spool: Any, uid: str, attempt: int,
                 holder: str, worker: str, lease_s: float):
        self.spool = spool
        self.uid = uid
        self.attempt = attempt
        self.holder = holder
        self.worker = worker
        self.lease_s = float(lease_s)
        # tbx: wallclock-ok — cross-process lease timestamps use the epoch
        self.claimed_at = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LeaseKeeper":
        self.spool.write_lease(self.uid, self.attempt, self.holder,
                               self.worker, self.lease_s,
                               claimed_at=self.claimed_at)
        self._thread = threading.Thread(
            target=self._run, name=f"lease-{self.uid}", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(0.1, self.lease_s / 3.0)
        while not self._stop.wait(interval):
            try:
                resilience.fire("fleet.lease_renew", uid=self.uid,
                                worker=self.worker, holder=self.holder)
                self.spool.write_lease(self.uid, self.attempt, self.holder,
                                       self.worker, self.lease_s,
                                       claimed_at=self.claimed_at)
                flightrec.record("fleet.lease_renew", uid=self.uid,
                                 attempt=self.attempt)
            except Exception:  # noqa: BLE001 — fail-open; expiry is benign
                pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        # The unit is resolved (committed/quarantined) or being released:
        # either way this holder's lease is over.
        self.spool.drop_lease(self.uid, self.attempt)


@dataclasses.dataclass
class WorkerResult:
    worker_id: str
    committed: int = 0
    duplicates: int = 0
    quarantined: int = 0
    drained: bool = False

    @property
    def exit_code(self) -> int:
        if self.drained:
            return supervise.EXIT_DRAINED
        return 1 if self.quarantined else 0


def run_worker(
    fleet_dir: str,
    worker_id: str,
    *,
    unit_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
    lease_s: Optional[float] = None,
    poll_s: float = 0.25,
    max_retries: int = 2,
    retry_policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> WorkerResult:
    """One worker's claim loop: claim a unit, keep its lease alive, run it
    under the retry→quarantine guard, commit first-writer-wins; exit when
    the coordinator posts the stop marker or a drain notice lands.

    Telemetry rides the standard sweep observer, which (because
    ``TBX_WORKER_ID`` is set) lands in the per-worker files
    ``_events.<wid>.jsonl`` / ``_progress.<wid>.json`` — individually
    seq-monotone across this worker's incarnations, merged at fleet end.
    """
    from taboo_brittleness_tpu_torch import obs

    spool = FleetSpool(os.path.join(fleet_dir, SPOOL_DIRNAME)).ensure()
    lease_s = lease_seconds() if lease_s is None else float(lease_s)
    policy = retry_policy or RetryPolicy(max_retries=max_retries)
    holder = holder_token(worker_id)
    ledger = FailureLedger(
        path=os.path.join(fleet_dir, f"_failures.{worker_id}.json"),
        worker=worker_id)
    res = WorkerResult(worker_id=worker_id)

    with obs.sweep_observer(fleet_dir, pipeline="fleet-worker") as ob:
        while True:
            if supervise.drain_requested():
                res.drained = True
                ob.mark_drained()
                break
            try:
                rec = spool.claim(holder, worker_id)
            except Exception as exc:  # noqa: BLE001 — injected/transient claim
                ob.event("fleet.claim_failed",
                         worker=worker_id,
                         error=f"{type(exc).__name__}: {exc}"[:200])
                sleep(poll_s)
                continue
            if rec is None:
                if spool.stopped():
                    break
                sleep(poll_s)
                continue
            uid = str(rec["uid"])
            attempt = int(rec.get("attempt", 0))
            ob.event("fleet.claim", uid=uid, worker=worker_id,
                     holder=holder, attempt=attempt)
            keeper = LeaseKeeper(spool, uid, attempt, holder, worker_id,
                                 lease_s).start()
            t0 = time.monotonic()
            stage = {"name": "compute"}

            def run_one() -> Dict[str, Any]:
                stage["name"] = "compute"
                with ob.phase("compute"):
                    return unit_fn(dict(rec["unit"]))

            try:
                with ob.word(uid) as wsp:
                    outcome = run_guarded(
                        uid, run_one, policy=policy, ledger=ledger,
                        stage=lambda: stage["name"], sleep=sleep)
                    wsp.set(attempts=outcome.attempts, worker=worker_id)
                    if outcome.ok:
                        resilience.fire("fleet.commit", uid=uid,
                                        worker=worker_id, holder=holder)
                        won = spool.commit(
                            uid,
                            {"uid": uid, "unit": rec["unit"],
                             "worker": worker_id, "holder": holder,
                             "attempt": attempt,
                             "seconds": round(time.monotonic() - t0, 3),
                             "result": outcome.value},
                            holder=holder)
                        ob.event("fleet.commit", uid=uid, worker=worker_id,
                                 attempt=attempt, duplicate=not won,
                                 seconds=round(time.monotonic() - t0, 3))
                        if won:
                            res.committed += 1
                        else:
                            res.duplicates += 1
                    else:
                        wsp.set(quarantined=True, stage=outcome.stage)
                        spool.quarantine_unit(
                            uid, attempt, worker=worker_id,
                            error=f"{type(outcome.error).__name__}: "
                                  f"{outcome.error}")
                        ob.event("fleet.quarantine", uid=uid,
                                 worker=worker_id, attempt=attempt,
                                 error=f"{type(outcome.error).__name__}: "
                                       f"{outcome.error}"[:300])
                        res.quarantined += 1
            finally:
                keeper.stop()
                spool.release(uid, attempt, holder)
    return res


# ---------------------------------------------------------------------------
# Coordinator: issue → watch leases → re-issue / speculate → merge.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetResult:
    """Outcome of one :func:`run_fleet` call (also persisted to
    ``<output_dir>/_fleet.json``)."""

    status: str                       # done | drained | stalled
    exit_code: int
    units_total: int
    committed: int
    quarantined: int
    reissued: int = 0
    speculated: int = 0
    lease_expiries: int = 0
    duplicate_commits: int = 0
    recovery_seconds: Optional[float] = None
    wall_seconds: float = 0.0
    workers: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    reissue_chains: Dict[str, List[Dict[str, Any]]] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.exit_code == 0

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["version"] = 1
        return d


def _percentile(values: Sequence[float], q: float) -> float:
    vals = sorted(values)
    if not vals:
        return 0.0
    idx = min(len(vals) - 1, max(0, int(round((q / 100.0) * (len(vals) - 1)))))
    return vals[idx]


def run_fleet(
    units: Sequence[Dict[str, Any]],
    output_dir: str,
    *,
    n_workers: int = 3,
    worker_argv: Optional[Callable[[str], Sequence[str]]] = None,
    worker_ids: Optional[Sequence[str]] = None,
    worker_env: Optional[Dict[str, str]] = None,
    spool_config: Optional[Dict[str, Any]] = None,
    lease_s: Optional[float] = None,
    poll_s: Optional[float] = None,
    spec_factor: Optional[float] = None,
    spec_pct: Optional[float] = None,
    max_incarnations: Optional[int] = None,
    supervise_poll: Optional[float] = None,
    grace: Optional[float] = None,
    wedge_after: Optional[float] = None,
    policy: Optional[RetryPolicy] = None,
    max_wall_s: Optional[float] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> FleetResult:
    """Run a sweep as an elastic fleet: issue ``units`` into the spool,
    launch ``n_workers`` supervised worker subprocesses, watch leases and
    stragglers, merge artifacts, return the fleet outcome.

    ``units`` are ``{"uid": ..., "word": ..., "readout": {...}}`` dicts
    (``uid`` defaults to :func:`unit_id`).  ``worker_argv(worker_id)``
    builds each worker's subprocess argv (the CLI wires
    ``python -m taboo_brittleness_tpu_torch worker --fleet-dir ...
    --worker-id ...``).  Resume: units whose ``done/<uid>.json`` already exists are not
    re-issued, and orphaned claims from a previous (killed) run are
    recovered at startup.
    """
    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics

    if worker_argv is None:
        raise ValueError("run_fleet needs worker_argv(worker_id) -> argv")
    lease_s = lease_seconds() if lease_s is None else float(lease_s)
    poll_s = (_env_float("TBX_FLEET_POLL_S", 0.5)
              if poll_s is None else float(poll_s))
    spec_factor = (_env_float("TBX_FLEET_SPEC_FACTOR", 3.0)
                   if spec_factor is None else float(spec_factor))
    spec_pct = (_env_float("TBX_FLEET_SPEC_PCT", 75.0)
                if spec_pct is None else float(spec_pct))
    spec_min_s = _env_float("TBX_FLEET_SPEC_MIN_S", 5.0)
    wids = list(worker_ids or [f"w{i}" for i in range(n_workers)])

    os.makedirs(output_dir, exist_ok=True)
    spool = FleetSpool(os.path.join(output_dir, SPOOL_DIRNAME)).ensure()
    spool.clear_stop()
    if spool_config is not None:
        spool.write_config(spool_config)

    # Normalize + issue units (resume: committed uids stay committed).
    issued: Dict[str, Dict[str, Any]] = {}
    for u in units:
        u = dict(u)
        uid = str(u.get("uid") or unit_id(u.get("word", "unit"),
                                          u.get("readout", {})))
        u["uid"] = uid
        issued[uid] = u
    done0 = set(spool.done_uids())
    quarantined0 = set(spool.quarantined_uids())
    pending_uids = {r["uid"] for r in spool.pending()}
    claimed0 = {c["uid"] for c in spool.claimed_entries()}
    attempts: Dict[str, int] = {uid: 0 for uid in issued}
    for c in spool.claimed_entries():
        attempts[c["uid"]] = max(attempts.get(c["uid"], 0), c["attempt"])
    live_leases = {(rec.get("uid"), rec.get("attempt"))
                   for rec in spool.leases()}
    for uid, u in issued.items():
        if uid in done0 or uid in quarantined0 or uid in pending_uids:
            continue
        if uid in claimed0:
            # Orphaned claim from a killed previous run: if no live lease
            # backs it, re-issue now instead of waiting out a ghost.
            orphans = [c for c in spool.claimed_entries() if c["uid"] == uid]
            if any((uid, c["attempt"]) in live_leases for c in orphans):
                continue
            nxt = max(c["attempt"] for c in orphans) + 1
            attempts[uid] = nxt
            spool.put(uid, {k: v for k, v in u.items() if k != "uid"},
                      attempt=nxt,
                      excluded=[c["holder"] for c in orphans])
            continue
        spool.put(uid, {k: v for k, v in u.items() if k != "uid"})

    # Launch workers, each under its own per-worker supervisor thread.
    results: Dict[str, supervise.SuperviseResult] = {}
    threads: List[threading.Thread] = []
    env = dict(worker_env or {})

    def _supervise_one(wid: str) -> None:
        results[wid] = supervise.supervise(
            list(worker_argv(wid)), output_dir,
            worker_id=wid,
            max_incarnations=max_incarnations,
            poll_interval=supervise_poll,
            grace=grace, wedge_after=wedge_after,
            policy=policy, env=env)

    for wid in wids:
        t = threading.Thread(target=_supervise_one, args=(wid,),
                             name=f"fleet-supervise-{wid}", daemon=True)
        t.start()
        threads.append(t)

    t_start = time.monotonic()
    status = "done"
    reissue_chains: Dict[str, List[Dict[str, Any]]] = {}
    speculated: Dict[str, int] = {}
    lease_expiries = 0
    reissued_uids: set = set()
    first_expiry_mono: Optional[float] = None
    recovery_seconds: Optional[float] = None

    with obs.sweep_observer(output_dir, pipeline="fleet",
                            words=sorted(issued)) as ob:
        ob.event("fleet.start", units=len(issued), workers=len(wids),
                 lease_s=lease_s)
        while True:
            # tbx: wallclock-ok — lease expiry compares against the epoch
            # deadlines the workers wrote (cross-process clock).
            now_wall = time.time()
            done = set(spool.done_uids())
            quarantined = set(spool.quarantined_uids())
            resolved = done | quarantined

            # 1. Expired leases → re-issue with the dead holder excluded.
            for rec in spool.leases():
                uid = str(rec.get("uid", ""))
                attempt = int(rec.get("attempt", 0))
                if float(rec.get("expires_at", 0) or 0) > now_wall:
                    continue
                spool.drop_lease(uid, attempt)
                if uid in resolved or uid not in issued:
                    continue
                lease_expiries += 1
                holder = str(rec.get("holder", "?"))
                ob.event("fleet.lease_expired", uid=uid, holder=holder,
                         worker=rec.get("worker"), attempt=attempt)
                if first_expiry_mono is None:
                    first_expiry_mono = time.monotonic()
                prior = reissue_chains.setdefault(uid, [])
                excluded = sorted({holder} | {
                    e["holder"] for e in prior})
                nxt = max(attempts.get(uid, 0), attempt) + 1
                attempts[uid] = nxt
                spool.put(uid, {k: v for k, v in issued[uid].items()
                                if k != "uid"},
                          attempt=nxt, excluded=excluded)
                prior.append({"holder": holder,
                              "worker": rec.get("worker"),
                              "from_attempt": attempt, "to_attempt": nxt,
                              "reason": "lease-expired",
                              # tbx: wallclock-ok — serialized metadata
                              "at": time.time()})
                reissued_uids.add(uid)
                ob.event("fleet.reissue", uid=uid, attempt=nxt,
                         excluded=excluded, reason="lease-expired")

            # 2. Stragglers → speculative duplicate on a different worker.
            durations = []
            for uid in done:
                rec = spool._parse(spool.done_path(uid))
                if rec and isinstance(rec.get("seconds"), (int, float)):
                    durations.append(float(rec["seconds"]))
            if spec_factor > 0 and len(durations) >= 3:
                deadline = max(spec_min_s,
                               spec_factor * _percentile(durations, spec_pct))
                pending_now = {r["uid"] for r in spool.pending()}
                for rec in spool.leases():
                    uid = str(rec.get("uid", ""))
                    attempt = int(rec.get("attempt", 0))
                    if (uid in resolved or uid not in issued
                            or uid in pending_now
                            or speculated.get(uid, -1) >= attempt):
                        continue
                    claimed_at = rec.get("claimed_at") or rec.get(
                        "renewed_at")
                    if claimed_at is None:
                        continue
                    if now_wall - float(claimed_at) <= deadline:
                        continue
                    holder = str(rec.get("holder", "?"))
                    nxt = max(attempts.get(uid, 0), attempt) + 1
                    attempts[uid] = nxt
                    speculated[uid] = attempt
                    spool.put(uid, {k: v for k, v in issued[uid].items()
                                    if k != "uid"},
                              attempt=nxt, excluded=[holder])
                    ob.event("fleet.speculate", uid=uid, attempt=nxt,
                             holder=holder,
                             deadline_s=round(deadline, 3))

            # 3. Progress + completion.
            obs_metrics.gauge("fleet.committed").set(len(done))
            obs_metrics.gauge("fleet.quarantined").set(len(quarantined))
            if reissued_uids and recovery_seconds is None:
                if reissued_uids <= resolved and first_expiry_mono:
                    recovery_seconds = round(
                        time.monotonic() - first_expiry_mono, 3)
                    ob.event("fleet.recovered",
                             reissued=len(reissued_uids),
                             recovery_seconds=recovery_seconds)
                    # The fleet_recovery SLO (obs.slo) reads this histogram
                    # from the timeseries windows.
                    obs_metrics.histogram(
                        "fleet.recovery_seconds").observe(recovery_seconds)
            if set(issued) <= resolved:
                break
            if supervise.drain_requested():
                # The drain latch is process-wide: each worker's supervisor
                # thread is already forwarding SIGTERM; we stop re-issuing
                # and leave the spool resumable.
                status = "drained"
                break
            if all(not t.is_alive() for t in threads):
                status = "stalled"       # every worker exhausted its budget
                break
            if max_wall_s and time.monotonic() - t_start > max_wall_s:
                status = "stalled"
                break
            sleep(poll_s)

        spool.write_stop()
        for t in threads:
            t.join(timeout=max(60.0, 6 * lease_s))
        done = set(spool.done_uids())
        quarantined = set(spool.quarantined_uids())
        ob.event("fleet.exit", status=status, committed=len(done),
                 quarantined=len(quarantined),
                 reissued=len(reissued_uids),
                 lease_expiries=lease_expiries,
                 duplicates=spool.duplicate_count())

    unresolved = set(issued) - done - quarantined
    if status == "drained":
        exit_code = supervise.EXIT_DRAINED
    elif unresolved:
        status = "stalled" if status == "done" else status
        exit_code = 1
    else:
        exit_code = 1 if (quarantined & set(issued)) else 0

    result = FleetResult(
        status=status, exit_code=exit_code,
        units_total=len(issued), committed=len(done & set(issued)),
        quarantined=len(quarantined & set(issued)),
        reissued=len(reissued_uids), speculated=len(speculated),
        lease_expiries=lease_expiries,
        duplicate_commits=spool.duplicate_count(),
        recovery_seconds=recovery_seconds,
        wall_seconds=round(time.monotonic() - t_start, 3),
        workers=[{"worker_id": wid,
                  "status": results[wid].status if wid in results else "?",
                  "exit_code": (results[wid].exit_code
                                if wid in results else None),
                  "incarnations": (len(results[wid].incarnations)
                                   if wid in results else 0)}
                 for wid in wids],
        reissue_chains=reissue_chains)
    merge_fleet_artifacts(output_dir, wids, result=result)
    return result


# ---------------------------------------------------------------------------
# Artifact merging: one coherent run view across workers.
# ---------------------------------------------------------------------------


#: Per-worker byte offsets already folded into the merged files: a
#: relaunched fleet merges only what its workers appended since.
MERGE_MARKS_FILENAME = "_fleet_merge.json"


def _unmerged(marks: Dict[str, int],
              src: str) -> Tuple[List[Dict[str, Any]], int]:
    """The JSON objects on ``src``'s complete lines past its merge mark,
    and the byte offset after them (the next mark)."""
    lo = int(marks.get(os.path.basename(src), 0))
    try:
        with open(src, "rb") as f:
            f.seek(lo)
            data = f.read()
    except OSError:
        return [], lo
    data = data[:data.rfind(b"\n") + 1]       # a torn last line waits
    out = []
    for line in data.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out, lo + len(data)


def _read_marks(output_dir: str) -> Dict[str, Dict[str, int]]:
    try:
        with open(os.path.join(output_dir, MERGE_MARKS_FILENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write_marks(output_dir: str, kind: str, done: Dict[str, int]) -> None:
    marks = _read_marks(output_dir)
    marks.setdefault(kind, {}).update(done)
    atomic_json_dump(marks, os.path.join(output_dir, MERGE_MARKS_FILENAME))


def merge_events(output_dir: str, worker_ids: Sequence[str]) -> int:
    """Fold the per-worker event streams into the coordinator's
    ``_events.jsonl`` as one ``trace_report --check``-clean stream:

    - ``seq`` renumbered to continue the merged file's tail (strict
      monotonicity across the whole merged stream);
    - span ids offset per worker stream so they stay unique;
    - every merged event stamped with its ``worker``;
    - a killed worker's dangling spans (started, never ended — the die/
      SIGKILL case drops the buffered end events) CLOSED with synthesized
      ``status="error"`` end events, so the merged stream keeps the
      balanced-span invariant while still showing the kill.

    Returns the number of events appended.  The per-worker source files are
    left in place (they are the per-worker audit trail the fleet check
    gates for individual monotonicity); ``_fleet_merge.json`` records how
    far each was merged, so a relaunched fleet (resume after a drain)
    appends only its workers' new events.  (The JAX package merges each
    whole file again on a relaunch, which repeats the first run's events.)"""
    from taboo_brittleness_tpu_torch.obs import trace

    merged_path = os.path.join(output_dir, trace.EVENTS_FILENAME)
    seq, max_id = trace._resume_marks(merged_path)
    lines: List[bytes] = []
    appended = 0
    merged_to = _read_marks(output_dir).get("events", {})
    marks: Dict[str, int] = {}
    for wid in worker_ids:
        src = os.path.join(output_dir, f"_events.{wid}.jsonl")
        if not os.path.exists(src):
            continue
        events, marks[os.path.basename(src)] = _unmerged(merged_to, src)
        id_base = max_id
        open_spans: Dict[int, Dict[str, Any]] = {}
        last_t = 0.0
        stream_max_id = 0
        for ev in events:
            ev = dict(ev)
            seq += 1
            ev["seq"] = seq
            ev.setdefault("worker", wid)
            try:
                last_t = max(last_t, float(ev.get("t", 0.0)))
            except (TypeError, ValueError):
                pass
            if isinstance(ev.get("id"), int):
                stream_max_id = max(stream_max_id, ev["id"])
                ev["id"] = ev["id"] + id_base
            if isinstance(ev.get("parent"), int):
                ev["parent"] = ev["parent"] + id_base
            if ev.get("ev") == "start" and isinstance(ev.get("id"), int):
                open_spans[ev["id"]] = ev
            elif ev.get("ev") == "end":
                open_spans.pop(ev.get("id"), None)
            lines.append((json.dumps(ev, default=str) + "\n").encode())
            appended += 1
        max_id += stream_max_id
        # Close a killed incarnation's dangling spans (outermost last so
        # children end before parents in the stream).
        for sid, start in sorted(open_spans.items(), reverse=True):
            seq += 1
            t0 = float(start.get("t", 0.0) or 0.0)
            end = {"v": start.get("v", trace.SCHEMA_VERSION), "seq": seq,
                   "t": max(last_t, t0), "ev": "end",
                   "kind": start.get("kind", "?"),
                   "name": start.get("name", "?"), "id": sid,
                   "dur": round(max(0.0, last_t - t0), 6),
                   "status": "error",
                   "error": "span never ended (worker killed); closed by "
                            "fleet merge",
                   "worker": wid,
                   "attrs": {"synthesized": True, "worker": wid}}
            if start.get("parent") is not None:
                end["parent"] = start["parent"]
            lines.append((json.dumps(end) + "\n").encode())
            appended += 1
    if lines:
        fd = os.open(merged_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, b"".join(lines))
        finally:
            os.close(fd)
    _write_marks(output_dir, "events", marks)
    return appended


def merge_metrics(output_dir: str, worker_ids: Sequence[str]) -> int:
    """Fold the per-worker ``_metrics.<wid>.jsonl`` timeseries spools into
    the coordinator's ``_metrics.jsonl``, mirroring
    :func:`merge_events`: ``seq`` renumbered to continue the merged tail and
    every record stamped with its ``worker``.  Conservation invariants
    (``trace_report --check``) are evaluated per (worker, pid) epoch, so
    interleaving whole streams preserves them.  Returns records appended;
    per-worker sources stay in place as the per-worker audit trail."""
    from taboo_brittleness_tpu_torch.obs import timeseries

    merged_path = os.path.join(output_dir, timeseries.METRICS_FILENAME)
    seq = timeseries._resume_seq(merged_path)
    lines: List[bytes] = []
    appended = 0
    merged_to = _read_marks(output_dir).get("metrics", {})
    marks: Dict[str, int] = {}
    for wid in worker_ids:
        src = os.path.join(output_dir, timeseries.metrics_filename(wid))
        if not os.path.exists(src):
            continue
        records, marks[os.path.basename(src)] = _unmerged(merged_to, src)
        for rec in records:
            rec = dict(rec)
            seq += 1
            rec["seq"] = seq
            rec.setdefault("worker", wid)
            lines.append((json.dumps(rec, default=str) + "\n").encode())
            appended += 1
    if lines:
        fd = os.open(merged_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, b"".join(lines))
        finally:
            os.close(fd)
    _write_marks(output_dir, "metrics", marks)
    return appended


def merge_ledgers(output_dir: str, worker_ids: Sequence[str],
                  result: Optional[FleetResult] = None) -> Dict[str, Any]:
    """Fold the per-worker ``_failures.<wid>.json`` ledgers into one merged
    ``_failures.json`` (schema v3: every entry stamped with its worker) plus
    a ``fleet`` block recording the lease-expiry → re-issue chains — the
    postmortem trail for "which worker dropped which unit, and who picked
    it up"."""
    merged: Dict[str, Any] = {"version": 3, "incarnation": 0,
                              "quarantined": {}, "retried": {}}
    for wid in worker_ids:
        path = os.path.join(output_dir, f"_failures.{wid}.json")
        try:
            with open(path) as f:
                led = json.load(f)
        except (OSError, ValueError):
            continue
        for block in ("quarantined", "retried"):
            for uid, entry in dict(led.get(block, {})).items():
                entry = (dict(entry) if isinstance(entry, dict)
                         else {"attempts": int(entry)})
                entry.setdefault("worker", led.get("worker", wid))
                merged[block][uid] = entry
    if result is not None:
        merged["fleet"] = {
            "status": result.status,
            "reissues": result.reissue_chains,
            "lease_expiries": result.lease_expiries,
            "duplicate_commits": result.duplicate_commits,
        }
    atomic_json_dump(merged, os.path.join(
        output_dir, resilience.LEDGER_FILENAME))
    return merged


def merge_fleet_artifacts(output_dir: str, worker_ids: Sequence[str],
                          *, result: Optional[FleetResult] = None) -> None:
    """The fleet-end merge: events (renumbered, worker-stamped, dangling
    spans closed), ledgers (v3 worker-stamped + reissue chains), and the
    ``_fleet.json`` summary.  Fail-open — a merge hiccup must never turn a
    completed sweep into a failure."""
    try:
        merge_events(output_dir, worker_ids)
    except Exception:  # noqa: BLE001 — merging is bookkeeping, not the sweep
        pass
    try:
        merge_metrics(output_dir, worker_ids)
    except Exception:  # noqa: BLE001
        pass
    try:
        merge_ledgers(output_dir, worker_ids, result)
    except Exception:  # noqa: BLE001
        pass
    if result is not None:
        try:
            atomic_json_dump(result.to_dict(),
                             os.path.join(output_dir,
                                          FLEET_SUMMARY_FILENAME))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Selfcheck: the smoke — tiny model, 3 workers, one killed mid-unit,
# exactly-once completion asserted.
# ---------------------------------------------------------------------------


def worker_command(fleet_dir: str, worker_id: str,
                   device: Optional[str] = None) -> List[str]:
    """The argv of one port worker process (exec, never a fork), with
    ``--device`` forwarded so the worker follows the caller's device."""
    import sys

    argv = [sys.executable, "-m", "taboo_brittleness_tpu_torch", "worker",
            "--fleet-dir", fleet_dir, "--worker-id", worker_id]
    return argv + (["--device", str(device)] if device else [])


def selfcheck(n_units: int = 6, n_workers: int = 3,
              out_dir: Optional[str] = None,
              device: Optional[str] = None) -> FleetResult:
    """Chaos smoke: ``n_workers`` tiny-model subprocess workers over
    ``n_units`` units with worker ``w1`` killed (``die`` at its first
    ``fleet.commit``).  Asserts every unit committed exactly once, zero
    ``.corrupt`` files, and the killed worker's unit re-issued.  Raises
    AssertionError on violation; returns the FleetResult.  ``device``
    goes to every worker's ``--device``."""
    import tempfile

    root = out_dir or tempfile.mkdtemp(prefix="tbx_fleet_selfcheck_")
    words = [f"word{i:02d}" for i in range(n_units)]
    units = [{"uid": unit_id(w, {"layer": 1}), "word": w,
              "readout": {"layer": 1}} for w in words]
    plan = {"fleet.commit": [{"mode": "die", "times": 1,
                              "match": "w1", "incarnation": 0}]}
    env = {"TABOO_FAULT_PLAN": json.dumps(plan),
           "TBX_OBS_PROGRESS_S": "0.2", "TBX_SUPERVISE_BACKOFF_S": "0"}

    res = run_fleet(
        units, root, n_workers=n_workers,
        worker_argv=lambda wid: worker_command(root, wid, device),
        worker_env=env,
        spool_config={"mode": "synthetic", "words": words,
                      "max_new_tokens": 3},
        lease_s=3.0, poll_s=0.2, supervise_poll=0.2, grace=2.0,
        wedge_after=20.0, max_incarnations=4,
        # Speculation off: a warm surviving worker would otherwise steal
        # the dying worker's (start-up-slow) first unit BEFORE its lease
        # expires, absorbing the death without the lease-expiry → re-issue
        # chain this smoke exists to prove.
        spec_factor=0.0,
        policy=RetryPolicy(max_retries=6, base_delay=0.0),
        max_wall_s=600.0)

    spool = FleetSpool(os.path.join(root, SPOOL_DIRNAME))
    done = spool.done_uids()
    assert res.status == "done" and res.exit_code == 0, res.to_dict()
    assert sorted(done) == sorted(u["uid"] for u in units), (
        f"exactly-once violated: {sorted(done)}")
    assert res.committed == n_units, res.to_dict()
    corrupt = [os.path.join(r, n) for r, _, names in os.walk(root)
               for n in names if n.endswith(".corrupt")]
    assert corrupt == [], f".corrupt files leaked: {corrupt}"
    assert res.lease_expiries >= 1 and res.reissued >= 1, (
        f"the killed worker's unit was never re-issued: {res.to_dict()}")
    return res


def main_selfcheck(device: Optional[str] = None) -> int:
    res = selfcheck(device=device)
    # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict JSON)
    print(json.dumps({"selfcheck": "ok", "units": res.units_total,
                      "committed": res.committed,
                      "reissued": res.reissued,
                      "lease_expiries": res.lease_expiries,
                      "duplicate_commits": res.duplicate_commits,
                      "recovery_seconds": res.recovery_seconds}))
    return 0
