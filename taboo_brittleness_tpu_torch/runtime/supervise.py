"""Preemption-safe supervised execution: drain, restart, incarnation resume.

The PyTorch port's copy of the JAX package's ``runtime/supervise.py``
(stdlib only, as there).  The sweep's in-process failure story
(``runtime.resilience``: retry -> quarantine -> continue) and its liveness
story (``obs.progress``: two-signal staleness) both stop at the process
boundary: a preemption notice, an OOM kill or a wedged launch still ends
the run with a human rerunning it by hand.  This module carries them
across process death, in two halves.

**In-child: graceful drain.**  :func:`install_drain_handlers` latches
SIGTERM/SIGINT into a process-wide drain flag that the sweep drivers
(``pipelines.word_sweep``, the interventions study loop, generation) and
the serve loop poll BETWEEN words (or steps): the current word's atomic
writes and obs flush complete, the progress file is stamped
``status="preempted"``, and the process exits :data:`EXIT_DRAINED` (75,
``EX_TEMPFAIL``).  A second signal abandons the drain and dies at once
(the operator asked twice).

**Host-side: the supervisor.**  :func:`supervise` launches any pipeline as
a child process (each launch is one *incarnation*, numbered in the
child's ``TBX_INCARNATION`` env), watches its ``_progress.json`` via
``read_progress(missing_ok=True)``, and closes the loop on every way a
child can stop:

- exit 0 -> the run is done (supervisor exits 0);
- exit 75 (drained) -> relaunch at once: the per-word resume artifacts
  make the next incarnation continue where the drain stopped;
- exit 1 (quarantined words) -> the sweep COMPLETED with words its
  retry budget gave up on; the supervisor passes 1 through instead of
  replaying a permanent failure.  For a SERVING child (progress
  ``workload == "serve"``) exit 1 is a crash and burns an incarnation;
- any other death (crash, OOM/SIGKILL, a ``die`` fault) -> relaunch after
  a seeded-jitter backoff (``RetryPolicy``), within a bounded budget;
- a *wedged* child (heartbeat stale, or pipeline event-quiet past the
  wedge threshold while the heartbeat stays fresh; a server with
  sessions in flight that stopped stepping) -> SIGTERM (drain chance),
  SIGKILL after the grace window, relaunch.

A SIGTERM delivered to the SUPERVISOR is forwarded to the child, which
drains; the supervisor then exits 75 itself.

Artifacts merge across incarnations so the directory reads as one run:
the event sink resumes its ``seq`` from the file tail (``obs.trace``), and
the supervisor writes ``_supervise.json`` (incarnation history) and folds
an ``incarnations`` block into a ``run_manifest.json`` when one exists
(``runtime.manifest``: the ``fleet`` and ``grid`` commands write one).

Env knobs (all overridable per call):

- ``TBX_SUPERVISE_MAX_INCARNATIONS`` — launch budget (default 5).
- ``TBX_SUPERVISE_POLL_S`` — progress poll interval (default 1.0).
- ``TBX_SUPERVISE_GRACE_S`` — SIGTERM->SIGKILL grace window (default 15).
- ``TBX_SUPERVISE_WEDGE_S`` — kill a child whose pipeline has emitted no
  telemetry event for this long while its heartbeat stays fresh
  (default 300).
- ``TBX_SUPERVISE_BACKOFF_S`` — crash-restart base backoff (default 2.0).

Everything here is stdlib host-side control flow: no torch import.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from taboo_brittleness_tpu_torch.runtime.resilience import (
    INCARNATION_ENV, WORKER_ENV, RetryPolicy, atomic_json_dump,
    current_incarnation)

__all__ = [
    "EXIT_DRAINED", "EXIT_QUARANTINED", "SUPERVISE_FILENAME",
    "DrainController", "SuperviseResult", "current_incarnation",
    "drain_requested", "install_drain_handlers", "request_drain",
    "reset_drain", "supervise",
]

#: ``EX_TEMPFAIL``: the run drained cleanly on a preemption notice — partial
#: results on disk are valid and a relaunch resumes them.  Distinct from 1
#: (sweep completed with quarantined words: rerunning won't help) so the
#: supervisor and outer orchestration key restart-vs-fail off the code alone.
EXIT_DRAINED = 75
EXIT_QUARANTINED = 1

SUPERVISE_FILENAME = "_supervise.json"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# In-child graceful drain.
# ---------------------------------------------------------------------------


class DrainController:
    """Process-wide drain latch: signal handlers set it, sweep drivers poll
    it between words via :func:`drain_requested`.

    The handler does the minimum a signal context allows — set a
    ``threading.Event`` and mirror one line to stderr.  It must NOT emit
    telemetry: the signal can land while the main thread holds the tracer's
    (non-reentrant) sink lock, and an event emit from the handler would
    self-deadlock.  The drain event is emitted later, from the sweep loop,
    on the normal path.
    """

    def __init__(self) -> None:
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._installed = False

    def install(self, signums: Sequence[int] = (signal.SIGTERM,
                                                signal.SIGINT)) -> bool:
        """Idempotent; returns False (and stays polling-only) off the main
        thread, where CPython forbids ``signal.signal``."""
        if self._installed:
            return True
        try:
            for s in signums:
                self._prev[s] = signal.signal(s, self._handle)
        except ValueError:
            self._prev.clear()
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        """Restore the previous dispositions (test hygiene)."""
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    def _handle(self, signum: int, frame: Any) -> None:
        if self._event.is_set():
            # Second notice: the operator (or the platform) asked twice —
            # stop draining, restore the original disposition, die now.
            try:
                signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            except (ValueError, OSError, TypeError):
                pass
            signal.raise_signal(signum)
            return
        self._event.set()
        try:
            # tbx: TBX202-ok — single write(2) to an unbuffered-enough fd;
            # no locks taken, and a torn notice line is harmless
            sys.stderr.write(
                f"[supervise] caught signal {signum}: draining at the next "
                "word boundary (send again to abort immediately)\n")
        except Exception:  # noqa: BLE001 — a closed stderr must not matter
            pass
        # Flight-recorder dump (obs.flightrec): unlike the tracer, the ring
        # is LOCK-FREE (deque appends are GIL-atomic) and the dump writes a
        # fresh tmp file, so this is safe from signal context.  A wedge-kill
        # (the supervisor's SIGTERM before SIGKILL) therefore leaves the last
        # N records on disk even when the drain never completes.
        try:
            from taboo_brittleness_tpu_torch.obs import flightrec

            # tbx: TBX202-ok — the ring is lock-free (GIL-atomic deque) and
            # dump() writes a fresh tmp file: no lock a signal can land inside
            flightrec.dump(f"signal:{signum}")
        except Exception:  # noqa: BLE001 — fail-open, always
            pass

    def request(self) -> None:
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def reset(self) -> None:
        self._event.clear()


_CONTROLLER = DrainController()


def install_drain_handlers() -> bool:
    """Latch SIGTERM/SIGINT into the drain flag (CLI entry points call this
    before dispatching a pipeline).  Idempotent; False off the main thread."""
    return _CONTROLLER.install()


def drain_requested() -> bool:
    """Has a preemption/drain notice landed?  Sweep drivers poll this
    between words; the CLI maps True to :data:`EXIT_DRAINED`."""
    return _CONTROLLER.requested()


def request_drain() -> None:
    """Programmatic drain trigger (tests; in-process embedders)."""
    _CONTROLLER.request()


def reset_drain() -> None:
    """Clear the drain latch (test hook — a real process drains once)."""
    _CONTROLLER.reset()


# ---------------------------------------------------------------------------
# Host-side supervisor.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SuperviseResult:
    """Outcome of one :func:`supervise` call: the exit code to propagate,
    a status label, and the per-incarnation history (also persisted to
    ``<output_dir>/_supervise.json``)."""

    exit_code: int
    status: str            # done | drained | quarantined | budget-exhausted
    incarnations: List[Dict[str, Any]]

    @property
    def ok(self) -> bool:
        return self.exit_code == 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "status": self.status,
            "exit_code": self.exit_code,
            "incarnations": self.incarnations,
        }


def _wedge_reason(progress: Dict[str, Any], pid: int,
                  wedge_after: Optional[float]) -> Optional[str]:
    """The two-signal wedge classification over a ``read_progress`` result.

    Only THIS incarnation's heartbeat counts (pid match): right after a
    relaunch the file still holds the dead predecessor's state, which must
    read as "child starting up", never as "child wedged".

    Serving children (``workload == "serve"``; ``obs.progress.serving_update``)
    get their own pipeline-quiet signal: a healthy server that is IDLE emits
    no telemetry events, so the event-age rule would kill it — instead the
    classifier reads the serving heartbeat's in-flight count and last-step
    age, and only wedges a server that HAS sessions but stopped stepping."""
    if progress.get("status") != "running" or progress.get("pid") != pid:
        return None
    if progress.get("stale"):
        # updated_at is old: the heartbeat thread itself stopped while the
        # process is still alive (we checked poll() first) — hard wedge.
        return "heartbeat-stale"
    if progress.get("workload") == "serve":
        serving = progress.get("serving") or {}
        step_age = serving.get("last_step_age_seconds")
        if (wedge_after and int(serving.get("in_flight", 0) or 0) > 0
                and step_age is not None
                and (float(step_age)
                     + float(progress.get("age_seconds", 0.0)) > wedge_after)):
            return "pipeline-wedged"
        return None         # idle-but-alive: healthy by heartbeat alone
    age = progress.get("last_event_age_seconds")
    if wedge_after and age is not None:
        # The event age was measured when the heartbeat wrote the file; the
        # file's own age has accrued since.
        if float(age) + float(progress.get("age_seconds", 0.0)) > wedge_after:
            return "pipeline-wedged"
    return None


def _emit_events(output_dir: str,
                 events: Sequence[Tuple[str, Dict[str, Any]]],
                 filename: Optional[str] = None) -> None:
    """Append supervisor point events to the sweep's ``_events.jsonl`` (or a
    fleet worker's ``_events.<wid>.jsonl``).

    Called only while no child is running, so the tracer's tail-resumed
    ``seq`` keeps the merged stream monotone (``obs.trace``).  Fail-open:
    supervision never depends on telemetry."""
    try:
        from taboo_brittleness_tpu_torch.obs import trace

        t = trace.Tracer(os.path.join(output_dir,
                                      filename or trace.EVENTS_FILENAME))
        try:
            for name, attrs in events:
                t.event(name, **attrs)
        finally:
            t.close()
    except Exception:  # noqa: BLE001 — telemetry must never block supervision
        pass


def _merge_run_artifacts(output_dir: str, result: SuperviseResult,
                         *, filename: str = SUPERVISE_FILENAME,
                         fold_manifest: bool = True) -> None:
    """Make the directory read as ONE run: persist the incarnation history
    to ``_supervise.json`` and fold it into the child's ``run_manifest.json``
    (which lives either in ``output_dir`` or one level up — the pipelines
    write per-word artifacts into a ``words/`` subdirectory).  Fleet workers
    (``fold_manifest=False``) skip the manifest fold: N workers share one
    directory, and the fleet merge owns the combined view."""
    try:
        atomic_json_dump(result.to_dict(),
                         os.path.join(output_dir, filename))
    except OSError:
        pass
    if not fold_manifest:
        return
    for cand in (output_dir, os.path.dirname(os.path.abspath(output_dir))):
        path = os.path.join(cand, "run_manifest.json")
        if not os.path.isfile(path):
            continue
        try:
            with open(path) as f:
                manifest = json.load(f)
            manifest["incarnations"] = {
                "count": len(result.incarnations),
                "status": result.status,
                "history": result.incarnations,
            }
            atomic_json_dump(manifest, path)
        except (OSError, ValueError):
            continue


def _hard_kill(proc: "subprocess.Popen") -> None:
    try:
        proc.kill()
    except OSError:
        pass


def supervise(
    child_argv: Sequence[str],
    output_dir: str,
    *,
    max_incarnations: Optional[int] = None,
    poll_interval: Optional[float] = None,
    grace: Optional[float] = None,
    wedge_after: Optional[float] = None,
    policy: Optional[RetryPolicy] = None,
    env: Optional[Dict[str, str]] = None,
    worker_id: Optional[str] = None,
    sleep=time.sleep,
) -> SuperviseResult:
    """Run ``child_argv`` under the supervisor until it finishes, drains,
    quarantines, or exhausts the incarnation budget.  See the module
    docstring for the full state machine; parameters default to the
    ``TBX_SUPERVISE_*`` env knobs.

    ``output_dir`` is the directory the child heartbeats ``_progress.json``
    into (for the packaged pipelines: the per-word results directory).  The
    supervisor only ever READS the child's files, except for the merged
    ``_supervise.json``/manifest block it writes after the run.

    ``worker_id`` puts the supervisor in FLEET-WORKER mode
    (``runtime.fleet``): the child gets ``TBX_WORKER_ID`` in its env, its
    telemetry lands in per-worker files (``_progress.<wid>.json``,
    ``_events.<wid>.jsonl``, ``_supervise.<wid>.json``) so N supervised
    workers can share one output directory without interleaving each
    other's seq counters, and the run-manifest fold is left to the fleet
    merge.  The wedge classifier, restart budget, and drain contract are
    identical — the fleet reuses, not reimplements, this state machine.
    """
    max_incarnations = (max_incarnations if max_incarnations is not None
                        else _env_int("TBX_SUPERVISE_MAX_INCARNATIONS", 5))
    poll_interval = (poll_interval if poll_interval is not None
                     else _env_float("TBX_SUPERVISE_POLL_S", 1.0))
    grace = grace if grace is not None else _env_float("TBX_SUPERVISE_GRACE_S",
                                                       15.0)
    wedge_after = (wedge_after if wedge_after is not None
                   else _env_float("TBX_SUPERVISE_WEDGE_S", 300.0))
    policy = policy or RetryPolicy(
        max_retries=max(max_incarnations - 1, 0),
        base_delay=_env_float("TBX_SUPERVISE_BACKOFF_S", 2.0),
        max_delay=60.0)
    if max_incarnations < 1:
        raise ValueError("max_incarnations must be >= 1")

    from taboo_brittleness_tpu_torch.obs.progress import (
        PROGRESS_FILENAME, read_progress)

    os.makedirs(output_dir, exist_ok=True)
    progress_name = (PROGRESS_FILENAME if worker_id is None
                     else f"_progress.{worker_id}.json")
    events_name = (None if worker_id is None
                   else f"_events.{worker_id}.jsonl")
    supervise_name = (SUPERVISE_FILENAME if worker_id is None
                      else f"_supervise.{worker_id}.json")
    progress_path = os.path.join(output_dir, progress_name)
    backoff = policy.delays(f"supervise:{worker_id or ''}")
    history: List[Dict[str, Any]] = []
    final_rc: Optional[int] = None
    status = "budget-exhausted"

    for incarnation in range(max_incarnations):
        _emit_events(output_dir,
                     [("supervise.launch",
                       {"incarnation": incarnation,
                        **({"worker": worker_id} if worker_id else {})})],
                     events_name)
        child_env = dict(os.environ)
        if env:
            child_env.update(env)
        child_env[INCARNATION_ENV] = str(incarnation)
        if worker_id is not None:
            child_env[WORKER_ENV] = worker_id
        t0 = time.monotonic()
        proc = subprocess.Popen(list(child_argv), env=child_env)
        rec: Dict[str, Any] = {
            "incarnation": incarnation,
            "pid": proc.pid,
            # Epoch timestamp: serialized metadata for humans, not duration
            # math (wall_seconds below uses the monotonic mark).
            # tbx: wallclock-ok — serialized metadata (duration uses t0)
            "started_at": time.time(),
        }

        wedge = None
        forwarded_at: Optional[float] = None
        killed_at: Optional[float] = None
        while proc.poll() is None:
            now = time.monotonic()
            if _CONTROLLER.requested() and forwarded_at is None:
                # The supervisor's own preemption notice: forward it so the
                # child drains, then propagate EXIT_DRAINED below.
                try:
                    proc.terminate()
                except OSError:
                    pass
                forwarded_at = now
            if forwarded_at is not None:
                if now - forwarded_at > grace:
                    _hard_kill(proc)
                sleep(poll_interval)
                continue
            if wedge is None:
                progress = read_progress(progress_path, missing_ok=True)
                wedge = _wedge_reason(progress, proc.pid, wedge_after)
                if wedge is not None:
                    # SIGTERM first (the drain chance), SIGKILL after grace.
                    try:
                        proc.terminate()
                    except OSError:
                        pass
                    killed_at = now
            elif killed_at is not None and now - killed_at > grace:
                _hard_kill(proc)
            sleep(poll_interval)
        rc = proc.wait()
        rec["exit_code"] = rc
        rec["wall_seconds"] = round(time.monotonic() - t0, 3)

        if forwarded_at is not None:
            # Supervisor-initiated drain.  A child that finished anyway
            # still counts as done; anything else propagates "resumable".
            rec["outcome"] = "done" if rc == 0 else "drained"
            history.append(rec)
            final_rc = 0 if rc == 0 else EXIT_DRAINED
            status = "done" if rc == 0 else "drained"
            _emit_events(output_dir, [("supervise.drain",
                                       {"incarnation": incarnation,
                                        "exit_code": rc})], events_name)
            break
        if wedge is not None:
            rec["outcome"] = "wedged"
            rec["reason"] = wedge
            history.append(rec)
            _emit_events(output_dir, [("supervise.wedged",
                                       {"incarnation": incarnation,
                                        "reason": wedge, "exit_code": rc})],
                         events_name)
        elif rc == 0:
            rec["outcome"] = "done"
            history.append(rec)
            final_rc = 0
            status = "done"
            break
        elif rc == EXIT_DRAINED:
            # An externally delivered preemption the child drained on its
            # own: a clean checkpoint boundary — resume without backoff.
            rec["outcome"] = "drained"
            history.append(rec)
            continue
        elif rc == EXIT_QUARANTINED and read_progress(
                progress_path, missing_ok=True).get("workload") == "serve":
            # A SWEEP's exit 1 means "completed, words quarantined" — the
            # in-process retry budget is spent and rerunning replays the
            # failure, so the supervisor passes it through.  A SERVER has no
            # such semantics: its exit 1 is a crash (an exception escaped the
            # serve loop), and passing it through would let a crash loop
            # masquerade as completion — burn an incarnation instead.
            rec["outcome"] = "crashed"
            rec["reason"] = "serve-exit-1"
            history.append(rec)
            _emit_events(output_dir, [("supervise.crash",
                                       {"incarnation": incarnation,
                                        "reason": "serve-exit-1",
                                        "exit_code": rc})], events_name)
        elif rc == EXIT_QUARANTINED:
            rec["outcome"] = "quarantined"
            history.append(rec)
            final_rc = EXIT_QUARANTINED
            status = "quarantined"
            break
        else:
            rec["outcome"] = "crashed"
            history.append(rec)
        # Crash/wedge restart: seeded-jitter backoff, bounded by the budget.
        if incarnation + 1 < max_incarnations:
            delay = next(backoff, None)
            if delay is None:
                delay = policy.max_delay
            if delay > 0:
                sleep(delay)
        else:
            final_rc = rc if rc not in (0, None) else 1

    if final_rc is None:
        final_rc = history[-1]["exit_code"] if history else 1
        if final_rc in (0, None):
            final_rc = 1
        if history and history[-1]["outcome"] == "drained":
            # The budget's last incarnation itself drained: the run is still
            # RESUMABLE (exit 75), not failed — label it so.
            status = "drained"
    result = SuperviseResult(exit_code=int(final_rc), status=status,
                             incarnations=history)
    _emit_events(output_dir,
                 [("supervise.exit",
                   {"status": result.status,
                    "exit_code": result.exit_code,
                    "incarnations": len(history),
                    **({"worker": worker_id} if worker_id else {})})],
                 events_name)
    _merge_run_artifacts(output_dir, result, filename=supervise_name,
                         fold_manifest=worker_id is None)
    return result
