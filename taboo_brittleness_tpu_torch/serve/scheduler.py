"""Slot scheduler: admission control, scenario multiplexing, SLO metrics.

The host half of the serving subsystem.  The engine (``serve.engine``) owns
the device batch; this module owns the REQUEST lifecycle:

    submit -> (bounded queue) -> admit into a free slot -> step*N -> complete
                 |                                           |
                 +-- rejected (queue full / draining)        +-- quarantined
                                                                 (serve.step
                                                                  fault)

Scenarios are the paper's brittleness probes as per-request serving config:
plain chat, SAE-latent ablation, low-rank projection removal, token-forcing
prefill, and the logit-lens readout tap — every combination multiplexes into
the ONE compiled step program (per-slot data switches; see engine docstring).

SLO surfaces (``obs.metrics``, snapshotted into the run manifest):

- ``serve.latency.<scenario>`` — end-to-end seconds, submit→complete (the
  per-scenario p50/p99 the loadgen and bench report);
- ``serve.queue_wait`` — seconds spent queued before a slot freed;
- ``serve.in_flight`` / ``serve.queue_depth`` — live gauges;
- ``serve.admitted`` / ``serve.rejected`` / ``serve.completed`` /
  ``serve.quarantined`` / ``serve.steps`` — counters.

Failure isolation: every step fires the ``serve.step`` fault site once per
in-flight session (context: request id + scenario), so a seeded
``TABOO_FAULT_PLAN`` can poison ONE session; the scheduler quarantines
exactly that session (error response, slot recycled) and the rest of the
batch keeps decoding — the sweep's quarantine-and-continue stance at
request granularity.

Drain: ``drain()`` flips admission off (submits are rejected) while
queued and in-flight sessions run to completion — the SIGTERM contract of
``tbx serve``.

The PyTorch port's copy of the JAX package's ``serve/scheduler.py``.  One
difference: :meth:`SlotScheduler._basis` draws a request's projection
basis from a CPU ``torch.Generator`` seeded with JAX's integer, so the
bases differ from the JAX package's for the same seed (same
distribution).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import flightrec
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.obs import reqtrace, timeseries
from taboo_brittleness_tpu_torch.obs import trace as obs_trace
from taboo_brittleness_tpu_torch.ops import projection
from taboo_brittleness_tpu_torch.runtime import chat, resilience
from taboo_brittleness_tpu_torch.runtime.resilience import current_worker_id
from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

#: Typed admission-rejection reasons: every rejected submit and
#: every rejected :class:`Response` carries exactly one of these, so the
#: router, the spool, and the tests key off constants instead of prose.
REJECT_DRAINING = "draining"
REJECT_QUEUE_FULL = "queue-full"
REJECT_UNKNOWN_WORD = "unknown-word"
REJECT_PROMPT_TOO_LONG = "prompt-too-long"
REJECT_UNKNOWN_SCENARIO = "unknown-scenario"   # server-side (pre-submit)
REJECT_ALL_REPLICAS_BURNING = "all-replicas-burning"  # router shed
REJECT_FLEET_SATURATED = "fleet-saturated"     # router shed: no free slots
REJECT_TENANT_QUOTA = "tenant-quota"           # gateway token-bucket shed

#: Typed TERMINAL finish reasons beyond eos/budget/quarantined:
#: a canceled request (client disconnected mid-stream; the gateway's cancel
#: tombstone) and a deadline-expired one (``X-Tbx-Deadline-Ms`` rode the
#: payload and ran out) both resolve with an explicit response — never
#: silently dropped, never a synthesized fleet-merge error.
FINISH_CANCELED = "canceled"
FINISH_DEADLINE = "deadline-exceeded"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One per-request probe configuration.

    ``ablate_latents`` — SAE latent ids zeroed in-graph at the engine's SAE
    layer (empty = off).  ``proj_rank`` — rank of a seeded random orthonormal
    subspace removed at the projection layer (0 = off).  ``prefill`` — text
    the model turn is forced to open with (token forcing, paper App. D.4).
    ``lens_readout`` — per-step P(secret) at the tap layer rides back with
    the response.  ``max_new_tokens`` — per-session generation budget.
    ``adaptive_depth``/``exit_margin`` — the speculative engine's opt-in
    quality/latency dial: drafted tokens whose lens-logit margin
    exceeds ``exit_margin`` emit at the draft layer without requiring
    full-depth agreement; the response reports how many exited early and
    how often they agreed anyway.  Ignored (plain chat) on a vanilla
    engine, and inert unless ``adaptive_depth`` is set — every other
    scenario keeps the lossless contract.
    """

    name: str
    ablate_latents: tuple = ()
    proj_rank: int = 0
    prefill: Optional[str] = None
    lens_readout: bool = False
    max_new_tokens: int = 24
    adaptive_depth: bool = False
    exit_margin: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def default_scenarios(*, max_new_tokens: int = 24,
                      ablate_latents: Sequence[int] = (0, 1, 2, 3),
                      proj_rank: int = 2,
                      forcing_prefill: str = "My secret word is",
                      adaptive_exit_margin: float = 2.0,
                      ) -> Dict[str, Scenario]:
    """The serving scenario menu — one per probe family the paper sweeps,
    plus the speculative engine's adaptive-depth arm (a plain chat on a
    vanilla engine) so loadgen mixes A/B it against the lossless path."""
    mk = lambda **kw: Scenario(max_new_tokens=max_new_tokens, **kw)
    return {
        "chat": mk(name="chat"),
        "chat_lens": mk(name="chat_lens", lens_readout=True),
        "sae_ablate": mk(name="sae_ablate",
                         ablate_latents=tuple(ablate_latents),
                         lens_readout=True),
        "projection": mk(name="projection", proj_rank=proj_rank),
        "forcing": mk(name="forcing", prefill=forcing_prefill),
        "adaptive_depth": mk(name="adaptive_depth", adaptive_depth=True,
                             exit_margin=adaptive_exit_margin),
    }


@dataclasses.dataclass
class Request:
    id: str
    prompt: str
    scenario: Scenario
    seed: int = 0
    submitted_at: float = 0.0      # monotonic; stamped by submit()
    word: Optional[str] = None     # taboo word; None = the engine's default
    # Distributed trace context (obs.reqtrace: trace_id/attempt/...) carried
    # in from the request payload; None = untraced (legacy / direct tests).
    trace: Optional[Dict[str, Any]] = None
    # Two-level admission priority: >0 = high (the gateway maps
    # tenant quota config onto this) — high-priority requests drain first
    # when slots free up; within a level, FIFO.
    priority: int = 0
    # Absolute wall-clock (epoch) deadline stamped by the gateway from
    # X-Tbx-Deadline-Ms; None = no deadline.  Epoch, not monotonic, because
    # it crosses the gateway->spool->replica process boundary.
    deadline_at: Optional[float] = None

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.get("trace_id") if self.trace else None

    @property
    def attempt(self) -> int:
        return int(self.trace.get("attempt", 0)) if self.trace else 0


@dataclasses.dataclass
class Response:
    id: str
    scenario: str
    ok: bool
    word: Optional[str] = None
    text: str = ""
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish: str = ""               # eos | budget | quarantined
    steps: int = 0
    queue_seconds: float = 0.0
    latency_seconds: float = 0.0
    lens_probs: Optional[List[float]] = None
    error: Optional[str] = None
    # Which replica worker answered (``TBX_WORKER_ID``; None standalone) —
    # the serve-fleet e2e reads this to prove re-spooled requests were
    # answered by a replica other than the dead holder.
    replica: Optional[str] = None
    # Typed admission-rejection reason (REJECT_*; None when served).
    reject_reason: Optional[str] = None
    # Speculation accounting (always 0/None on a vanilla engine).
    drafted: int = 0
    accepted: int = 0
    exited_early: int = 0
    early_agreement: Optional[float] = None
    # Distributed-trace stamp (obs.reqtrace): the trace this response
    # resolves, which attempt answered, and submit→first-token seconds on
    # the serving attempt (None before the first token / when untraced).
    trace_id: Optional[str] = None
    attempt: int = 0
    ttft_seconds: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Session:
    request: Request
    slot: int
    admitted_at: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    lens_probs: List[float] = dataclasses.field(default_factory=list)
    steps: int = 0
    drafted: int = 0
    accepted: int = 0
    early: int = 0
    early_agree: int = 0
    # Request-lifecycle span (kind="request", off the thread stack) opened
    # at submit; NULL_SPAN when no tracer is active.
    span: Any = obs_trace.NULL_SPAN
    ttft_seconds: Optional[float] = None


class SlotScheduler:
    """Admission-controlled continuous batching over one :class:`ServeEngine`.

    Single-threaded by design: the serve loop owns ``submit``/``step``.
    ``on_complete`` (optional) fires with each :class:`Response` as it
    resolves — the server's spool writer and the loadgen's collector hook.
    ``on_token`` (optional) fires as ``on_token(request, token_id, n)``
    with every emitted token as it lands (``n`` = tokens emitted so far,
    including this one) — the server's token-spool writer the gateway
    tails for per-token SSE streaming.  Fail-open: a raising
    hook drops that stream write (counted), never the session.
    """

    def __init__(self, engine: ServeEngine, *,
                 queue_limit: int = 64,
                 lens_target_id: int = -1,
                 on_complete: Optional[Callable[[Response], None]] = None,
                 on_token: Optional[Callable[[Request, int, int],
                                             None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.queue_limit = int(queue_limit)
        # Autotuned admission width: slots at index >= slot_limit
        # never admit — the engine keeps its compiled shape (the FULL slot
        # batch steps; surplus rows just stay frozen) while the HBM-watermark
        # solver caps how many sessions are concurrently resident.
        self.slot_limit = int(engine.ec.slots)
        self.lens_target_id = int(lens_target_id)
        self.on_complete = on_complete
        self.on_token = on_token
        self._clock = clock
        self._queue: Deque[Request] = deque()
        # High-priority lane (Request.priority > 0): drains before _queue
        # when slots free; both lanes share ONE queue_limit so priority
        # reorders, never enlarges, the admission window.
        self._queue_hi: Deque[Request] = deque()
        self._sessions: Dict[int, _Session] = {}      # slot -> session
        # Request-lifecycle spans opened at submit, adopted by the session
        # at admit (queued requests own a span before they own a slot).
        self._req_spans: Dict[str, Any] = {}
        self._scenarios_completed: set = set()
        self._speculative = bool(getattr(engine, "speculative", False))
        self._accept: Dict[str, Dict[str, int]] = {}  # scenario -> totals
        self.draining = False
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.quarantined = 0
        self.canceled = 0
        self.deadline_expired = 0
        # Why the most recent submit() returned False (a REJECT_* constant):
        # the caller builds its typed rejected Response from this without
        # changing the bool submit contract.
        self.last_reject_reason: Optional[str] = None

    # -- introspection -------------------------------------------------------

    @property
    def in_flight(self) -> int:
        return len(self._sessions)

    @property
    def queue_depth(self) -> int:
        return len(self._queue) + len(self._queue_hi)

    @property
    def idle(self) -> bool:
        return not (self._sessions or self._queue or self._queue_hi)

    def set_slot_limit(self, width: int) -> int:
        """Install the autotuner's solved width as the admission cap,
        clamped to the engine's compiled envelope.  Lowering the cap never
        evicts an in-flight session — slots above the cap drain naturally
        and then stop readmitting.  Returns the installed cap."""
        self.slot_limit = max(1, min(int(width), self.engine.ec.slots))
        return self.slot_limit

    def occupancy(self) -> Dict[str, int]:
        """The heartbeat's ``slots`` view: autotuned width, sessions
        resident, and how many admissions remain before saturation."""
        return {"width": self.slot_limit, "active": self.in_flight,
                "free": max(0, self.slot_limit - self.in_flight)}

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admission control: False (rejected) when draining, when the
        bounded queue is full, or when the request cannot fit the engine's
        shape envelope.  True = the request WILL be served (queued or
        admitted on the next ``step``)."""
        if self.draining or self.queue_depth >= self.queue_limit:
            self._reject(req, REJECT_DRAINING if self.draining
                         else REJECT_QUEUE_FULL)
            return False
        if self.engine.word_index(req.word) is None:
            # Admission is by (word, scenario): a word this engine does not
            # hold resident is an explicit rejection, not a silent default.
            self._reject(req, REJECT_UNKNOWN_WORD, word=req.word)
            return False
        ids = self._encode(req)
        if not self.engine.capacity_ok(len(ids), req.scenario.max_new_tokens):
            self._reject(req, REJECT_PROMPT_TOO_LONG)
            return False
        self.last_reject_reason = None
        req.submitted_at = self._clock()
        (self._queue_hi if req.priority > 0 else self._queue).append(req)
        obs_metrics.gauge("serve.queue_depth").set(self.queue_depth)
        obs.event("serve.request", request=req.id,
                  scenario=req.scenario.name, prompt_tokens=len(ids),
                  **({"trace": req.trace_id} if req.trace_id else {}))
        # Per-request lifecycle span (obs.reqtrace): detached from the
        # thread stack (many requests interleave on this one thread),
        # parented under the serve run span, ended by _finish.  Flushed
        # immediately so a replica killed mid-decode leaves the START on
        # disk — the fleet merge then closes it with a synthesized error
        # end, which is the dead attempt the waterfall shows.
        tracer = obs_trace.get_tracer()
        if tracer is not None:
            try:
                self._req_spans[req.id] = tracer.span_detached(
                    reqtrace.REQUEST_SPAN, kind="request", request=req.id,
                    scenario=req.scenario.name, attempt=req.attempt,
                    **({"trace": req.trace_id} if req.trace_id else {}))
                tracer.flush()
            except Exception:  # noqa: BLE001 — tracing is fail-open
                pass
        self._fill_slots()
        return True

    def _reject(self, req: Request, reason: str, **attrs: Any) -> None:
        self.rejected += 1
        self.last_reject_reason = reason
        obs_metrics.counter("serve.rejected").inc()
        obs.event("serve.reject", request=req.id,
                  scenario=req.scenario.name, reason=reason, **attrs)

    def active_ids(self) -> List[str]:
        """Request ids this scheduler currently owns (queued + in-flight) —
        the server's mid-run claimed-but-unanswered audit subtracts these."""
        return ([s.request.id for s in self._sessions.values()]
                + [r.id for r in self._queue_hi]
                + [r.id for r in self._queue])

    def drain(self) -> None:
        """Stop admitting; in-flight AND already-queued sessions run to
        completion (they were accepted — zero dropped responses), new
        submits are rejected."""
        if not self.draining:
            self.draining = True
            obs.event("serve.drain", in_flight=self.in_flight,
                      queued=self.queue_depth)

    def _encode(self, req: Request) -> List[int]:
        rendered = (chat.render_chat([chat.Turn("user", req.prompt)],
                                     prefill=req.scenario.prefill)
                    if req.scenario.prefill is not None
                    else chat.user_prompt(req.prompt))
        return self.engine.tok.encode(rendered)

    def _basis(self, req: Request) -> Optional[np.ndarray]:
        """The request's seeded random orthonormal [D, r] basis: a CPU
        ``torch.Generator`` seeded with ``seed & 0x7FFFFFFF``, JAX's key
        integer (the draws differ from ``jax.random``'s)."""
        if req.scenario.proj_rank <= 0:
            return None
        gen = torch.Generator().manual_seed(req.seed & 0x7FFFFFFF)
        rank = min(req.scenario.proj_rank, self.engine.ec.proj_rank)
        return projection.random_subspace(
            gen, self.engine.cfg.hidden_size, rank).numpy()

    @staticmethod
    def _now_epoch() -> float:
        # tbx: wallclock-ok — deadlines cross processes, stamped as epoch
        return time.time()

    def _expired(self, req: Request) -> bool:
        return (req.deadline_at is not None
                and self._now_epoch() > req.deadline_at)

    def _next_queued(self) -> Optional[Request]:
        """Pop the next admissible request: high-priority lane first, and
        deadline-expired entries resolve typed HERE (never decoded, never
        dropped) without consuming the slot."""
        while self._queue_hi or self._queue:
            req = (self._queue_hi.popleft() if self._queue_hi
                   else self._queue.popleft())
            if self._expired(req):
                self._resolve_queued(req, FINISH_DEADLINE)
                continue
            return req
        return None

    def _fill_slots(self) -> None:
        if not (self._queue or self._queue_hi):
            return
        for slot in self.engine.free_slots():
            if slot >= self.slot_limit:
                continue   # above the autotuned width: never admits
            req = self._next_queued()
            if req is None:
                break
            now = self._clock()
            sc = req.scenario
            word_id = self.engine.word_index(req.word)
            extra: Dict[str, Any] = {}
            if self._speculative:
                # The adaptive-depth dial is per REQUEST: lossless (-1)
                # unless the scenario opts in with its own margin.
                extra["exit_margin"] = (sc.exit_margin if sc.adaptive_depth
                                        else -1.0)
            self.engine.admit(
                slot, self._encode(req),
                max_new=sc.max_new_tokens,
                latent_ids=sc.ablate_latents,
                basis=self._basis(req),
                lens_target=(self.lens_target_id if sc.lens_readout else -1),
                word_id=0 if word_id is None else word_id, **extra)
            span = self._req_spans.pop(req.id, obs_trace.NULL_SPAN)
            self._sessions[slot] = _Session(request=req, slot=slot,
                                            admitted_at=now, span=span)
            self.admitted += 1
            queue_wait = now - req.submitted_at
            span.set(slot=slot, queue_seconds=round(queue_wait, 6))
            obs_metrics.counter("serve.admitted").inc()
            obs_metrics.histogram("serve.queue_wait").observe(queue_wait)
            obs.event("serve.admit", request=req.id, slot=slot,
                      scenario=sc.name, queue_seconds=round(queue_wait, 4),
                      **({"word": req.word} if req.word else {}))
        obs_metrics.gauge("serve.in_flight").set(len(self._sessions))
        obs_metrics.gauge("serve.queue_depth").set(self.queue_depth)

    # -- cancellation / typed queued terminals --------------------

    def cancel(self, rid: str) -> bool:
        """Resolve one request as ``canceled`` (the gateway's client-
        disconnect tombstone, observed by the serve loop between steps —
        for the speculative engine that boundary IS the verify-block
        boundary, since each scheduler step is one draft+verify block).
        Queued: removed and answered without decoding.  In-flight: the
        slot is released and the partial stream resolves typed.  Returns
        False when this scheduler does not own the request (already
        resolved, or never claimed here)."""
        for q in (self._queue_hi, self._queue):
            for req in q:
                if req.id == rid:
                    q.remove(req)
                    self._resolve_queued(req, FINISH_CANCELED)
                    obs_metrics.gauge("serve.queue_depth").set(
                        self.queue_depth)
                    return True
        for slot, sess in list(self._sessions.items()):
            if sess.request.id == rid:
                resp = self._finish(slot, FINISH_CANCELED)
                self._after_step([resp])
                return True
        return False

    def _count_typed_terminal(self, finish: str) -> None:
        if finish == FINISH_CANCELED:
            self.canceled += 1
            obs_metrics.counter("serve.canceled").inc()
        elif finish == FINISH_DEADLINE:
            self.deadline_expired += 1
            obs_metrics.counter("serve.deadline_exceeded").inc()

    def _resolve_queued(self, req: Request, finish: str) -> Response:
        """Typed terminal for a request that never reached a slot (canceled
        or deadline-expired while queued): explicit response, span closed
        terminal with zero tokens — exactly-once still holds."""
        now = self._clock()
        waited = (round(now - req.submitted_at, 6)
                  if req.submitted_at else 0.0)
        resp = Response(
            id=req.id, scenario=req.scenario.name, ok=False, word=req.word,
            finish=finish, queue_seconds=waited, latency_seconds=waited,
            replica=current_worker_id(),
            trace_id=req.trace_id, attempt=req.attempt)
        self._count_typed_terminal(finish)
        obs.event("serve.complete", request=req.id,
                  scenario=req.scenario.name, finish=finish, steps=0,
                  ok=False, latency_seconds=waited)
        span = self._req_spans.pop(req.id, obs_trace.NULL_SPAN)
        span.set(terminal=True, finish=finish, steps=0, emitted=0,
                 latency_seconds=waited)
        span.end()
        tracer = obs_trace.get_tracer()
        if tracer is not None:
            try:
                tracer.flush()
            except Exception:  # noqa: BLE001 — tracing is fail-open
                pass
        if self.on_complete is not None:
            self.on_complete(resp)
        return resp

    # -- stepping ------------------------------------------------------------

    def step(self) -> List[Response]:
        """One engine step plus bookkeeping; returns sessions that resolved.

        The ``serve.step`` fault site fires once per in-flight session
        BEFORE the launch: an armed fault that matches one session's
        request/scenario poisons only that session (quarantined below) —
        the launch then proceeds for the surviving batch.
        """
        if not self._sessions:
            self._fill_slots()
            if not self._sessions:
                return []
        responses: List[Response] = []
        # Deadline sweep BETWEEN steps — for the speculative engine this is
        # between verify blocks (one scheduler step = one draft+verify
        # block): an expired in-flight session resolves typed and releases
        # its slot before the next launch.
        for slot, sess in list(self._sessions.items()):
            if self._expired(sess.request):
                responses.append(self._finish(slot, FINISH_DEADLINE))
        if not self._sessions:
            self._after_step(responses)
            return responses
        # Flight-recorder step record BEFORE the fault site fires, so a
        # poisoned step is IN the ring the quarantine dump freezes.
        flightrec.record("serve.step",
                         in_flight=len(self._sessions),
                         requests=[s.request.id
                                   for s in self._sessions.values()])
        for slot, sess in list(self._sessions.items()):
            try:
                # ``worker`` joins the context so a fleet chaos plan can
                # poison ONE replica (match: "w1") instead of one request.
                resilience.fire("serve.step", request=sess.request.id,
                                scenario=sess.request.scenario.name,
                                worker=current_worker_id() or "")
                if self._speculative:
                    self._fire_spec_verify(sess)
            except Exception as exc:  # noqa: BLE001 — quarantine one session
                responses.append(self._finish(slot, "quarantined", exc=exc))
        if not self._sessions:
            self._after_step(responses)
            return responses

        out = self.engine.step()
        obs_metrics.counter("serve.steps").inc()
        multi_col = hasattr(out, "toks")      # SpecStepOut: [S, G+1] columns
        step_drafted = step_accepted = 0
        for slot, sess in list(self._sessions.items()):
            sess.steps += 1
            if multi_col:
                for j in range(out.toks.shape[1]):
                    if bool(out.emit[slot, j]):
                        if not sess.tokens:
                            self._first_token(sess)
                        sess.tokens.append(int(out.toks[slot, j]))
                        self._emit_token(sess)
                        if sess.request.scenario.lens_readout:
                            sess.lens_probs.append(
                                float(out.lens_prob[slot, j]))
                drafted = int(out.drafted[slot])
                accepted = int(out.accepted[slot])
                sess.drafted += drafted
                sess.accepted += accepted
                step_drafted += drafted
                step_accepted += accepted
                sess.early += int(out.early[slot])
                sess.early_agree += int(out.early_agree[slot])
            elif bool(out.emitted[slot]):
                if not sess.tokens:
                    self._first_token(sess)
                sess.tokens.append(int(out.tok[slot]))
                self._emit_token(sess)
                if sess.request.scenario.lens_readout:
                    sess.lens_probs.append(float(out.lens_prob[slot]))
            if bool(out.finished[slot]):
                stop_hit = sess.tokens and sess.tokens[-1] in self.engine.ec.stop_ids
                responses.append(
                    self._finish(slot, "eos" if stop_hit else "budget"))
        if step_drafted:
            # Windowed accept_rate rides the timeseries spool as counter
            # deltas — the live signal Sequoia-style (k, G) recalibration
            # and the spec_accept SLO need (exit summary alone hides drift).
            obs_metrics.counter("serve.spec.drafted").inc(step_drafted)
            obs_metrics.counter("serve.spec.accepted").inc(step_accepted)
        self._after_step(responses)
        return responses

    def _first_token(self, sess: _Session) -> None:
        """TTFT mark: submit → the session's FIRST emitted token (this
        attempt's clock — a re-spooled request restarts it on the surviving
        replica).  One point event parented to the request span plus the
        ``serve.ttft.<scenario>`` observation at _finish."""
        req = sess.request
        sess.ttft_seconds = round(self._clock() - req.submitted_at, 6)
        sess.span.event(
            reqtrace.FIRST_TOKEN_POINT, request=req.id,
            attempt=req.attempt, ttft_seconds=sess.ttft_seconds,
            **({"trace": req.trace_id} if req.trace_id else {}))

    def _emit_token(self, sess: _Session) -> None:
        """Per-token streaming hook (the server's token-spool writer; the
        gateway tails it for SSE).  Fail-open: a raising hook drops that
        write — the response file stays the authoritative stream."""
        if self.on_token is None:
            return
        try:
            self.on_token(sess.request, sess.tokens[-1], len(sess.tokens))
        except Exception:  # noqa: BLE001 — streaming is fail-open
            obs_metrics.counter("serve.stream_dropped").inc()

    def _fire_spec_verify(self, sess: _Session) -> None:
        """The ``serve.spec.verify`` fault site, with ONE in-place retry:
        a transient fault (``times: 1`` plan) costs a retry event and the
        block proceeds; a persistent one (``times >= 2`` or mode ``die``)
        propagates and quarantines exactly this session — the batch and
        every other slot keep decoding."""
        ctx = dict(request=sess.request.id,
                   scenario=sess.request.scenario.name)
        try:
            resilience.fire("serve.spec.verify", **ctx)
        except resilience.InjectedPermanentFault:
            raise
        except Exception as exc:  # noqa: BLE001 — transient: retry once
            obs.event("serve.spec.retry", request=sess.request.id,
                      error=f"{type(exc).__name__}: {exc}"[:200])
            resilience.fire("serve.spec.verify", attempt=1, **ctx)

    def _after_step(self, responses: List[Response]) -> None:
        if responses:
            self._fill_slots()
        obs_metrics.gauge("serve.in_flight").set(len(self._sessions))

    def _finish(self, slot: int, finish: str,
                exc: Optional[BaseException] = None) -> Response:
        sess = self._sessions.pop(slot)
        self.engine.release(slot)
        now = self._clock()
        req = sess.request
        # Canceled / deadline-expired sessions are typed terminals: not ok
        # (the client did not get a completed stream), not an error (no
        # exception; the span closes status="ok" with finish carrying the
        # reason — never the fleet-merge's synthesized error).
        typed = exc is None and finish in (FINISH_CANCELED, FINISH_DEADLINE)
        ok = exc is None and not typed
        resp = Response(
            id=req.id, scenario=req.scenario.name, ok=ok, word=req.word,
            text=self.engine.tok.decode(sess.tokens) if sess.tokens else "",
            tokens=list(sess.tokens), finish=finish, steps=sess.steps,
            queue_seconds=round(sess.admitted_at - req.submitted_at, 6),
            latency_seconds=round(now - req.submitted_at, 6),
            lens_probs=(list(sess.lens_probs)
                        if req.scenario.lens_readout else None),
            error=f"{type(exc).__name__}: {exc}"[:300] if exc else None,
            replica=current_worker_id(),
            drafted=sess.drafted, accepted=sess.accepted,
            exited_early=sess.early,
            early_agreement=(round(sess.early_agree / sess.early, 4)
                             if sess.early else None),
            trace_id=req.trace_id, attempt=req.attempt,
            ttft_seconds=sess.ttft_seconds)
        if ok:
            self.completed += 1
            self._scenarios_completed.add(req.scenario.name)
            flightrec.record("serve.complete", request=req.id,
                             scenario=req.scenario.name, finish=finish,
                             latency_s=resp.latency_seconds)
            obs_metrics.counter("serve.completed").inc()
            obs_metrics.histogram(
                f"serve.latency.{req.scenario.name}").observe(
                resp.latency_seconds)
            reqtrace.note_exemplar(f"serve.latency.{req.scenario.name}",
                                   req.trace_id, resp.latency_seconds)
            if sess.ttft_seconds is not None:
                obs_metrics.histogram(
                    f"serve.ttft.{req.scenario.name}").observe(
                    sess.ttft_seconds)
                reqtrace.note_exemplar(f"serve.ttft.{req.scenario.name}",
                                       req.trace_id, sess.ttft_seconds)
            if self._speculative:
                agg = self._accept.setdefault(req.scenario.name, {
                    "responses": 0, "emitted": 0, "steps": 0,
                    "drafted": 0, "accepted": 0,
                    "exited_early": 0, "early_agree": 0})
                agg["responses"] += 1
                agg["emitted"] += len(sess.tokens)
                agg["steps"] += sess.steps
                agg["drafted"] += sess.drafted
                agg["accepted"] += sess.accepted
                agg["exited_early"] += sess.early
                agg["early_agree"] += sess.early_agree
        elif typed:
            # Canceled / deadline-expired: neither completed (no latency
            # observation — an aborted stream is not a served request) nor
            # quarantined (nothing is broken; no flightrec postmortem).
            self._count_typed_terminal(finish)
            flightrec.record("serve.typed_terminal", request=req.id,
                             scenario=req.scenario.name, finish=finish)
        else:
            self.quarantined += 1
            obs_metrics.counter("serve.quarantined").inc()
            # Postmortem: freeze the ring (which already holds this request's
            # poisoned serve.step record) to _flightrec.json.
            flightrec.record("serve.quarantine", request=req.id,
                             scenario=req.scenario.name, slot=slot,
                             error=resp.error)
            flightrec.dump("serve.quarantine", request=req.id,
                           scenario=req.scenario.name)
        spec_attrs = ({"drafted": sess.drafted, "accepted": sess.accepted,
                       "emitted": len(sess.tokens),
                       "exited_early": sess.early}
                      if self._speculative else {})
        obs.event("serve.complete", request=req.id, slot=slot,
                  scenario=req.scenario.name, finish=finish,
                  steps=sess.steps, ok=ok,
                  latency_seconds=resp.latency_seconds,
                  **spec_attrs,
                  **({"word": req.word} if req.word else {}),
                  **({"error": resp.error} if resp.error else {}))
        # Terminal close of the request-lifecycle span: exactly one
        # terminal=True end per served attempt (check_request_traces) —
        # quarantines close with status="error" and stay terminal (the
        # error response IS the answer).
        end_attrs: Dict[str, Any] = {
            **spec_attrs,
            "terminal": True, "finish": finish, "steps": sess.steps,
            "emitted": len(sess.tokens),
            "latency_seconds": resp.latency_seconds}
        if sess.ttft_seconds is not None:
            end_attrs["ttft_seconds"] = sess.ttft_seconds
        sess.span.set(**end_attrs)
        sess.span.end(error=exc)
        # Flush BEFORE the response commit: a replica killed at the commit
        # fault site must leave this terminal end on disk, or the answered
        # request would read as unresolved after the fleet merge.
        tracer = obs_trace.get_tracer()
        if tracer is not None:
            try:
                tracer.flush()
            except Exception:  # noqa: BLE001 — tracing is fail-open
                pass
        if self.on_complete is not None:
            self.on_complete(resp)
        return resp

    def accept_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-scenario speculation accounting over COMPLETED sessions —
        the accept_rate block ``_serve.json`` carries next to the SLO
        histograms (empty on a vanilla engine).  ``accepted_per_step`` is
        the device-time view: accepted draft tokens per verify launch."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, agg in sorted(self._accept.items()):
            d: Dict[str, Any] = dict(agg)
            d["accept_rate"] = (round(agg["accepted"] / agg["drafted"], 4)
                                if agg["drafted"] else 0.0)
            d["accepted_per_step"] = (round(agg["accepted"] / agg["steps"], 4)
                                      if agg["steps"] else 0.0)
            if agg["exited_early"]:
                d["early_agreement"] = round(
                    agg["early_agree"] / agg["exited_early"], 4)
            out[name] = d
        return out

    def latency_percentiles(self) -> Dict[str, Any]:
        """Per-scenario latency percentiles — WINDOWED, honestly labeled.

        The primary ``window`` stats come from each histogram's
        window-forked reservoir (``obs.metrics.Histogram.windowed``: the
        last rolled timeseries window plus the in-progress one), so a p99
        regression mid-run moves the number within ~2 windows.  The
        ``cumulative`` stats are the since-process-start reservoir the exit
        summary snapshots — kept alongside because both views are useful,
        labeled as what they are because a cumulative number sold as
        "rolling" arithmetically masks exactly the regressions an SLO
        exists to catch.

        Shape::

            {"window_s": 10.0,
             "scenarios": {name: {"window":     {p50_s, p99_s, max_s, n},
                                  "cumulative": {p50_s, p99_s, max_s, n}}}}
        """
        def _r(v: Optional[float]) -> Optional[float]:
            return round(v, 4) if v is not None else None

        scenarios: Dict[str, Dict[str, Any]] = {}
        for name in sorted(self._scenarios_completed):
            h = obs_metrics.histogram(f"serve.latency.{name}")
            if not h.count:
                continue
            win = h.windowed()
            scenarios[name] = {
                "window": {"p50_s": _r(win["p50"]), "p99_s": _r(win["p99"]),
                           "max_s": _r(win["max"]), "n": win["n"]},
                "cumulative": {"p50_s": _r(h.quantile(0.5)),
                               "p99_s": _r(h.quantile(0.99)),
                               "max_s": _r(h.max), "n": h.count},
            }
            # Time-to-first-token rides next to end-to-end latency (the
            # TTFT SLO's per-scenario view; absent for sessions that
            # emitted no token).
            ht = obs_metrics.histogram(f"serve.ttft.{name}")
            if ht.count:
                twin = ht.windowed()
                scenarios[name]["ttft"] = {
                    "window": {"p50_s": _r(twin["p50"]),
                               "p99_s": _r(twin["p99"]),
                               "max_s": _r(twin["max"]), "n": twin["n"]},
                    "cumulative": {"p50_s": _r(ht.quantile(0.5)),
                                   "p99_s": _r(ht.quantile(0.99)),
                                   "max_s": _r(ht.max), "n": ht.count},
                }
        return {"window_s": timeseries.window_seconds(),
                "scenarios": scenarios}

    # -- loop helper ---------------------------------------------------------

    def run_until_idle(self, *, max_steps: int = 100_000) -> List[Response]:
        """Step until every accepted session resolves (tests, loadgen's
        closed loop tail).  Bounded so a logic bug cannot spin forever."""
        done: List[Response] = []
        for _ in range(max_steps):
            if self.idle:
                return done
            done.extend(self.step())
        raise RuntimeError(
            f"scheduler did not go idle within {max_steps} steps "
            f"(in_flight={self.in_flight}, queued={self.queue_depth})")
