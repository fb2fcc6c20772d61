"""``gateway``: the streaming network front door over the request spool.

The PyTorch port's copy of the JAX package's ``serve/gateway.py``: stdlib
host code, no tensors, and it never touches the card (a gateway process
holds no CUDA context).  A raw-asyncio HTTP/1.1 ingress: every accepted
request is written durably into the :class:`serve.server.RequestSpool`
BEFORE the client is acknowledged, so the gateway holds NO authoritative
state.  A SIGKILL mid-stream loses at most open sockets, never requests:
the spool stays the crash-safe queue underneath, replicas keep their
lease / exactly-once machinery, and N gateways can front one spool.

Endpoint contract::

    POST /v1/generate        body: the request JSON ({"prompt": ..., ...})
        200  text/event-stream: per-token SSE tailing the replica's
             streams/<id>.jsonl, then one ``done`` event carrying the
             authoritative response file
        400  {"error": "invalid", ...}      malformed body / no prompt
        413  {"error": "oversized", ...}    body over TBX_SPOOL_MAX_BYTES
        429  {"error": <reason>, "retry_after": s}  typed backpressure:
             queue-full | tenant-quota | all-replicas-burning |
             fleet-saturated   (Retry-After from the burn router's
             fast-window burn / the tenant bucket's refill)
        503  {"error": "draining"}          SIGTERM received
    GET  /v1/healthz         {"ok": true, "draining": false}
    GET  /v1/stats           the live stats block (the heartbeat's body)

Request headers::

    X-Tbx-Tenant       tenant key for quota and priority (default "default")
    X-Tbx-Deadline-Ms  relative deadline; rides the payload as an epoch
                       ``deadline_at``: replicas skip expired requests at
                       claim and between steps / verify blocks
    X-Tbx-Trace        traceparent-style context (obs.reqtrace); a
                       malformed value re-mints with a one-shot warning

Robustness:

- **Client disconnect = cancellation.**  EOF on the request socket while
  streaming drops a ``cancel/<id>.json`` tombstone; the owning replica
  observes it between steps, releases the slot, and answers the typed
  ``canceled`` terminal.
- **Bounded backpressure.**  A per-gateway in-flight window caps open
  streams (429 ``queue-full``); per-tenant token buckets
  (``TBX_GATEWAY_QUOTA`` JSON: ``{"tenant": {"rate": r, "burst": b,
  "priority": p}}``, ``"*"`` = the default) shed over-quota tenants BEFORE
  they queue (429 ``tenant-quota``); replica heartbeats gate admission as
  the fleet router does (429 ``all-replicas-burning`` /
  ``fleet-saturated``).
- **Graceful drain.**  SIGTERM (``runtime.supervise``) stops accepting,
  finishes in-flight streams, exits 75 (``EXIT_DRAINED``).
- **Chaos.**  Fault sites ``gateway.accept`` / ``gateway.spool_put`` /
  ``gateway.stream_write`` ride ``TABOO_FAULT_PLAN``; a ``die`` at
  spool_put is the gateway killed between accept and ack: the client got
  no 200, the spool never saw the request.

Telemetry: the gateway writes its own ``_events.gateway.jsonl``;
per-request spans use ``kind="gateway"`` and emit the ``serve.first_token``
point at the stream's first token, so network TTFT and engine TTFT are one
metric family.  ``_gateway.json`` is the heartbeat ``top`` renders.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.obs import reqtrace
from taboo_brittleness_tpu_torch.obs import trace as obs_trace
from taboo_brittleness_tpu_torch.obs.progress import read_progress
from taboo_brittleness_tpu_torch.runtime import resilience, supervise
from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump
from taboo_brittleness_tpu_torch.serve.replica import router_burn_cap
from taboo_brittleness_tpu_torch.serve.scheduler import (
    FINISH_CANCELED, REJECT_ALL_REPLICAS_BURNING, REJECT_FLEET_SATURATED,
    REJECT_QUEUE_FULL, REJECT_TENANT_QUOTA)
from taboo_brittleness_tpu_torch.serve.server import (
    RequestSpool, SpoolValidationError, spool_max_bytes)

GATEWAY_HEARTBEAT_FILENAME = "_gateway.json"
GATEWAY_EVENTS_FILENAME = "_events.gateway.jsonl"
GATEWAY_SPAN = "gateway.request"
QUOTA_ENV = "TBX_GATEWAY_QUOTA"

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


# ---------------------------------------------------------------------------
# Per-tenant quota: token buckets + priority off TBX_GATEWAY_QUOTA.
# ---------------------------------------------------------------------------


class TokenBucket:
    """Plain token bucket (monotonic clock; one gateway process = one
    bucket per tenant).  ``rate`` tokens/second refill up to ``burst``."""

    def __init__(self, rate: float, burst: float, *, clock=time.monotonic):
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self) -> bool:
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def retry_after(self) -> float:
        """Seconds until one token refills — the 429's Retry-After."""
        self._refill()
        return max(0.0, (1.0 - self._tokens) / self.rate)


def parse_quota(raw: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """``TBX_GATEWAY_QUOTA`` → {tenant: {"rate", "burst", "priority"}}.
    Malformed JSON parses as empty (fail-open: no quota, everyone admits
    at priority 0); ``"*"`` names the default applied to unlisted tenants
    (absent = unlimited)."""
    raw = os.environ.get(QUOTA_ENV, "") if raw is None else raw
    if not raw.strip():
        return {}
    try:
        cfg = json.loads(raw)
    except ValueError:
        return {}
    out: Dict[str, Dict[str, float]] = {}
    if not isinstance(cfg, dict):
        return out
    for tenant, spec in cfg.items():
        if not isinstance(spec, dict):
            continue
        try:
            out[str(tenant)] = {
                "rate": float(spec.get("rate", 10.0)),
                "burst": float(spec.get("burst",
                                        max(1.0, float(spec.get("rate",
                                                                10.0))))),
                "priority": int(spec.get("priority", 0)),
            }
        except (TypeError, ValueError):
            continue
    return out


class TenantQuotas:
    """Lazily-built per-tenant buckets over a parsed quota config."""

    def __init__(self, config: Optional[Dict[str, Dict[str, float]]] = None):
        self.config = parse_quota() if config is None else config
        self._buckets: Dict[str, TokenBucket] = {}

    def _spec(self, tenant: str) -> Optional[Dict[str, float]]:
        return self.config.get(tenant) or self.config.get("*")

    def priority(self, tenant: str) -> int:
        spec = self._spec(tenant)
        return int(spec.get("priority", 0)) if spec else 0

    def admit(self, tenant: str) -> Tuple[bool, float]:
        """(admitted?, retry_after_s).  Tenants without a spec (and no
        ``"*"`` default) are unlimited."""
        spec = self._spec(tenant)
        if spec is None:
            return True, 0.0
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(spec["rate"],
                                                    spec["burst"])
        if b.try_take():
            return True, 0.0
        return False, b.retry_after()


# ---------------------------------------------------------------------------
# Fleet pressure off replica heartbeats (the burn router's signals).
# ---------------------------------------------------------------------------


def fleet_pressure(output_dir: str,
                   burn_cap: Optional[float] = None) -> Dict[str, Any]:
    """One admission snapshot over every serve heartbeat in the directory
    (``_progress.json`` single-server, ``_progress.<wid>.json`` fleet) —
    the :class:`serve.replica.BurnRouter` view generalized to heartbeat
    discovery, for a gateway that fronts either shape.  ``burning`` /
    ``saturated`` mirror the router's all-live-replicas conditions; with
    NO live heartbeat the gateway still admits (the spool is durable —
    requests wait for the next replica incarnation, the whole point of
    spool-under-gateway)."""
    cap = float(burn_cap) if burn_cap is not None else router_burn_cap()
    try:
        names = sorted(os.listdir(output_dir))
    except OSError:
        names = []
    live = 0
    burning = 0
    saturated = 0
    max_fast = 0.0
    for name in names:
        if not (name == "_progress.json"
                or (name.startswith("_progress.")
                    and name.endswith(".json"))):
            continue
        p = read_progress(os.path.join(output_dir, name), missing_ok=True)
        if p.get("status") != "running" or p.get("stale"):
            continue
        live += 1
        fast = 0.0
        for key, cell in (p.get("slo") or {}).items():
            if not str(key).startswith("serve"):
                continue
            try:
                fast = max(fast, float((cell or {}).get("fast", 0.0)))
            except (TypeError, ValueError):
                continue
        max_fast = max(max_fast, fast)
        if fast >= cap:
            burning += 1
        serving = p.get("serving") or {}
        slots = serving.get("slots") or {}
        try:
            width = int(slots.get("width", 0) or 0)
            free = int(slots.get("free", 0) or 0)
            queued = int(serving.get("queued", 0) or 0)
        except (TypeError, ValueError):
            width = free = queued = 0
        if width and free == 0 and queued > 0:
            saturated += 1
    return {
        "live": live,
        "burning": bool(live) and burning == live,
        "saturated": bool(live) and saturated == live,
        "max_fast": round(max_fast, 4),
        "burn_cap": cap,
    }


def burn_retry_after(pressure: Dict[str, Any]) -> int:
    """Retry-After seconds from the fast-window burn: linear in how far
    past the cap the worst replica is (one cap-multiple ≈ 2s), clamped to
    [1, 30] — hot fleets push clients back harder, never forever."""
    try:
        over = float(pressure.get("max_fast", 0.0)) / max(
            0.1, float(pressure.get("burn_cap", 1.0)))
    except (TypeError, ValueError):
        over = 1.0
    return max(1, min(30, int(round(2.0 * over))))


# ---------------------------------------------------------------------------
# The gateway.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatewayConfig:
    output_dir: str
    host: str = "127.0.0.1"
    port: int = 0                   # 0 = ephemeral; heartbeat publishes it
    window: int = 64                # max concurrently open SSE streams
    poll_s: float = 0.02            # stream/response tail poll
    heartbeat_s: float = 0.5
    drain_grace_s: float = 30.0     # max wait for streams on SIGTERM
    burn_cap: Optional[float] = None
    pressure_ttl_s: float = 0.5     # heartbeat-scan cache
    quota: Optional[Dict[str, Dict[str, float]]] = None


class Gateway:
    """One gateway process: asyncio server + heartbeat, all on the event
    loop's single thread (no locks to order, nothing shared across
    threads — the TBX201..204 surface is empty by construction)."""

    def __init__(self, cfg: GatewayConfig):
        self.cfg = cfg
        self.spool = RequestSpool(cfg.output_dir)
        self.quotas = TenantQuotas(cfg.quota)
        self.port: Optional[int] = None
        self.draining = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._open_streams = 0
        self._pressure: Optional[Dict[str, Any]] = None
        self._pressure_t = 0.0
        self._warned_badtrace = False
        self.stats: Dict[str, Any] = {
            "accepted": 0, "completed": 0, "canceled": 0, "errors": 0,
            "shed": {},                 # reason -> count (the 429 breakdown)
            "tenants": {},              # tenant -> {"accepted", "shed"}
        }
        self._tracer = (obs.activate(
            os.path.join(cfg.output_dir, GATEWAY_EVENTS_FILENAME),
            run_id=uuid.uuid4().hex[:12]) if obs_trace.enabled() else None)

    # -- bookkeeping ---------------------------------------------------------

    def _tenant_stats(self, tenant: str) -> Dict[str, int]:
        return self.stats["tenants"].setdefault(
            tenant, {"accepted": 0, "shed": 0})

    def _count_shed(self, reason: str, tenant: str) -> None:
        shed = self.stats["shed"]
        shed[reason] = shed.get(reason, 0) + 1
        self._tenant_stats(tenant)["shed"] += 1

    def _stats_block(self) -> Dict[str, Any]:
        return {
            "v": 1,
            "pid": os.getpid(),
            "port": self.port,
            "draining": self.draining,
            "open_streams": self._open_streams,
            "window": {"limit": self.cfg.window,
                       "in_flight": self._open_streams},
            **{k: self.stats[k] for k in ("accepted", "completed",
                                          "canceled", "errors")},
            "shed": dict(self.stats["shed"]),
            "tenants": {t: dict(c)
                        for t, c in self.stats["tenants"].items()},
        }

    def _write_heartbeat(self) -> None:
        try:
            # tbx: wallclock-ok — heartbeat freshness is cross-process (epoch)
            atomic_json_dump({**self._stats_block(), "t": time.time()},
                             os.path.join(self.cfg.output_dir,
                                          GATEWAY_HEARTBEAT_FILENAME))
        except OSError:
            pass

    def pressure(self) -> Dict[str, Any]:
        now = time.monotonic()
        if (self._pressure is None
                or now - self._pressure_t > self.cfg.pressure_ttl_s):
            self._pressure = fleet_pressure(self.cfg.output_dir,
                                            self.cfg.burn_cap)
            self._pressure_t = now
        return self._pressure

    # -- HTTP plumbing -------------------------------------------------------

    async def _respond_json(self, writer: asyncio.StreamWriter, status: int,
                            body: Dict[str, Any],
                            headers: Optional[Dict[str, str]] = None) -> None:
        blob = json.dumps(body).encode("utf-8")
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}",
                "Content-Type: application/json",
                f"Content-Length: {len(blob)}",
                "Connection: close"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("ascii") + blob)
        await writer.drain()

    async def _shed(self, writer: asyncio.StreamWriter, reason: str,
                    tenant: str, retry_after: float,
                    rid: Optional[str] = None) -> None:
        self._count_shed(reason, tenant)
        obs.event("gateway.shed", reason=reason, tenant=tenant,
                  **({"request": rid} if rid else {}))
        await self._respond_json(
            writer, 429, {"error": reason, "tenant": tenant,
                          "retry_after": round(retry_after, 3)},
            headers={"Retry-After": str(max(1, int(round(retry_after))))})

    async def _read_request(self, reader: asyncio.StreamReader,
                            ) -> Optional[Tuple[str, str, Dict[str, str],
                                                bytes]]:
        """(method, path, headers, body) or None on a torn/oversized read.
        The body read is capped at the spool's own byte guard + 1 so an
        oversized POST is detected without buffering it."""
        try:
            raw = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                         timeout=10.0)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                asyncio.TimeoutError, ConnectionError):
            return None
        try:
            head = raw.decode("latin-1")
            request_line, *header_lines = head.split("\r\n")
            method, path, _version = request_line.split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        for line in header_lines:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            return None
        cap = spool_max_bytes()
        body = b""
        if length > 0:
            try:
                body = await asyncio.wait_for(
                    reader.readexactly(min(length, cap + 1)), timeout=10.0)
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    ConnectionError):
                return None
        if length > cap:
            body = body[:cap + 1]       # oversize marker, not the payload
        return method, path, headers, body

    # -- the connection handler ---------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            await self._handle_inner(reader, writer)
        except ConnectionError:
            pass
        except Exception as exc:  # noqa: BLE001 — one connection, not the loop
            self.stats["errors"] += 1
            obs.event("gateway.error",
                      error=f"{type(exc).__name__}: {exc}"[:200])
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — already-dead socket
                pass

    async def _handle_inner(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        parsed = await self._read_request(reader)
        if parsed is None:
            await self._respond_json(writer, 408,
                                     {"error": "torn-request"})
            return
        method, path, headers, body = parsed
        tenant = headers.get("x-tbx-tenant", "default") or "default"
        try:
            resilience.fire("gateway.accept", path=path, tenant=tenant)
        except Exception as exc:  # noqa: BLE001 — injected accept fault
            self.stats["errors"] += 1
            await self._respond_json(
                writer, 500,
                {"error": f"{type(exc).__name__}: {exc}"[:200]})
            return
        if method == "GET" and path == "/v1/healthz":
            await self._respond_json(writer, 200,
                                     {"ok": True,
                                      "draining": self.draining})
            return
        if method == "GET" and path == "/v1/stats":
            await self._respond_json(writer, 200, self._stats_block())
            return
        if path != "/v1/generate":
            await self._respond_json(writer, 404, {"error": "not-found"})
            return
        if method != "POST":
            await self._respond_json(writer, 405,
                                     {"error": "method-not-allowed"})
            return
        await self._generate(reader, writer, headers, body, tenant)

    async def _generate(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter,
                        headers: Dict[str, str], body: bytes,
                        tenant: str) -> None:
        # Admission order: validity (400/413) → drain (503) → tenant quota
        # (over-quota tenants shed BEFORE they can occupy window slots) →
        # in-flight window → fleet burn/saturation.  Only then the durable
        # spool put, only then the 200.
        if len(body) > spool_max_bytes():
            await self._respond_json(
                writer, 413, {"error": "oversized",
                              "limit_bytes": spool_max_bytes()})
            return
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            await self._respond_json(writer, 400,
                                     {"error": "invalid",
                                      "detail": "body is not JSON"})
            return
        if not isinstance(payload, dict):
            await self._respond_json(writer, 400,
                                     {"error": "invalid",
                                      "detail": "body must be an object"})
            return
        rid = str(payload.get("id") or uuid.uuid4().hex[:12])
        payload["id"] = rid
        if self.draining:
            await self._respond_json(writer, 503, {"error": "draining"})
            return
        admitted, quota_wait = self.quotas.admit(tenant)
        if not admitted:
            await self._shed(writer, REJECT_TENANT_QUOTA, tenant,
                             quota_wait, rid)
            return
        if self._open_streams >= self.cfg.window:
            await self._shed(writer, REJECT_QUEUE_FULL, tenant, 1.0, rid)
            return
        pressure = self.pressure()
        if pressure["burning"]:
            await self._shed(writer, REJECT_ALL_REPLICAS_BURNING, tenant,
                             burn_retry_after(pressure), rid)
            return
        if pressure["saturated"]:
            await self._shed(writer, REJECT_FLEET_SATURATED, tenant,
                             burn_retry_after(pressure), rid)
            return

        # Trace context: body beats header beats fresh mint; a PRESENT but
        # malformed header re-mints with the one-shot warn (the header
        # satellite's contract).
        header_trace = headers.get(reqtrace.TRACE_HEADER)
        payload, ctx, minted = reqtrace.ensure_from_header(payload,
                                                           header_trace)
        if minted and header_trace and not self._warned_badtrace:
            self._warned_badtrace = True
            obs.warn(
                "[gateway] malformed X-Tbx-Trace header — minted a fresh "
                "context; downstream hops stay traceable",
                name="gateway.bad_trace_header", request=rid)

        # Deadline + priority ride the payload into the spool.
        deadline_ms = headers.get("x-tbx-deadline-ms")
        if deadline_ms:
            try:
                # tbx: wallclock-ok — deadlines cross processes (epoch stamp)
                payload["deadline_at"] = time.time() + float(deadline_ms) / 1e3
            except (TypeError, ValueError):
                pass
        priority = self.quotas.priority(tenant)
        if priority and not payload.get("priority"):
            payload["priority"] = priority
        payload.setdefault("tenant", tenant)

        try:
            resilience.fire("gateway.spool_put", request=rid, tenant=tenant)
            rid = self.spool.put(payload)
        except SpoolValidationError as exc:
            status = 413 if exc.reason == "oversized" else 400
            await self._respond_json(writer, status,
                                     {"error": exc.reason,
                                      "detail": str(exc)[:200]})
            return
        except Exception as exc:  # noqa: BLE001 — injected put fault / IO
            self.stats["errors"] += 1
            await self._respond_json(
                writer, 500,
                {"error": f"{type(exc).__name__}: {exc}"[:200]})
            return

        self.stats["accepted"] += 1
        self._tenant_stats(tenant)["accepted"] += 1
        obs.event("gateway.accept", request=rid, tenant=tenant,
                  trace=ctx.get("trace_id"))
        await self._stream(reader, writer, rid, tenant, ctx)

    # -- SSE streaming -------------------------------------------------------

    async def _sse(self, writer: asyncio.StreamWriter, rid: str,
                   event: str, data: Dict[str, Any]) -> None:
        resilience.fire("gateway.stream_write", request=rid, event=event)
        writer.write(f"event: {event}\ndata: {json.dumps(data)}\n\n"
                     .encode("utf-8"))
        await writer.drain()

    async def _stream(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter, rid: str,
                      tenant: str, ctx: Dict[str, Any]) -> None:
        """Tail ``streams/<rid>.jsonl`` into SSE ``token`` events until the
        response file lands (``done``), the client disconnects (cancel
        tombstone) or a stream-write fault drops the socket.  The open fd
        survives the spool GC's unlink (POSIX), and the ``done`` event's
        text/tokens come from the RESPONSE file — the stream is a live
        view, never the source of truth."""
        span = None
        if self._tracer is not None:
            try:
                span = self._tracer.span_detached(
                    GATEWAY_SPAN, kind="gateway", request=rid,
                    tenant=tenant, trace=ctx.get("trace_id"),
                    attempt=int(ctx.get("attempt", 0)))
                self._tracer.flush()
            except Exception:  # noqa: BLE001 — tracing is fail-open
                span = None
        self._open_streams += 1
        t0 = time.monotonic()
        outcome = "done"
        emitted = 0
        disco = asyncio.Event()

        async def _watch_disconnect() -> None:
            # The client sends nothing after the request: the next read
            # resolving (EOF or error) means the socket died.
            try:
                await reader.read(1)
            except Exception:  # noqa: BLE001 — any error = gone
                pass
            disco.set()

        watcher = asyncio.create_task(_watch_disconnect())
        stream_fd = None
        buf = ""
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-store\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            path = self.spool.stream_path(rid)
            while True:
                if disco.is_set():
                    outcome = "canceled"
                    break
                # Snapshot the response BEFORE draining the stream: the
                # replica writes every token line before the response file,
                # so a response seen here guarantees this drain is final —
                # checking after the drain would race away the tail tokens.
                resp = self.spool.get_response(rid)
                if stream_fd is None and os.path.exists(path):
                    stream_fd = open(path)
                new_lines: List[str] = []
                if stream_fd is not None:
                    buf += stream_fd.read()
                    while "\n" in buf:
                        line, buf = buf.split("\n", 1)
                        if line:
                            new_lines.append(line)
                for line in new_lines:
                    try:
                        tok = json.loads(line)
                    except ValueError:
                        continue            # torn tail line; next read
                    if emitted == 0 and span is not None:
                        span.event(reqtrace.FIRST_TOKEN_POINT, request=rid,
                                   trace=ctx.get("trace_id"),
                                   ttft_seconds=round(
                                       time.monotonic() - t0, 6),
                                   source="gateway")
                    emitted += 1
                    await self._sse(writer, rid, "token", tok)
                if resp is not None:
                    await self._sse(writer, rid, "done", resp)
                    outcome = ("done" if resp.get("ok")
                               else str(resp.get("finish") or "rejected"))
                    break
                await asyncio.sleep(self.cfg.poll_s)
        except Exception:  # noqa: BLE001 — socket died / injected write fault
            outcome = "canceled"
        finally:
            watcher.cancel()
            if stream_fd is not None:
                try:
                    stream_fd.close()
                except OSError:
                    pass
            self._open_streams -= 1
            if outcome == "canceled":
                self.stats["canceled"] += 1
                try:
                    self.spool.cancel(rid)
                except OSError:
                    pass
                obs.event("gateway.cancel", request=rid, tenant=tenant)
            else:
                self.stats["completed"] += 1
                obs.event("gateway.stream_done", request=rid,
                          tenant=tenant, finish=outcome, emitted=emitted)
            if span is not None:
                span.set(finish=(FINISH_CANCELED if outcome == "canceled"
                                 else outcome),
                         emitted=emitted,
                         latency_seconds=round(time.monotonic() - t0, 6))
                span.end()
                try:
                    self._tracer.flush()
                except Exception:  # noqa: BLE001 — tracing is fail-open
                    pass

    # -- lifecycle -----------------------------------------------------------

    async def _heartbeat_loop(self) -> None:
        while True:
            self._write_heartbeat()
            await asyncio.sleep(self.cfg.heartbeat_s)

    async def run(self) -> int:
        """Serve until drain (SIGTERM/SIGINT via runtime.supervise): stop
        accepting, finish in-flight streams (bounded by ``drain_grace_s``),
        exit 75 — the supervisor-relaunch contract every worker speaks."""
        self._server = await asyncio.start_server(
            self._handle, self.cfg.host, self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._write_heartbeat()
        obs.event("gateway.start", port=self.port, window=self.cfg.window)
        hb = asyncio.create_task(self._heartbeat_loop())
        try:
            while not supervise.drain_requested():
                await asyncio.sleep(0.05)
            self.draining = True
            self._server.close()
            await self._server.wait_closed()
            t0 = time.monotonic()
            while (self._open_streams > 0
                   and time.monotonic() - t0 < self.cfg.drain_grace_s):
                await asyncio.sleep(0.05)
            obs.event("gateway.drain", open_streams=self._open_streams)
            return supervise.EXIT_DRAINED
        finally:
            hb.cancel()
            self._write_heartbeat()
            if self._tracer is not None:
                obs.deactivate(self._tracer)


def run_gateway(cfg: GatewayConfig) -> int:
    return asyncio.run(Gateway(cfg).run())


# ---------------------------------------------------------------------------
# Client helpers (stdlib http.client): loadgen --socket, selfchecks, tests.
# ---------------------------------------------------------------------------


def iter_sse(resp) -> Any:
    """(event, data) pairs from an SSE response body (http.client
    HTTPResponse or any binary file-like)."""
    event: Optional[str] = None
    data: List[str] = []
    while True:
        line = resp.readline()
        if not line:
            break
        text = line.decode("utf-8", "replace").rstrip("\r\n")
        if not text:
            if event is not None or data:
                try:
                    parsed = json.loads("\n".join(data)) if data else None
                except ValueError:
                    parsed = None
                yield (event or "message"), parsed
            event, data = None, []
            continue
        if text.startswith("event:"):
            event = text[len("event:"):].strip()
        elif text.startswith("data:"):
            data.append(text[len("data:"):].strip())


def close_stream(conn, resp) -> None:
    """Close an open SSE stream so the GATEWAY SEES IT: ``conn.close()``
    alone does not send FIN while the response object is alive — its
    ``makefile`` wrapper holds the socket fd open — so the disconnect (and
    therefore the cancellation) never reaches the server.  Close both."""
    for obj in (resp, conn):
        try:
            obj.close()
        except Exception:  # noqa: BLE001 — already-dead socket
            pass


class GatewayClient:
    """Minimal blocking client for one gateway (threads drive concurrency
    in loadgen).  ``generate`` returns (status, payload-or-response,
    timings); for 200 the caller consumes the SSE iterator."""

    def __init__(self, base_url: str, *, timeout: float = 60.0):
        import urllib.parse
        u = urllib.parse.urlparse(base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"unsupported scheme: {base_url}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.timeout = timeout

    def _connect(self):
        import http.client
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def get_json(self, path: str) -> Tuple[int, Dict[str, Any]]:
        conn = self._connect()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            try:
                return resp.status, json.loads(body.decode("utf-8"))
            except ValueError:
                return resp.status, {}
        finally:
            conn.close()

    def open_stream(self, payload: Dict[str, Any], *,
                    tenant: Optional[str] = None,
                    deadline_ms: Optional[float] = None,
                    trace_ctx: Optional[Dict[str, Any]] = None):
        """POST /v1/generate; returns (conn, status, resp).  The caller
        owns the pair — call :func:`close_stream` on it to end (or cancel)
        an open stream; the gateway reads the EOF as client disconnect."""
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Tbx-Tenant"] = tenant
        if deadline_ms is not None:
            headers["X-Tbx-Deadline-Ms"] = str(deadline_ms)
        if trace_ctx is not None:
            headers["X-Tbx-Trace"] = reqtrace.format_header(trace_ctx)
        conn = self._connect()
        conn.request("POST", "/v1/generate", body=json.dumps(payload),
                     headers=headers)
        resp = conn.getresponse()
        return conn, resp.status, resp

    def generate(self, payload: Dict[str, Any], **kw) -> Dict[str, Any]:
        """Run one request to completion: 200 → {"status": 200, "tokens":
        [...], "done": response-dict}; non-200 → {"status": s, "reject":
        body-dict}."""
        conn, status, resp = self.open_stream(payload, **kw)
        try:
            if status != 200:
                try:
                    body = json.loads(resp.read().decode("utf-8"))
                except ValueError:
                    body = {}
                return {"status": status, "reject": body,
                        "retry_after": resp.getheader("Retry-After")}
            tokens: List[Dict[str, Any]] = []
            done: Optional[Dict[str, Any]] = None
            for event, data in iter_sse(resp):
                if event == "token":
                    tokens.append(data)
                elif event == "done":
                    done = data
                    break
            return {"status": 200, "tokens": tokens, "done": done}
        finally:
            close_stream(conn, resp)


def wait_for_gateway(output_dir: str, *,
                     timeout_s: float = 30.0) -> Optional[int]:
    """Poll ``_gateway.json`` for the (ephemeral) port — how subprocess
    harnesses discover where a ``--port 0`` gateway landed."""
    path = os.path.join(output_dir, GATEWAY_HEARTBEAT_FILENAME)
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        try:
            with open(path) as f:
                hb = json.load(f)
            port = int(hb.get("port") or 0)
            if port:
                return port
        except (OSError, ValueError, TypeError):
            pass
        time.sleep(0.05)
    return None


# ---------------------------------------------------------------------------
# Selfcheck (``gateway --selfcheck``).
# ---------------------------------------------------------------------------


def selfcheck(output_dir: str, *, n_requests: int = 4,
              max_wall_s: float = 600.0,
              device: Optional[str] = None) -> Dict[str, Any]:
    """Loopback socket smoke over a real serve subprocess: N requests
    streamed to completion, one canceled mid-stream (client disconnect →
    typed ``canceled`` terminal), one over-quota tenant (429
    ``tenant-quota`` + Retry-After), one oversized POST (413) and one
    invalid body (400) — then asserts exactly-once (one response file per
    accepted request, zero for pure rejects) and that SIGTERM drains both
    processes on the 75 contract.  ``device`` goes to the server's
    ``--device``."""
    import subprocess
    import sys as _sys

    os.makedirs(output_dir, exist_ok=True)
    victim = "victim-cancel"
    env = {**os.environ,
           "TBX_OBS_PROGRESS_S": "0.2",
           # Pin the victim mid-decode: a matched per-step delay makes the
           # disconnect deterministically land while it still decodes.
           "TABOO_FAULT_PLAN": json.dumps({
               "serve.step": {"mode": "delay", "delay": 0.05,
                              "times": 100000, "match": victim}})}
    gw_env = {**os.environ,
              "TBX_SPOOL_MAX_BYTES": "8192",
              "TBX_GATEWAY_QUOTA": json.dumps({
                  "vip": {"rate": 0.001, "burst": 1, "priority": 1}})}
    serve = subprocess.Popen(
        [_sys.executable, "-m", "taboo_brittleness_tpu", "serve",
         "--synthetic", "--output-dir", output_dir,
         "--slots", "4", "--max-new-tokens", "6", "--poll", "0.05"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    gateway = subprocess.Popen(
        [_sys.executable, "-m", "taboo_brittleness_tpu", "gateway",
         "--output-dir", output_dir, "--port", "0", "--window", "8"],
        env=gw_env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    problems: List[str] = []
    streamed = 0
    accepted_ids: List[str] = []
    try:
        port = wait_for_gateway(output_dir, timeout_s=max_wall_s / 4)
        if port is None:
            problems.append("gateway heartbeat never published a port")
            return {"ok": False, "problems": problems}
        client = GatewayClient(f"http://127.0.0.1:{port}",
                               timeout=max_wall_s / 4)

        hz_status, hz = client.get_json("/v1/healthz")
        if hz_status != 200 or not hz.get("ok"):
            problems.append(f"healthz: {hz_status} {hz}")

        # (1) N streamed completions.
        for i in range(int(n_requests)):
            rid = f"gw{i:03d}"
            out = client.generate({"id": rid, "prompt": "Give me a hint",
                                   "scenario": "chat", "seed": i})
            if out["status"] != 200:
                problems.append(f"{rid}: HTTP {out['status']} "
                                f"{out.get('reject')}")
                continue
            done = out.get("done")
            if not done or not done.get("ok"):
                problems.append(f"{rid}: no ok done event ({done})")
                continue
            toks = [t.get("tok") for t in out["tokens"]]
            if toks != list(done.get("tokens", []))[:len(toks)]:
                problems.append(f"{rid}: streamed tokens {toks} not a "
                                f"prefix of {done.get('tokens')}")
            accepted_ids.append(rid)
            streamed += 1

        # (2) cancel mid-stream: read one token, then drop the socket.
        # The victim must still be decoding when the disconnect lands:
        # scenario `forcing` with this prompt runs its full budget (the
        # tiny model's chat arm hits EOS at token 1), 20 new tokens is the
        # largest budget the envelope admits (prompt_cols 24 + 20 <=
        # max_context 48), and the armed 50 ms per-step delay stretches
        # the decode to ~1 s — the cancel window is structural, not a race.
        conn, status, resp = client.open_stream(
            {"id": victim, "prompt": "Give me a clue about the word",
             "scenario": "forcing", "max_new_tokens": 20})
        if status != 200:
            problems.append(f"cancel victim: HTTP {status}")
        else:
            saw_token = False
            for event, _data in iter_sse(resp):
                if event == "token":
                    saw_token = True
                    break
            close_stream(conn, resp)    # the disconnect IS the cancel
            if not saw_token:
                problems.append("cancel victim: no token before cancel")
            accepted_ids.append(victim)
            spool = RequestSpool(output_dir)
            t0 = time.monotonic()
            fin = None
            while time.monotonic() - t0 < max_wall_s / 4:
                r = spool.get_response(victim)
                if r is not None:
                    fin = r.get("finish")
                    break
                time.sleep(0.1)
            if fin != "canceled":
                problems.append(
                    f"cancel victim: finish={fin!r}, want 'canceled'")

        # (3) over-quota tenant: burst 1, negligible refill → second sheds.
        ok1 = client.generate({"id": "vip-0", "prompt": "Give me a hint",
                               "scenario": "chat"}, tenant="vip")
        if ok1["status"] != 200:
            problems.append(f"vip-0: HTTP {ok1['status']}")
        else:
            accepted_ids.append("vip-0")
        shed = client.generate({"id": "vip-1", "prompt": "Give me a hint",
                                "scenario": "chat"}, tenant="vip")
        if (shed["status"] != 429
                or (shed.get("reject") or {}).get("error")
                != "tenant-quota"):
            problems.append(f"vip-1: want 429 tenant-quota, got "
                            f"{shed['status']} {shed.get('reject')}")
        elif not shed.get("retry_after"):
            problems.append("vip-1: 429 without Retry-After")

        # (4) oversized (gateway env caps the spool at 8 KiB) + invalid.
        big = client.generate({"id": "too-big", "prompt": "x" * 20000,
                               "scenario": "chat"})
        if big["status"] != 413:
            problems.append(f"oversized: want 413, got {big['status']}")
        conn = client._connect()
        conn.request("POST", "/v1/generate", body=b"{not json",
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 400:
            problems.append(f"invalid body: want 400, got {resp.status}")
        conn.close()

        # (5) exactly-once: one response per accepted id, none for rejects.
        spool = RequestSpool(output_dir)
        for rid in accepted_ids:
            if spool.get_response(rid) is None:
                problems.append(f"{rid}: accepted but no response file")
        for rid in ("vip-1", "too-big"):
            if spool.get_response(rid) is not None:
                problems.append(f"{rid}: rejected but a response exists")

        stats_status, stats = client.get_json("/v1/stats")
        if stats_status != 200:
            problems.append(f"stats: HTTP {stats_status}")
        elif stats.get("shed", {}).get("tenant-quota", 0) < 1:
            problems.append(f"stats missing tenant-quota shed: {stats}")
    finally:
        import signal as _signal
        for name, proc in (("gateway", gateway), ("serve", serve)):
            if proc.poll() is None:
                proc.send_signal(_signal.SIGTERM)
        for name, proc in (("gateway", gateway), ("serve", serve)):
            try:
                rc = proc.wait(timeout=60.0)
                if rc != supervise.EXIT_DRAINED:
                    problems.append(f"{name} drained with exit {rc}, "
                                    f"want {supervise.EXIT_DRAINED}")
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                problems.append(f"{name} did not drain on SIGTERM")

    return {"ok": not problems, "problems": problems,
            "streamed": streamed, "accepted": len(accepted_ids)}


def main_selfcheck(device: Optional[str] = None) -> int:
    """``gateway --selfcheck``: run the loopback socket smoke in a temp
    dir and print the verdict."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="tbx-gateway-selfcheck-")
    try:
        verdict = selfcheck(os.path.join(tmp, "gw"), device=device)
        # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict)
        print(json.dumps(verdict, indent=2))
        return 0 if verdict["ok"] else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
