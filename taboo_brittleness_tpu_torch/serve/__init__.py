"""Multi-tenant brittleness-probe serving: continuous batching over one
resident model (the JAX package's ``serve/`` package).

Concurrent chat / token-forcing / SAE-ablated / projected / lens-readout
sessions multiplex into ONE step program over one resident Gemma-2
checkpoint (or a base plus a stacked delta bank for several words):

- :mod:`~taboo_brittleness_tpu_torch.serve.engine` — the device half: a
  fixed-width slot batch with per-slot KV pages (``models.gemma2.forward``'s
  ``cache_positions`` mode), per-request interventions as per-slot data,
  and the lens readout through ``ops.lens_kernel.lens_stats``, advanced by
  one ``runtime.aot`` program (a CUDA graph on the card).
- :mod:`~taboo_brittleness_tpu_torch.serve.spec_engine` — the speculative
  engine (``TBX_SERVE_SPECULATE=1``): a draft and a verify program per
  step, up to G + 1 tokens per slot, token streams equal to the vanilla
  engine's.
- :mod:`~taboo_brittleness_tpu_torch.serve.scheduler` — the host half:
  scenarios, bounded-queue admission, slot assignment and recycling,
  per-scenario latency histograms, drain, and the ``serve.step`` /
  ``serve.spec.verify`` fault sites (one poisoned session quarantines, the
  batch lives).
- :mod:`~taboo_brittleness_tpu_torch.serve.server` — the long-lived
  ``serve`` process: a file-spool request/response protocol, the serving
  heartbeat, SIGTERM drain (finish in-flight sessions, admit nothing new,
  exit 75) and resume of claimed-but-unanswered requests.
- :mod:`~taboo_brittleness_tpu_torch.serve.loadgen` — the load generator
  behind ``loadgen``, in process or through a running server's spool:
  seeded scenario mix and arrival process, per-scenario p50/p99 latency
  and TTFT, goodput.
- :mod:`~taboo_brittleness_tpu_torch.serve.autotune` — slot width solved
  from the engine's byte plan and the card's memory watermarks.
- :mod:`~taboo_brittleness_tpu_torch.serve.replica` — the replica fleet
  (``serve-fleet``): N supervised ``serve --replica`` processes over one
  spool, leased request ownership, re-spool on a replica's death, a
  burn-rate admission router.
- :mod:`~taboo_brittleness_tpu_torch.serve.gateway` — the HTTP front door
  over a spool: durable before the ack, per-token SSE, typed 429s, drain.

Not ported yet: the tensor-parallel forms (ROADMAP Queue 1 item 5).
"""

from taboo_brittleness_tpu_torch.serve.scheduler import (  # noqa: F401
    Request, Response, Scenario, SlotScheduler, default_scenarios)
