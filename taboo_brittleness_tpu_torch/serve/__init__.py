"""Multi-tenant brittleness-probe serving: continuous batching over one
resident model (the JAX package's ``serve/`` package, in-process part).

Concurrent chat / token-forcing / SAE-ablated / projected / lens-readout
sessions multiplex into ONE step program over one resident Gemma-2
checkpoint (or a base plus a stacked delta bank for several words):

- :mod:`~taboo_brittleness_tpu_torch.serve.engine` — the device half: a
  fixed-width slot batch with per-slot KV pages (``models.gemma2.forward``'s
  ``cache_positions`` mode), per-request interventions as per-slot data,
  and the lens readout through ``ops.lens_kernel.lens_stats``, advanced by
  one ``runtime.aot`` program (a CUDA graph on the card).
- :mod:`~taboo_brittleness_tpu_torch.serve.scheduler` — the host half:
  scenarios, bounded-queue admission, slot assignment and recycling,
  per-scenario latency histograms, drain, and the ``serve.step`` fault site
  (one poisoned session quarantines, the batch lives).
- :mod:`~taboo_brittleness_tpu_torch.serve.loadgen` — the in-process load
  generator behind ``loadgen``: seeded scenario mix and arrival process,
  per-scenario p50/p99 latency and TTFT, goodput.
- :mod:`~taboo_brittleness_tpu_torch.serve.autotune` — slot width solved
  from the engine's byte plan and the card's memory watermarks.

Not ported yet: the spool server, fleet, gateway and the speculative
engine.
"""

from taboo_brittleness_tpu_torch.serve.scheduler import (  # noqa: F401
    Request, Response, Scenario, SlotScheduler, default_scenarios)
