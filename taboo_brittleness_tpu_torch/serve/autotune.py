"""Slot-width autotuning from measured device-memory watermarks.

The counterpart of the JAX package's ``serve/autotune.py``.  Slot width is
a static config guess (``--slots``), while the signals that bound it — the
engine's byte plan and the live ``mem.hbm.*`` watermarks (``obs.memory``)
— are measurable.  This module is a SOLVER over them:

- **Byte model**: :func:`serve_plan_bytes` splits the resident engine into
  ``fixed_bytes`` (params + delta bank, paid once) and ``per_slot_bytes``
  (KV page incl. any speculative trash columns + slot state, paid per
  admitted slot), counted from the engine's own tensors.
- **Budget** (most- to least-trusted source): an explicit
  ``TBX_SERVE_AUTOTUNE_BYTES`` per-card budget (tests, capacity planning);
  the card's total memory (``torch.cuda.mem_get_info``, published as
  ``mem.hbm.limit_bytes``); or the live-bytes/headroom pair.  Each is
  discounted by ``TBX_SERVE_HBM_RESERVE`` (default 10% — fragmentation,
  graph pools, transient launch buffers).  No measurable budget (a CPU
  process) → a ``fallback`` verdict that keeps the configured width: the
  autotuner is never a correctness dependency.
- **Solve**: width = ``(budget - fixed) // per_slot``, capped at the
  configured width; a speculative engine's block G is re-priced against
  the same budget via ``kv_col_bytes``.

The solved width re-publishes as the ``serve.slots.width`` gauge, and
``SlotScheduler.set_slot_limit`` installs it as the admission cap.  The
port serves on one card, unsharded: no dp alignment.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

#: Fraction of the budget held back from the solver (fragmentation, graph
#: pools, transient launch buffers).  Override: ``TBX_SERVE_HBM_RESERVE``.
DEFAULT_RESERVE = 0.10


def _reserve_frac() -> float:
    try:
        v = float(os.environ.get("TBX_SERVE_HBM_RESERVE", DEFAULT_RESERVE))
    except ValueError:
        return DEFAULT_RESERVE
    return min(0.9, max(0.0, v))


def _env_budget() -> Optional[int]:
    """``TBX_SERVE_AUTOTUNE_BYTES`` — explicit per-card byte budget."""
    raw = os.environ.get("TBX_SERVE_AUTOTUNE_BYTES", "").strip()
    if not raw:
        return None
    try:
        return max(0, int(float(raw)))
    except ValueError:
        return None


def _tree_bytes(tree: Any) -> int:
    """Bytes of every tensor / array leaf of ``tree`` (dicts, tuples, named
    tuples, dataclass-free)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


def serve_plan_bytes(cfg, params: Any, *, slots: int, kv_cols: int,
                     trash_cols: int = 0, bank: Any = None,
                     state: Any = None) -> Dict[str, int]:
    """Byte plan of one resident serve engine on one card (the JAX package's
    ``parallel/mesh.py`` ``serve_plan_bytes``, unsharded).

    Composes the four co-resident terms — params, the stacked delta bank,
    the KV pages (incl. a speculative engine's trash columns) and the slot
    state — and splits them the way the autotuner budgets: ``fixed_bytes``
    (params + bank, paid once) vs ``per_slot_bytes`` (KV page + slot state,
    paid per admitted slot), plus ``kv_col_bytes`` so the solver can
    re-price another speculative block G.  Params, bank and state are
    counted from their tensors (``state`` is any tree of [S]-leading
    tensors); the KV pages from ``cfg`` and the envelope."""
    params_b = _tree_bytes(params)
    bank_b = _tree_bytes(bank)
    cols = kv_cols + trash_cols
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    kv = cfg.num_layers * slots * cols * cfg.num_kv_heads * cfg.head_dim
    cache_b = 2 * kv * itemsize + slots * cols      # k, v, bool validity
    state_b = _tree_bytes(state)
    per_slot = (cache_b + state_b) // max(1, slots)
    return {
        "params_bytes": params_b,
        "bank_bytes": bank_b,
        "fixed_bytes": params_b + bank_b,
        "cache_bytes": cache_b,
        "state_bytes": state_b,
        "kv_col_bytes": cache_b // max(1, slots * cols),
        "per_slot_bytes": per_slot,
        "slots": int(slots),
        "kv_cols": int(kv_cols),
        "trash_cols": int(trash_cols),
        "total_bytes": params_b + bank_b + cache_b + state_b,
    }


@dataclasses.dataclass(frozen=True)
class AutotunePlan:
    """One solve's verdict — everything the heartbeat, the summary and the
    admission envelope consume.

    ``verdict``: ``ok`` (budget fits the configured width exactly),
    ``clamped`` (budget allows MORE — width held at config),
    ``shrunk`` (budget allows fewer — width lowered),
    ``fallback`` (no measurable budget — configured width kept).
    ``source``: ``env`` | ``hbm-limit`` | ``hbm-watermark`` | ``none``.
    """

    width: int
    spec_block: int
    admit_limit: int
    verdict: str
    source: str
    budget_bytes: Optional[int]
    fixed_bytes: int
    per_slot_bytes: int
    plan: Dict[str, int]
    measured_live_bytes: Optional[int] = None
    measured_headroom_frac: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("plan", None)   # the full byte plan rides the summary, not
        return d              # the heartbeat — callers re-attach if wanted

    def slots_block(self, active: int) -> Dict[str, Any]:
        """The heartbeat's ``slots`` occupancy block."""
        width = int(self.width)
        active = max(0, min(int(active), width))
        return {"width": width, "active": active,
                "free": width - active, "verdict": self.verdict}


def solve(engine, *, config_width: Optional[int] = None) -> AutotunePlan:
    """Solve slot width + speculative block + admission envelope for one
    resident engine against the best available per-card byte budget.

    Reads the engine's ACTUAL residency (its params, bank, speculative
    widening, slot state) — the plan prices what is resident, not what a
    config claims.  Refreshes the ``mem.*`` gauges first so the watermark
    inputs are current.  Never raises on missing signals: the worst
    outcome is the ``fallback`` verdict at the configured width.
    """
    from taboo_brittleness_tpu_torch.obs import memory, metrics

    ec = engine.ec
    config_width = int(config_width if config_width is not None else ec.slots)
    speculative = bool(getattr(engine, "speculative", False))
    block = int(getattr(engine, "block", 0)) if speculative else 0
    trash = block + 1 if speculative else 0
    state_tree = (engine.state, engine.spec) if speculative else engine.state

    plan = serve_plan_bytes(
        engine.cfg, engine.params, slots=ec.slots, kv_cols=ec.max_context,
        trash_cols=trash, bank=getattr(engine, "delta_bank", None),
        state=state_tree)
    fixed = int(plan["fixed_bytes"])
    per_slot = max(1, int(plan["per_slot_bytes"]))

    # Refresh + read the watermarks.  Gauges total across the visible
    # cards; the plan is one card's — normalize by the card count.
    memory.sample(compact=True)
    ndev = max(1, torch.cuda.device_count()) if torch.cuda.is_available() else 1
    live = metrics.gauge("mem.hbm.live_bytes").value
    limit = metrics.gauge("mem.hbm.limit_bytes").value
    headroom = metrics.gauge("mem.hbm.headroom_frac").value
    reserve = _reserve_frac()

    budget: Optional[int] = None
    source = "none"
    env_budget = _env_budget()
    if env_budget is not None:
        budget, source = int(env_budget * (1.0 - reserve)), "env"
    elif limit:
        budget = int(limit / ndev * (1.0 - reserve))
        source = "hbm-limit"
    elif live and headroom is not None and headroom < 1.0:
        inferred_limit = live / max(1e-9, 1.0 - headroom)
        budget = int(inferred_limit / ndev * (1.0 - reserve))
        source = "hbm-watermark"

    if budget is None:
        width, verdict = config_width, "fallback"
    else:
        raw = max(0, (budget - fixed) // per_slot)
        if raw >= config_width:
            width = config_width
            verdict = "clamped" if raw > config_width else "ok"
        else:
            width, verdict = max(1, raw), "shrunk"

    # The deepest speculative block the solved width still affords: each
    # extra draft column costs one KV column per slot across the width.
    spec_block = block
    if speculative and budget is not None and block > 0:
        col = max(1, int(plan["kv_col_bytes"]))
        spare = budget - fixed - width * per_slot
        delta_cols = spare // max(1, width * col)
        spec_block = int(min(block, max(1, block + delta_cols)))

    metrics.gauge("serve.slots.width").set(int(width))
    return AutotunePlan(
        width=int(width),
        spec_block=spec_block,
        admit_limit=int(2 * width),
        verdict=verdict,
        source=source,
        budget_bytes=budget,
        fixed_bytes=fixed,
        per_slot_bytes=per_slot,
        plan=plan,
        measured_live_bytes=int(live) if live else None,
        measured_headroom_frac=(round(float(headroom), 4)
                                if headroom is not None else None),
    )
