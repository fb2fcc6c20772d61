"""Per-word (draft layer, block size) calibration for speculative decoding.

The counterpart of the JAX package's ``perf/spec_calibrate.py``, with the
same artifact schema (``TBX_SPEC_CALIBRATION``).  The speculative decoder
(``runtime.speculate``) drafts from the layer-k lens head; its throughput
hangs on how often the layer-k lens ARGMAX agrees with the final head's.
Every cached lens sweep already holds per-layer argmax ids (the summary's
``argmax_id [L, T]``, or the parity dump's ``all_probs [L, T, V]``), so
calibration is a host-side read with no model launch.

The objective is Sequoia's expected-throughput form (arXiv:2402.12374): with
acceptance i.i.d. at the measured agreement α(k), a block of G drafts emits
``E[tokens] = Σ_{i=0..G} α^i`` per verify, and the chooser maximizes
``E[tokens] / (G·c_draft(k) + c_verify(G))``.  The costs are the JAX
package's decode-step byte model (weights streamed per step, reckoned for a
memory-bound decode).  On the H100 the port's eager decode step is bound by
the host, not by those bytes, so the (k, G) this picks is untested there.
numpy and stdlib only.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Calibration artifact schema version.
SCHEMA_VERSION = 1

#: Largest block size the chooser searches.
DEFAULT_MAX_BLOCK = 8


def param_count(cfg) -> int:
    """Parameter count from the architecture dims (the [V, D] embedding is
    tied: it serves input embed and unembed)."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, K, Dh, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    per_layer = (D * H * Dh            # q
                 + 2 * D * K * Dh      # k, v
                 + H * Dh * D          # o
                 + 3 * D * F           # gate, up, down
                 + 4 * D)              # sandwich norms
    return cfg.vocab_size * D + L * per_layer + D   # + final norm


def _dtype_bytes(dtype_name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}.get(dtype_name, 2)


# ---------------------------------------------------------------------------
# Agreement from cached artifacts.
# ---------------------------------------------------------------------------

def layer_agreement(argmax_id: np.ndarray,
                    response_start: int = 0) -> np.ndarray:
    """[L] agreement-with-final rates from a [L, T] per-layer argmax table
    (the last layer's row is the model's greedy head).  Only columns from
    ``response_start`` on count; all columns when none are left."""
    arr = np.asarray(argmax_id)
    if arr.ndim != 2:
        raise ValueError(f"argmax_id must be [L, T], got {arr.shape}")
    window = arr[:, response_start:]
    if window.shape[1] == 0:
        window = arr
    return (window == window[-1:]).mean(axis=1)


def agreement_from_summary(path: str) -> Optional[np.ndarray]:
    """[L] agreement rates from one compact summary npz, or None when the
    file is unreadable (a torn cell costs one prompt's evidence)."""
    try:
        with np.load(path) as data:
            if "argmax_id" not in data.files:
                return None
            arr = data["argmax_id"]
            start = 0
            if "__meta__" in data.files:
                meta = json.loads(bytes(data["__meta__"]).decode())
                start = int(meta.get("response_start", 0))
        return layer_agreement(arr, response_start=start)
    except Exception:  # noqa: BLE001 — unreadable cells are skipped
        return None


def agreement_from_pair(npz_path: str,
                        json_path: Optional[str] = None) -> Optional[np.ndarray]:
    """[L] agreement rates from a reference-schema ``all_probs`` dump; the
    response window starts where the sidecar's ``input_words`` open the
    model turn."""
    try:
        with np.load(npz_path) as data:
            if "all_probs" not in data.files:
                return None
            argmax = np.argmax(data["all_probs"], axis=-1)  # [L, T]
        start = 0
        if json_path and os.path.exists(json_path):
            with open(json_path) as f:
                meta = json.load(f)
            words = meta.get("input_words")
            if words:
                from taboo_brittleness_tpu_torch.runtime import chat

                start = chat.find_model_response_start(words)
        return layer_agreement(argmax, response_start=start)
    except Exception:  # noqa: BLE001
        return None


def word_agreement(processed_dir: str, word: str) -> Optional[np.ndarray]:
    """Mean [L] agreement over every readable cached prompt of ``word``
    (summaries and parity pairs); None when the word has no cache."""
    word_dir = os.path.join(processed_dir, word)
    if not os.path.isdir(word_dir):
        return None
    rates: List[np.ndarray] = []
    for name in sorted(os.listdir(word_dir)):
        path = os.path.join(word_dir, name)
        if name.endswith(".summary.npz"):
            got = agreement_from_summary(path)
        elif name.endswith(".npz"):
            got = agreement_from_pair(path, path[:-4] + ".json")
        else:
            continue
        if got is not None:
            rates.append(got)
    if not rates:
        return None
    L = min(r.shape[0] for r in rates)
    return np.mean([r[:L] for r in rates], axis=0)


# ---------------------------------------------------------------------------
# Expected-throughput objective.
# ---------------------------------------------------------------------------

def expected_tokens(alpha: float, block: int) -> float:
    """E[tokens emitted per verify] at i.i.d. acceptance rate α:
    ``Σ_{i=0..G} α^i`` (the accepted prefix plus the bonus token)."""
    a = min(max(float(alpha), 0.0), 1.0)
    if a >= 1.0:
        return float(block + 1)
    return (1.0 - a ** (block + 1)) / (1.0 - a)


def _decode_step_bytes(cfg, rows: int) -> Dict[str, float]:
    """Per-step byte costs the objective weighs: the full weight stream,
    one layer's share of it, the lens-unembed stream and the per-row KV
    read per cached column."""
    wb = _dtype_bytes(getattr(cfg, "param_dtype", "bfloat16"))
    cb = _dtype_bytes(getattr(cfg, "dtype", "bfloat16"))
    embed_b = float(cfg.vocab_size * cfg.hidden_size) * wb
    total_b = float(param_count(cfg)) * wb
    layer_b = (total_b - embed_b) / max(cfg.num_layers, 1)
    kv_row = float(2 * cfg.num_kv_heads * cfg.head_dim) * cb
    return {"embed": embed_b, "layer": layer_b, "total": total_b,
            "kv_per_row_col": kv_row}


def block_cost(cfg, draft_layer: int, block: int, *, rows: int = 1,
               seq_len: int = 128) -> Tuple[float, float, float]:
    """(draft_step_cost, verify_cost, vanilla_step_cost) in bytes PER ROW at
    ``rows`` rows and ~``seq_len`` cached columns.  Weight streams are
    shared by the launch's rows (1/rows each); the KV read is per row.  The
    verify streams the weights once for its G + 1 positions."""
    b = _decode_step_bytes(cfg, rows)
    r = max(int(rows), 1)
    kv_row = b["kv_per_row_col"] * seq_len
    draft_frac = (draft_layer + 1) / max(cfg.num_layers, 1)
    draft = ((b["layer"] * (draft_layer + 1) + b["embed"]) / r
             + kv_row * draft_frac)
    verify = b["total"] / r + kv_row
    vanilla = b["total"] / r + kv_row
    return draft, verify, vanilla


def calibrate_word(agreement: Sequence[float], cfg, *,
                   max_block: int = DEFAULT_MAX_BLOCK,
                   rows: int = 1, seq_len: int = 128,
                   layer_grid: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """The (k, G) maximizing expected tokens per byte cost for one word,
    from its [L] agreement vector (k <= L - 2), with the evidence: the
    agreement at k, the expected tokens per verify and the modeled speedup
    over vanilla greedy."""
    agreement = np.asarray(agreement, dtype=float)
    L = agreement.shape[0]
    ks = [k for k in (layer_grid if layer_grid is not None else range(L - 1))
          if 0 <= k <= L - 2]
    if not ks:
        raise ValueError(f"no admissible draft layers for L={L}")
    best: Optional[Dict[str, Any]] = None
    for k in ks:
        alpha = float(agreement[k])
        draft_c, verify_c, vanilla_c = block_cost(
            cfg, k, 1, rows=rows, seq_len=seq_len)
        for g in range(1, max_block + 1):
            toks = expected_tokens(alpha, g)
            rate = toks / (g * draft_c + verify_c)
            if best is None or rate > best["_rate"]:
                best = {"draft_layer": int(k), "block_size": int(g),
                        "agreement": round(alpha, 4),
                        "expected_tokens_per_verify": round(toks, 3),
                        "expected_speedup": round(rate * vanilla_c, 3),
                        "_rate": rate}
    assert best is not None
    best.pop("_rate")
    return best


def calibrate_words(processed_dir: str, words: Sequence[str], cfg, *,
                    max_block: int = DEFAULT_MAX_BLOCK, rows: int = 1,
                    seq_len: int = 128) -> Dict[str, Any]:
    """The calibration artifact: a plan per word with cached lens evidence,
    a ``default`` block (the median plan) and the ``uncalibrated`` words,
    which fall through to the default at dispatch."""
    plans: Dict[str, Any] = {}
    uncalibrated: List[str] = []
    for w in words:
        agr = word_agreement(processed_dir, w)
        if agr is None:
            uncalibrated.append(w)
            continue
        plans[w] = calibrate_word(agr, cfg, max_block=max_block,
                                  rows=rows, seq_len=seq_len)
    default: Dict[str, Any] = {}
    if plans:
        ks = sorted(p["draft_layer"] for p in plans.values())
        gs = sorted(p["block_size"] for p in plans.values())
        default = {"draft_layer": ks[len(ks) // 2],
                   "block_size": gs[len(gs) // 2]}
    return {
        "schema": SCHEMA_VERSION,
        "arch": {"num_layers": int(cfg.num_layers),
                 "hidden_size": int(cfg.hidden_size),
                 "vocab_size": int(cfg.vocab_size)},
        "objective": "expected_tokens_per_verify / hbm_byte_cost "
                     "(Sequoia arXiv:2402.12374; roofline decode model)",
        "max_block": int(max_block),
        "words": plans,
        "default": default,
        "uncalibrated": uncalibrated,
    }


def write_calibration(path: str, artifact: Dict[str, Any]) -> None:
    """Atomic write (a dispatcher may read it mid-calibration)."""
    from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump

    atomic_json_dump(artifact, path)


def geometric_accept_stats(accepted: int, drafted: int) -> Dict[str, float]:
    """The i.i.d.-model α implied by measured accept counts, and the G that
    model suggests."""
    alpha = accepted / drafted if drafted else 0.0
    g_star = (int(max(1, round(-1.0 / math.log(alpha)))) if 0 < alpha < 1
              else 1)
    return {"alpha": round(alpha, 4), "suggested_block": g_star}
