"""Per-phase roofline ceilings for the sweep's three phases.

Blended MFU over the whole launch hides the structure of the workload: decode
is *memory-bound* (every generated token re-streams the weights and the KV
cache through HBM — its MFU "should" be low), while the readout and NLL
phases are *matmul-bound* (vocab-width unembeds).  A single 38% number can
therefore be simultaneously "fine" for decode and "far off" for readout
with nobody noticing.

This module computes, per phase, both classical roofline axes:

- ``compute_seconds``  = analytic matmul FLOPs / peak bf16 FLOP/s
- ``memory_seconds``   = analytic HBM bytes moved / HBM bandwidth
- ``ceiling_seconds``  = max of the two — no schedule can beat it
- ``bound``            = which axis binds ("compute" or "memory")

and, against a measured phase time, the fraction of the ceiling achieved
(``ratio`` = ceiling/achieved, 1.0 = running at the hardware bound).  The
FLOPs side counts what the launched programs actually do; the bytes side
counts *mandatory* traffic — weights, KV,
activations in, results out — not incidental copies, so a retiling copy or a
fusion miss shows up as a LOW ratio rather than being normalized away.

Numbers are analytic and deliberately simple (dozens-of-percent fidelity, not
cycle accuracy); their job is to rank gaps and certify plateaus, per phase.

The PyTorch port's copy of the JAX package's ``perf/roofline.py``, with the
H100's spec in place of the TPU rows; ``runtime.fused.phase_table`` and the
device profile read it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class RooflineSpec:
    """One chip's ceilings: bf16 matmul peak (TFLOP/s) + HBM bandwidth (GB/s).

    Source: NVIDIA's H100 SXM data sheet (dense bf16 989 TFLOP/s, HBM3
    3350 GB/s).  Override with ``BENCH_PEAK_TFLOPS`` / ``BENCH_HBM_GBPS``
    for another card or a derated one (a card held below its 700 W limit
    runs slower than its data sheet).
    """

    kind: str
    peak_tflops: float
    hbm_gbps: float

    @property
    def peak_flops(self) -> float:
        return self.peak_tflops * 1e12

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9


# bf16 matmul peak + HBM bandwidth by device name, as
# ``torch.cuda.get_device_name()`` returns it.
DEVICE_SPECS: Dict[str, RooflineSpec] = {
    kind: RooflineSpec(kind, tflops, gbps)
    for kind, tflops, gbps in (
        ("NVIDIA H100 80GB HBM3", 989.0, 3350.0),
    )
}


def device_name() -> Optional[str]:
    """The current CUDA card's name, or None without one (CPU runs: no
    ceiling to publish)."""
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001 — probing the card is best-effort
        pass
    return None


def device_spec(kind: Optional[str]) -> Optional[RooflineSpec]:
    """Spec for a device kind, with env overrides; None when unknown AND not
    overridden (CPU runs: no meaningful ceiling to publish)."""
    spec = DEVICE_SPECS.get(kind) if kind else None
    peak = os.environ.get("BENCH_PEAK_TFLOPS")
    hbm = os.environ.get("BENCH_HBM_GBPS")
    if peak is None and hbm is None:
        return spec
    if spec is None and (peak is None or hbm is None):
        return None          # an override for only one axis can't make a spec
    return RooflineSpec(
        kind=(kind or "override"),
        peak_tflops=float(peak) if peak is not None else spec.peak_tflops,
        hbm_gbps=float(hbm) if hbm is not None else spec.hbm_gbps,
    )


# ---------------------------------------------------------------------------
# Analytic FLOPs.
# ---------------------------------------------------------------------------

def phase_flops(cfg, batch: int, prompt_len: int, new_tokens: int,
                sae_width: int) -> Dict[str, float]:
    """Analytic matmul FLOPs per phase:
    {"decode", "lens", "nll", "readout"} — "lens" is the all-layer readout
    pass the MAIN bench measures (decode + lens = arm_flops); the sweep
    projection uses decode/readout/nll, matching its measured phases.

    Counts what the launched programs do, not an idealized lower bound: the
    SAE edit runs at the tap layer only, decode attention spans the
    fixed-size cache each step.  Kept per-phase so cross-model projections
    scale each measured phase by ITS OWN cost ratio — the lens pass is
    vocab-readout-dominated (L·2·D·V per token) while decode/NLL scale like a
    plain forward, so one blended ratio would misweight them.
    """
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, V = cfg.num_layers, cfg.vocab_size
    t_total = prompt_len + new_tokens
    # q,k,v,o projections + GeGLU (gate/up/down), 2 FLOPs per MAC.
    per_tok_layer = 4 * D * H * Dh + 4 * D * K * Dh + 6 * D * F

    def attn(tokens, kv_len):
        return tokens * 4 * H * Dh * kv_len     # qk^T + weighted-sum

    toks_prefill = batch * prompt_len
    toks_decode = batch * new_tokens
    decode_f = (toks_prefill + toks_decode) * L * per_tok_layer
    decode_f += attn(toks_prefill, prompt_len) * L
    decode_f += attn(toks_decode, t_total) * L  # full fixed-size cache per step
    decode_f += toks_decode * 2 * D * V         # unembed per generated token
    # In-graph SAE edit (encode dominates), cond-gated to the tap layer.
    decode_f += (toks_prefill + toks_decode) * 2 * D * sae_width

    # Lens pass: full-sequence forward + the per-layer vocab readout.
    toks_lens = batch * t_total
    lens_f = toks_lens * L * per_tok_layer + attn(toks_lens, t_total) * L
    lens_f += toks_lens * L * 2 * D * V         # the dominant term
    lens_f += toks_lens * 2 * D * sae_width     # edit rides this pass too

    # NLL pass: a teacher-forced CONTINUATION from the decode's prefill KV
    # cache over the response window (cols [prompt_len-1, T); the prompt
    # columns are never forwarded twice — interventions._nll_cached_jit),
    # plus ONE unembed over the predictor columns.
    toks_nll = batch * (new_tokens + 1)
    nll_f = toks_nll * L * per_tok_layer + attn(toks_nll, t_total) * L
    nll_f += batch * new_tokens * 2 * D * V
    nll_f += toks_nll * 2 * D * sae_width

    # Readout: tap-layer stats from the decode-captured residual — one
    # [T, V] lens readout per row, NO model forward at all.  The production
    # program slices to the response window (resp_start = prompt_len - 1):
    # prompt_len + new_tokens - resp_start = new_tokens + 1 columns.
    readout_f = batch * (new_tokens + 1) * 2 * D * V
    return {"decode": float(decode_f), "lens": float(lens_f),
            "nll": float(nll_f), "readout": float(readout_f)}


def arm_flops(cfg, batch: int, prompt_len: int, new_tokens: int,
              sae_width: int) -> float:
    """FLOPs of the main bench's arm_step (decode + lens; no NLL phase)."""
    f = phase_flops(cfg, batch, prompt_len, new_tokens, sae_width)
    return f["decode"] + f["lens"]


# ---------------------------------------------------------------------------
# Analytic HBM bytes.
# ---------------------------------------------------------------------------

def param_count(cfg) -> int:
    """Parameter count from the architecture dims (embedding tied: one
    [V, D] table serves input embed and unembed)."""
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


def sweep_phase_bytes(cfg, rows: int, prompt_len: int, new_tokens: int,
                      sae_width: int, *,
                      readout_chunk: Optional[int] = None,
                      sae_dtype_bytes: int = 4) -> Dict[str, float]:
    """Mandatory HBM traffic (bytes) per sweep phase at ``rows`` batch rows.

    Counts weight/KV/activation streams the computation cannot avoid:

    - **decode**: the weights stream through HBM once for prefill and once
      per generated token (the per-step floor that dp scaling cannot shrink);
      the fixed-size KV cache is re-read every step and the new token's K/V
      written; the SAE encode/decode matrices ride every step (cond-gated to
      one layer, but their operands still stream).  Per-token activations are
      O(rows·D·L) per step — charged, though they are noise next to the
      weights.
    - **readout**: the [rows, Ts, D] f32 residual in, the [V, D] unembedding
      streamed once per row chunk (it is re-read from HBM for each chunk —
      bigger chunks mean fewer streams), and O(rows·K) results out.  The
      [chunk, Ts, V] probability slab is treated as *transient* (the fused
      ideal); a materialized slab lowers the achieved ratio instead of
      raising the ceiling.
    - **nll**: one weights stream (teacher-forced continuation over the
      response window), the prefill KV read + the window's KV written and
      re-read, the unembedding streamed once per row chunk, hidden states in.

    ``Ts`` is the response window (new_tokens + 1 columns — the production
    programs slice to resp_start = prompt_len - 1).
    """
    D = cfg.hidden_size
    K, Dh, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    V = cfg.vocab_size
    wb = _dtype_bytes(getattr(cfg, "param_dtype", "bfloat16"))
    cb = _dtype_bytes(getattr(cfg, "dtype", "bfloat16"))
    t_total = prompt_len + new_tokens
    ts = new_tokens + 1

    p_bytes = float(param_count(cfg)) * wb
    sae_bytes = float(2 * D * sae_width + 2 * sae_width + D) * sae_dtype_bytes
    kv_slab = float(2 * L * rows * t_total * K * Dh) * cb   # full k+v cache
    kv_tok = float(2 * L * rows * K * Dh) * cb              # one column
    act_tok = float(rows * D * L) * cb                      # per-step resid stream

    decode_b = (
        p_bytes * (new_tokens + 1)          # prefill + every decode step
        + sae_bytes * (new_tokens + 1)
        + kv_slab * new_tokens              # cache re-read per step
        + kv_tok * (prompt_len + new_tokens)  # cache writes
        + act_tok * new_tokens
        + float(rows * prompt_len * D) * cb * 2   # prefill activations in/out
    )

    chunk = readout_chunk or default_readout_chunk(ts, V)
    n_chunks = -(-rows // max(chunk, 1))
    unembed_stream = float(V * D) * wb
    readout_b = (
        unembed_stream * n_chunks           # re-read per row chunk
        + float(rows * ts * D) * 4          # f32 residual in
        + float(rows * ts) * 4 * 3          # tap_prob + masks out/in
    )

    nll_b = (
        p_bytes                             # one weights stream
        + sae_bytes
        + unembed_stream * n_chunks         # chunked NLL readout
        + kv_slab                           # prefill KV read + window re-read
        + kv_tok * ts                       # window KV writes
        + float(rows * ts * D) * cb * 2     # hidden states through the stack
    )
    return {"decode": decode_b, "readout": readout_b, "nll": nll_b}


def default_readout_chunk(t_cols: int, vocab: int,
                          budget_bytes: float = 0.7e9) -> int:
    """Rows per readout chunk under the [chunk, t_cols, V] f32 transient
    budget — the same arithmetic as ``interventions._row_chunk`` (kept in
    sync by tests, not imports: perf/ imports nothing of the pipelines)."""
    per_row = max(t_cols * vocab * 4, 1)
    return max(1, min(32, int(budget_bytes // per_row)))


# ---------------------------------------------------------------------------
# Report assembly.
# ---------------------------------------------------------------------------

def _sig(x: float, digits: int = 4) -> float:
    """Round to significant digits: phase times span seconds (bench shapes)
    to tens of nanoseconds (tiny test shapes), so fixed decimals would
    collapse the small end to 0.0."""
    return float(f"{x:.{digits}g}")


def phase_report(flops: float, bytes_: float, spec: RooflineSpec,
                 measured_seconds: Optional[float] = None) -> Dict[str, object]:
    """One phase's roofline: ceiling seconds (max of compute/memory time),
    which axis binds, and — when a measurement is supplied — the achieved
    fraction of the ceiling (1.0 = at the hardware bound)."""
    compute_s = flops / spec.peak_flops
    memory_s = bytes_ / spec.hbm_bytes_per_s
    ceiling_s = max(compute_s, memory_s)
    out: Dict[str, object] = {
        "flops": flops,
        "hbm_bytes": bytes_,
        "compute_seconds": _sig(compute_s),
        "memory_seconds": _sig(memory_s),
        "ceiling_seconds": _sig(ceiling_s),
        "bound": "compute" if compute_s >= memory_s else "memory",
        "arithmetic_intensity_flops_per_byte": round(flops / max(bytes_, 1.0), 1),
    }
    if measured_seconds is not None:
        out["achieved_seconds"] = round(float(measured_seconds), 4)
        out["ratio_of_ceiling"] = (
            round(ceiling_s / measured_seconds, 3)
            if measured_seconds > 0 else None)
        out["achieved_tflops"] = (
            round(flops / measured_seconds / 1e12, 2)
            if measured_seconds > 0 else None)
        out["achieved_gbps"] = (
            round(bytes_ / measured_seconds / 1e9, 1)
            if measured_seconds > 0 else None)
    return out


def sweep_roofline(cfg, rows: int, prompt_len: int, new_tokens: int,
                   sae_width: int, measured: Dict[str, float],
                   spec: Optional[RooflineSpec],
                   *, readout_chunk: Optional[int] = None) -> Optional[Dict]:
    """Per-phase {achieved, ceiling, ratio, bound} for the sweep's three
    phases at one launch shape.  ``measured`` maps phase name to measured
    seconds.  None when no spec is known (CPU runs)."""
    if spec is None:
        return None
    prompts = max(rows, 1)
    flops = phase_flops(cfg, prompts, prompt_len, new_tokens, sae_width)
    bytes_ = sweep_phase_bytes(cfg, rows, prompt_len, new_tokens, sae_width,
                               readout_chunk=readout_chunk)
    phases = {}
    for name in ("decode", "readout", "nll"):
        phases[name] = phase_report(flops[name], bytes_[name], spec,
                                    measured.get(name))
    worst = min((p for p in phases.values()
                 if p.get("ratio_of_ceiling") is not None),
                key=lambda p: p["ratio_of_ceiling"], default=None)
    return {
        "spec": {"device_kind": spec.kind,
                 "peak_bf16_tflops": spec.peak_tflops,
                 "hbm_gbps": spec.hbm_gbps},
        "phases": phases,
        "worst_phase": (
            next(k for k, v in phases.items() if v is worst)
            if worst is not None else None),
        "note": "ceiling = max(flops/peak, mandatory HBM bytes/bandwidth) per "
                "phase; ratio_of_ceiling = ceiling/achieved (1.0 = at the "
                "hardware bound). Bytes count weights/KV/activations, not "
                "incidental copies — fusion misses LOWER the ratio.",
    }
