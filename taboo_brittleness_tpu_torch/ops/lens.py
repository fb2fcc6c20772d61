"""Logit-lens readout over the Gemma-2 forward.

The counterpart of the JAX package's ``ops/lens.py`` (dense, single-device
paths).  The reference materializes ``softmax(lm_head(norm(resid)))`` for all
42 layers as a ``[42, seq, 256000]`` f32 tensor and reads tiny slices of it:
the target token's probability per (layer, position), the top-k of a masked
positional sum at one layer, and the argmax per (layer, position).  Here those
reductions run per layer through the ``per_layer_fn`` tap of
``models.gemma2.forward``:

- on CUDA tensors, :func:`make_kernel_lens_tap` runs the fused kernel
  (``ops.lens_kernel.lens_stats``, the port of the Pallas kernel), so a
  layer's ``[B, T, V]`` logits never reach device memory;
- on CPU tensors, :func:`make_lens_tap` computes the softmax and its top-k in
  plain torch (the JAX package's XLA tap).

Each plain path keeps the rounding of its JAX counterpart: the XLA tap forms
the logits in the compute dtype and casts to f32 afterwards; the kernel and
its plain version accumulate in f32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from taboo_brittleness_tpu_torch.models.gemma2 import (
    Gemma2Config,
    Params,
    forward,
    rms_norm,
)
from taboo_brittleness_tpu_torch.ops.lens_kernel import lens_stats, topk_lowest_id

class LensTap(NamedTuple):
    """Per-layer lens statistics, stacked ``[L, ...]`` by the forward.

    ``target_prob``  [L, B, T]      P(target token) at every layer/position.
    ``argmax_id``    [L, B, T]      lens argmax token id.
    ``argmax_prob``  [L, B, T]      its probability.
    ``topk_ids``     [L, B, T, K]   per-position lens top-k ids.
    ``topk_probs``   [L, B, T, K]
    """

    target_prob: torch.Tensor
    argmax_id: torch.Tensor
    argmax_prob: torch.Tensor
    topk_ids: torch.Tensor
    topk_probs: torch.Tensor


def lens_embed(params: Params, cfg: Gemma2Config,
               dtype: torch.dtype) -> torch.Tensor:
    """The [V, D] lens head for residuals of ``dtype``: the embedding in the
    compute dtype, promoted to the residual's dtype (an f32 copy for f32
    residuals; callers over many chunks make it once)."""
    embed = params["embed"].to(cfg.compute_dtype)
    return embed.to(torch.promote_types(dtype, embed.dtype))


def _lens_logits(params: Params, cfg: Gemma2Config, h: torch.Tensor, *,
                 embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 lens logits: lm_head(final_norm(h)), no final softcap (the
    reference lens calls ``lm_head`` directly).

    The product runs in the promoted dtype of ``h`` and the embedding (the
    compute dtype for the per-layer taps, f32 for an f32 residual) and is
    cast to f32 afterwards, as in the JAX package.  ``embed`` is
    :func:`lens_embed`'s head, when the caller holds one."""
    x = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if embed is None:
        embed = lens_embed(params, cfg, x.dtype)
    return (x.to(embed.dtype) @ embed.T).float()


def lens_probs(params: Params, cfg: Gemma2Config, h: torch.Tensor, *,
               embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(lm_head(final_norm(h))) in f32."""
    return torch.softmax(_lens_logits(params, cfg, h, embed=embed), dim=-1)


def lens_probs_foldexp(params: Params, cfg: Gemma2Config, h: torch.Tensor, *,
                       embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`lens_probs` normalised as ``exp(logit - logsumexp)`` (the JAX
    package's readout default); equal to the softmax up to final rounding."""
    logits = _lens_logits(params, cfg, h, embed=embed)
    return torch.exp(logits - torch.logsumexp(logits, dim=-1, keepdim=True))


def lens_argmax(params: Params, cfg: Gemma2Config,
                h: torch.Tensor) -> torch.Tensor:
    """Greedy lens readout: the argmax of the layer-h lens logits (int64,
    first index among equal logits) — the speculative decoder's draft
    head.  The final softcap is skipped: it is strictly monotone, so the
    argmax is the same.  A plain product, not a ``lens_stats`` launch: it
    runs at [B, 1, V] per draft step."""
    return torch.argmax(_lens_logits(params, cfg, h), dim=-1)


def make_lens_tap(
    params: Params,
    cfg: Gemma2Config,
    target_ids: torch.Tensor,   # [B] one target token id per batch row
    *,
    top_k: int = 5,
) -> Callable[[torch.Tensor, int], LensTap]:
    """Plain ``per_layer_fn`` computing :class:`LensTap` stats for one layer
    from the layer's full [B, T, V] probabilities."""
    target_ids = target_ids.long()

    def tap(h: torch.Tensor, layer_idx: int) -> LensTap:
        del layer_idx
        probs = lens_probs(params, cfg, h)
        B, T, _ = probs.shape
        tgt = torch.gather(
            probs, -1, target_ids[:, None, None].expand(B, T, 1))[..., 0]
        topk_probs, topk_ids = topk_lowest_id(probs, top_k)
        return LensTap(target_prob=tgt, argmax_id=topk_ids[..., 0],
                       argmax_prob=topk_probs[..., 0], topk_ids=topk_ids,
                       topk_probs=topk_probs)

    return tap


def make_kernel_lens_tap(
    params: Params,
    cfg: Gemma2Config,
    target_id: int,          # one target for the whole batch
    *,
    top_k: int = 5,
) -> Callable[[torch.Tensor, int], LensTap]:
    """Fused-kernel variant of :func:`make_lens_tap` (the JAX package's
    ``make_pallas_lens_tap``): one :func:`~.lens_kernel.lens_stats` call per
    layer over the B*T rows."""
    embed = params["embed"].to(cfg.compute_dtype).contiguous()

    def tap(h: torch.Tensor, layer_idx: int) -> LensTap:
        del layer_idx
        B, T, D = h.shape
        x = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        stats = lens_stats(x.reshape(B * T, D).contiguous(), embed, target_id,
                           top_k=top_k)
        topk_probs = stats.topk_probs().reshape(B, T, top_k)
        topk_ids = stats.topk_ids.reshape(B, T, top_k)
        return LensTap(target_prob=stats.target_prob().reshape(B, T),
                       argmax_id=topk_ids[..., 0],
                       argmax_prob=topk_probs[..., 0], topk_ids=topk_ids,
                       topk_probs=topk_probs)

    return tap


def residual_carry_tap(batch: int, seq: int, hidden: int, tap_layer: int, *,
                       device: torch.device):
    """(init, update) carry tap capturing resid_post at ``tap_layer`` in f32:
    one [B, T, D] buffer however deep the model.  The update selects ``h``
    itself at the tap layer, so the captured bits are the layer's output."""
    acc0 = torch.zeros((batch, seq, hidden), dtype=torch.float32, device=device)

    def accumulate(acc: torch.Tensor, h: torch.Tensor,
                   layer_idx: int) -> torch.Tensor:
        return h.float() if layer_idx == tap_layer else acc

    return acc0, accumulate


def residual_multi_tap(batch: int, seq: int, hidden: int,
                       tap_layers: Tuple[int, ...], *, device: torch.device):
    """Multi-layer :func:`residual_carry_tap`: one [B, T, D] f32 buffer per
    tap layer, carried as a tuple (K buffers for K taps, never the stacked
    [L, B, T, D] tensor).  The grid sweep decodes each word once while
    tapping every grid layer.  Each slot takes ``h.float()`` at its layer,
    the single-tap update itself, so slot k is bit-equal to a single-tap
    capture at ``tap_layers[k]``.  Duplicate layers raise."""
    taps = tuple(int(t) for t in tap_layers)
    if len(set(taps)) != len(taps):
        raise ValueError(f"duplicate tap layers {taps}; each grid layer "
                         "captures exactly one slot")
    acc0 = tuple(torch.zeros((batch, seq, hidden), dtype=torch.float32,
                             device=device) for _ in taps)

    def accumulate(acc: Tuple[torch.Tensor, ...], h: torch.Tensor,
                   layer_idx: int) -> Tuple[torch.Tensor, ...]:
        if layer_idx not in taps:
            return acc
        hf = h.float()
        return tuple(hf if layer_idx == t else a for a, t in zip(acc, taps))

    return acc0, accumulate


class LensForwardResult(NamedTuple):
    tap: LensTap                 # stacked [L, B, T, ...]
    residual: torch.Tensor       # [B, T, D] resid_post at tap_layer (f32)


def lens_forward(
    params: Params,
    cfg: Gemma2Config,
    input_ids: torch.Tensor,            # [B, T]
    target_ids: torch.Tensor,           # [B]
    *,
    tap_layer: int,
    top_k: int = 5,
    positions: Optional[torch.Tensor] = None,
    attn_validity: Optional[torch.Tensor] = None,
    use_pallas: Optional[bool] = None,
) -> LensForwardResult:
    """One forward: lens stats for every layer, plus the residual at
    ``tap_layer`` (the SAE path's ``residual_stream_l31``).

    ``use_pallas`` keeps the JAX package's name for the fused readout, which
    here is the CUDA kernel.  ``None`` picks the kernel for CUDA tensors and
    the plain tap for CPU tensors; ``True`` on CPU tensors raises (the kernel
    runs only on the card).  The kernel tap needs one target id shared by
    the batch (true per word in every pipeline).
    """
    on_cuda = input_ids.device.type == "cuda"
    if use_pallas is None:
        use_pallas = on_cuda
    if use_pallas:
        if not on_cuda:
            raise ValueError(
                f"the lens kernel runs on CUDA tensors only (inputs on "
                f"{input_ids.device}); pass use_pallas=None or False")
        uniq = torch.unique(target_ids)
        if uniq.numel() > 1:
            raise ValueError(
                "the lens kernel needs ONE target id shared by the batch "
                f"(got {uniq.numel()} distinct); pass use_pallas=False")
        stats_tap = make_kernel_lens_tap(params, cfg, int(uniq[0].item()),
                                         top_k=top_k)
    else:
        stats_tap = make_lens_tap(params, cfg, target_ids, top_k=top_k)
    B, T = input_ids.shape
    res = forward(
        params, cfg, input_ids,
        positions=positions,
        attn_validity=attn_validity,
        per_layer_fn=stats_tap,
        carry_tap=residual_carry_tap(B, T, cfg.hidden_size, tap_layer,
                                     device=input_ids.device),
        compute_logits=False,
    )
    return LensForwardResult(tap=res.taps, residual=res.carry_tap)


def full_probs_forward(
    params: Params,
    cfg: Gemma2Config,
    input_ids: torch.Tensor,
    *,
    tap_layer: int,
    positions: Optional[torch.Tensor] = None,
    attn_validity: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parity mode: (all_probs [L, B, T, V] f32, residual [B, T, D] f32 at
    ``tap_layer``), the reference cache schema.  Small T only: this is the
    GB-scale tensor the lens taps exist to avoid."""
    B, T = input_ids.shape
    carry = residual_carry_tap(B, T, cfg.hidden_size, tap_layer,
                               device=input_ids.device)
    res = forward(params, cfg, input_ids, positions=positions,
                  attn_validity=attn_validity,
                  per_layer_fn=lambda h, layer_idx: lens_probs(params, cfg, h),
                  carry_tap=carry, compute_logits=False)
    return res.taps, res.carry_tap


# ---------------------------------------------------------------------------
# Response aggregation (the analysis step of the reference's
# src/01_reproduce_logit_lens.py:35-71).
# ---------------------------------------------------------------------------

def aggregate_masked_sum(
    probs: torch.Tensor,          # [..., T, V] lens probs at the layer of interest
    token_ids: torch.Tensor,      # [..., T] input token id at each position
    response_mask: torch.Tensor,  # [..., T] bool: True inside the model's response
    *,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the position-summed probs with current+previous-token zeroing.

    At each response position the probability of the token *at* that
    position and of the token at the *previous* position are zeroed (the
    lens trivially predicts copies), then the probabilities are summed over
    response positions and the top-k vocab ids win.  Leading axes are batch
    axes.  Returns (ids [..., K] int32, summed probs [..., K])."""
    V = probs.shape[-1]
    ids = token_ids.long()
    prev = torch.cat([ids.new_full(ids.shape[:-1] + (1,), -1), ids[..., :-1]],
                     dim=-1)
    masked = torch.where(response_mask[..., None], probs, torch.zeros_like(probs))
    for col in (ids, prev):
        inside = ((col >= 0) & (col < V))[..., None]
        at = torch.where(inside, col[..., None], torch.zeros_like(col[..., None]))
        # Out-of-range ids write back the value already there.
        kept = torch.gather(masked, -1, at)
        masked.scatter_(-1, at, torch.where(inside, torch.zeros_like(kept), kept))
    summed = masked.sum(dim=-2)
    top_probs, top_ids = topk_lowest_id(summed, top_k)
    return top_ids, top_probs


def spike_positions(
    target_prob_at_layer: torch.Tensor,  # [..., T] P(secret) at the layer of interest
    response_mask: torch.Tensor,          # [..., T] bool
    *,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k response positions by secret-token lens probability (the
    "spike" tokens where interventions apply), ties to the lower position.
    Returns (positions [..., K] int64, probs [..., K]).

    When the response has fewer than ``top_k`` tokens the surplus slots
    repeat the best valid position with prob 0, so they never point at a pad
    or prompt column."""
    masked = torch.where(response_mask, target_prob_at_layer.float(),
                         torch.full_like(target_prob_at_layer, -1.0,
                                         dtype=torch.float32))
    probs, pos = topk_lowest_id(masked, top_k)
    pos = pos.long()
    invalid = probs < 0.0
    pos = torch.where(invalid, pos[..., :1].expand_as(pos), pos)
    probs = torch.where(invalid, torch.zeros_like(probs), probs)
    return pos, probs


# The JAX package jits a vmap of spike_positions over [B, T] rows under this
# name; the torch function takes leading batch axes already.
spike_positions_batch = spike_positions


@torch.no_grad()
def aggregate_from_residual(
    params: Params,
    cfg: Gemma2Config,
    residual: torch.Tensor,       # [B, T, D] tapped residuals (f32)
    token_ids: torch.Tensor,      # [B, T]
    response_mask: torch.Tensor,  # [B, T] bool
    *,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lens probs at one layer + masked-sum aggregation + top-k for every
    row.  XLA fuses the JAX version so no [B, T, V] buffer exists; eager
    torch would keep one (1.2 GB f32 at 9B), so the rows go one at a time
    and only one row's [T, V] probabilities (and the logits they come from)
    are alive.  Returns (ids [B, K] int32, sums [B, K])."""
    out_ids, out_probs = [], []
    for b in range(residual.shape[0]):
        probs = lens_probs(params, cfg, residual[b])
        ids, sums = aggregate_masked_sum(probs, token_ids[b], response_mask[b],
                                         top_k=top_k)
        out_ids.append(ids)
        out_probs.append(sums)
    return torch.stack(out_ids), torch.stack(out_probs)

