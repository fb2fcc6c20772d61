"""Sequence-parallel (long-context) forward over the ``sp`` mesh axis.

The counterpart of the JAX package's ``parallel/sp.py``.  ``forward_sp``
runs the whole Gemma-2 forward with the sequence split over the ``sp``
ranks: every per-token op (embed, norms, projections, MLP, the lens
readout) is position-local and runs unchanged on this rank's
``[B, T/sp, D]`` block; attention, the only cross-token op, goes through
``ring.ring_attention``.  Sliding and global layers differ only in the
window the ring masks with.

Callers pass the whole ``[B, T]`` inputs on every rank (JAX's replicated
inputs); each rank takes its block, and the results are gathered back over
``sp`` (and ``dp``) so every rank returns the whole outputs, as JAX's
``out_specs`` assemble global arrays.

Scope, as in JAX: teacher-forced full-sequence passes (the lens workload).
The KV-cache decode stays dense.  Params are whole on every sp rank.
``lens_forward_sp`` is the product entry point: the per-layer lens
statistics are position-local, so they need no communication beyond the
ring.  ``ops.lens.lens_forward`` routes here when the mesh has ``sp > 1``
and ``tp == 1``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from taboo_brittleness_tpu_torch.models import gemma2
from taboo_brittleness_tpu_torch.parallel import ring


def _ring_attend_factory(cfg: gemma2.Gemma2Config, mesh, pos_l: torch.Tensor,
                         val_l: torch.Tensor) -> Callable:
    """This rank's attention: one ring serves sliding and global layers."""

    def ring_attend(q, k, v, layer_idx):
        window = cfg.sliding_window if cfg.is_sliding(layer_idx) else None
        return ring.ring_attention(
            q, k, v, pos_l, pos_l, val_l, mesh=mesh,
            scaling=cfg.query_pre_attn_scalar ** -0.5,
            logit_cap=cfg.attn_logit_softcap, sliding_window=window)

    return ring_attend


def _block(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's ``sp`` block of ``x`` along ``dim``."""
    per = x.shape[dim] // mesh.shape["sp"]
    return x.narrow(dim, mesh.axis_index("sp") * per, per)


class SPForwardResult(NamedTuple):
    logits: Optional[torch.Tensor]      # [B, T, V] (softcapped) or None
    last_hidden: torch.Tensor           # [B, T, D]
    residual: Optional[torch.Tensor]    # [B, T, D] f32 resid_post at tap_layer


@torch.no_grad()
def forward_sp(
    params: gemma2.Params,
    cfg: gemma2.Gemma2Config,
    input_ids: torch.Tensor,            # [B, T], T % sp == 0
    mesh,
    *,
    positions: Optional[torch.Tensor] = None,
    attn_validity: Optional[torch.Tensor] = None,
    tap_layer: Optional[int] = None,
    compute_logits: bool = True,
    edit_fn: Optional[Callable] = None,
) -> SPForwardResult:
    """One sp-split forward; the outputs come back whole on every rank.
    ``tap_layer`` captures the residual with the carry tap, as
    ``ops.lens.lens_forward`` does."""
    from taboo_brittleness_tpu_torch.ops.lens import residual_carry_tap

    B, T = input_ids.shape
    sp = mesh.shape["sp"]
    if T % sp:
        raise ValueError(f"sequence length {T} not divisible by sp={sp}")
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    if attn_validity is None:
        attn_validity = torch.ones((B, T), dtype=torch.bool, device=dev)
    ids_l, pos_l, val_l = (_block(t, mesh, 1).contiguous()
                           for t in (input_ids, positions, attn_validity))
    carry = (residual_carry_tap(B, T // sp, cfg.hidden_size, tap_layer,
                                device=dev) if tap_layer is not None else None)
    res = gemma2.forward(
        params, cfg, ids_l, positions=pos_l, attn_validity=val_l,
        edit_fn=edit_fn, carry_tap=carry, compute_logits=compute_logits,
        attend_fn=_ring_attend_factory(cfg, mesh, pos_l, val_l))

    def whole(x):
        return None if x is None else mesh.all_gather(x, "sp", dim=1)

    return SPForwardResult(logits=whole(res.logits),
                           last_hidden=whole(res.last_hidden),
                           residual=whole(res.carry_tap))


def _sp_lens_tap(params, cfg, targets: torch.Tensor, top_k: int,
                 logit_softcap: Optional[float]):
    """The per-layer lens tap of this rank's block: the lens kernel with a
    per-row target on the card (``lens_stats`` takes one id per row), the
    plain tap on the CPU."""
    from taboo_brittleness_tpu_torch.ops.lens import LensTap, make_lens_tap
    from taboo_brittleness_tpu_torch.ops.lens_kernel import lens_stats

    if not targets.is_cuda:
        if logit_softcap is not None:
            raise ValueError("the plain lens tap takes no logit softcap")
        return make_lens_tap(params, cfg, targets, top_k=top_k)
    embed = params["embed"].to(cfg.compute_dtype).contiguous()

    def tap(h: torch.Tensor, layer_idx: int):
        del layer_idx
        B, T, D = h.shape
        x = gemma2.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        stats = lens_stats(
            x.reshape(B * T, D).to(cfg.compute_dtype).contiguous(), embed,
            targets[:, None].expand(B, T).reshape(-1).to(torch.int32),
            top_k=top_k, logit_cap=logit_softcap)
        topk_probs = stats.topk_probs().reshape(B, T, top_k)
        topk_ids = stats.topk_ids.long().reshape(B, T, top_k)
        return LensTap(target_prob=stats.target_prob().reshape(B, T),
                       argmax_id=topk_ids[..., 0],
                       argmax_prob=topk_probs[..., 0], topk_ids=topk_ids,
                       topk_probs=topk_probs)

    return tap


@torch.no_grad()
def lens_forward_sp(
    params: gemma2.Params,
    cfg: gemma2.Gemma2Config,
    input_ids: torch.Tensor,            # [B, T]
    target_ids: torch.Tensor,           # [B]
    mesh,
    *,
    tap_layer: int,
    top_k: int = 5,
    positions: Optional[torch.Tensor] = None,
    attn_validity: Optional[torch.Tensor] = None,
    edit_fn: Optional[Callable] = None,
    logit_softcap: Optional[float] = None,
):
    """Sequence-parallel lens pass: per-layer ``LensTap`` statistics and the
    tap-layer residual, batch split over ``dp`` and sequence over ``sp``.
    The sequence is right-padded with invalid columns to a multiple of
    ``sp`` (masked out of attention, stripped from the outputs), so any T
    works.  ``edit_fn`` sees this rank's ``[b, T/sp, D]`` block.  Returns
    ``ops.lens.LensForwardResult``, whole on every rank."""
    from taboo_brittleness_tpu_torch.ops.lens import (
        LensForwardResult, LensTap, residual_carry_tap)

    B, T = input_ids.shape
    sp = mesh.shape["sp"]
    dp = mesh.shape.get("dp", 1)
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    if attn_validity is None:
        attn_validity = torch.ones((B, T), dtype=torch.bool, device=dev)
    pad = (-T) % sp
    if pad:
        def right(x, fill):
            return torch.cat([x, x.new_full((B, pad), fill)], dim=1)

        input_ids = right(input_ids, 0)
        positions = right(positions, 0)
        attn_validity = right(attn_validity, False)
    per_b = B // dp
    rows = slice(mesh.axis_index("dp") * per_b,
                 (mesh.axis_index("dp") + 1) * per_b)
    ids_l, pos_l, val_l = (_block(t[rows], mesh, 1).contiguous()
                           for t in (input_ids, positions, attn_validity))
    tgt_l = target_ids[rows]
    res = gemma2.forward(
        params, cfg, ids_l, positions=pos_l, attn_validity=val_l,
        per_layer_fn=_sp_lens_tap(params, cfg, tgt_l, top_k, logit_softcap),
        carry_tap=residual_carry_tap(per_b, ids_l.shape[1], cfg.hidden_size,
                                     tap_layer, device=dev),
        edit_fn=edit_fn, compute_logits=False,
        attend_fn=_ring_attend_factory(cfg, mesh, pos_l, val_l))

    def whole(x: torch.Tensor, batch_dim: int) -> torch.Tensor:
        x = mesh.all_gather(x, "sp", dim=batch_dim + 1)
        x = mesh.all_gather(x, "dp", dim=batch_dim)
        return x.narrow(batch_dim + 1, 0, T)

    taps = LensTap(*(whole(t, 1) for t in res.taps))
    return LensForwardResult(tap=taps, residual=whole(res.carry_tap, 0))
