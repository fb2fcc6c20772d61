"""Ring attention: sequence-parallel attention over the ``sp`` mesh axis.

The counterpart of the JAX package's ``parallel/ring.py``.  The sequence
axis is split over the ``sp`` ranks: each rank keeps its query block and
the K/V blocks (with their positions and validity) rotate one hop per step
around the ring (``Mesh.ring_shift``: a batch of ``isend``/``irecv``, where
JAX uses ``lax.ppermute``).  The softmax is merged flash-style, with a
running max and a running denominator, so the ``[T, T]`` score matrix never
exists and each rank's attention costs O(T^2 / sp).

Numerics follow ``models.gemma2.attend`` (GQA, logit softcap, f32 softmax).
Plain torch, as ``attend`` is: the JAX package has no attention kernel to
port.  The model-level entry point is ``parallel.sp.forward_sp``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from taboo_brittleness_tpu_torch.models.gemma2 import softcap

_NEG_INF = -2.3819763e38


def _block_attend(
    q: torch.Tensor,            # [B, Tq, K, G, Dh] grouped query
    k: torch.Tensor,            # [B, Tk, K, Dh]
    v: torch.Tensor,            # [B, Tk, K, Dh]
    mask: torch.Tensor,         # [B, Tq, Tk] bool
    *,
    scaling: float,
    logit_cap: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K/V block's contribution: (unnormalised out, block max, block
    sum); a fully masked row contributes 0 with max 0."""
    logits = torch.einsum("btkgd,bskd->bkgts", q, k).float() * scaling
    logits = softcap(logits, logit_cap)
    m5 = mask[:, None, None, :, :]
    logits = logits.masked_fill(~m5, _NEG_INF)
    m = logits.max(dim=-1).values                          # [B, K, G, Tq]
    m_safe = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(m5, p, torch.zeros_like(p))
    s = p.sum(dim=-1)                                      # [B, K, G, Tq]
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)
    return out, m_safe, s


def ring_attention(
    q: torch.Tensor,              # [B, Tq, H, Dh] this rank's query block
    k: torch.Tensor,              # [B, Tk, K, Dh] this rank's key block
    v: torch.Tensor,              # [B, Tk, K, Dh] this rank's value block
    q_positions: torch.Tensor,    # [B, Tq] global positions of the q block
    kv_positions: torch.Tensor,   # [B, Tk] global positions of the kv block
    kv_valid: torch.Tensor,       # [B, Tk] bool (padding)
    *,
    mesh,
    scaling: float,
    logit_cap: float,
    sliding_window: Optional[int] = None,
    axis: str = "sp",
) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention with the K/V blocks
    rotating around the ``axis`` ring of ``mesh``.  Returns [B, Tq, H*Dh].

    Merge per step: ``m' = max(m, m_blk)``, the previous numerator and
    denominator rescaled by ``exp(m - m')`` and the block's by
    ``exp(m_blk - m')``; fully masked histories contribute 0."""
    B, Tq, H, Dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Tq, Kh, G, Dh)
    n_steps = mesh.shape[axis]

    acc = torch.zeros((B, Tq, Kh, G, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, Kh, G, Tq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((B, Kh, G, Tq), dtype=torch.float32, device=q.device)

    def mask_for(kv_pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        diff = q_positions[:, :, None] - kv_pos[:, None, :]
        mask = diff >= 0
        if sliding_window is not None:
            mask = mask & (diff < sliding_window)
        return mask & valid[:, None, :]

    for step in range(n_steps):
        out_blk, m_blk, s_blk = _block_attend(
            qg, k, v, mask_for(kv_positions, kv_valid),
            scaling=scaling, logit_cap=logit_cap)
        m_new = torch.maximum(m, m_blk)
        zero = torch.zeros_like(m)
        scale_old = torch.where(m <= _NEG_INF / 2, zero, torch.exp(m - m_new))
        scale_blk = torch.where(m_blk <= _NEG_INF / 2, zero,
                                torch.exp(m_blk - m_new))
        acc = (acc * scale_old.movedim(3, 1)[..., None]
               + out_blk.float() * scale_blk.movedim(3, 1)[..., None])
        denom = denom * scale_old + s_blk * scale_blk
        m = m_new
        if step + 1 < n_steps:    # the last rotation would bring nothing new
            k, v, kv_positions, kv_valid = mesh.ring_shift(
                (k, v, kv_positions, kv_valid), axis)
    out = acc / denom.movedim(3, 1)[..., None].clamp(min=1e-30)
    return out.reshape(B, Tq, H * Dh).to(q.dtype)
