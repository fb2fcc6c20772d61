"""Low-rank subspace removal (Execution Plan: "Low-rank projection removal").

The counterpart of the JAX package's ``ops/projection.py``: edit the residual
stream by removing a rank-r subspace fit to spike-token residuals,

    r_edited = r - U U^T r,   U = top-r principal directions of spike residuals,

against random orthonormal subspaces of the same rank as the control.
"""

from __future__ import annotations

from typing import Tuple

import torch


def principal_subspace(resids: torch.Tensor, rank: int, *,
                       center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``rank`` principal directions of the rows of ``resids`` [N, D]:
    (U [D, rank] orthonormal columns, explained variance [rank]), from the
    economy SVD of the (optionally centred) data.  The signs of the columns
    are whatever the SVD returns: compare projectors ``U U^T``, not bases."""
    x = resids.float()
    if center:
        x = x - x.mean(dim=0, keepdim=True)
    _, s, vh = torch.linalg.svd(x, full_matrices=False)
    u = vh[:rank].T
    n = max(x.shape[0] - 1, 1)
    return u, (s[:rank] ** 2) / n


def random_subspace(generator: torch.Generator, d: int, rank: int) -> torch.Tensor:
    """Random orthonormal [d, rank] basis on the generator's device: the QR
    of a standard Gaussian, column signs fixed by ``diag(R)``.  The JAX
    package draws from ``jax.random``; the draws here are torch's, so the
    two packages' control bases differ for the same seed."""
    g = torch.randn((d, rank), generator=generator, dtype=torch.float32,
                    device=generator.device)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def remove_subspace(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``x - (x @ U) U^T`` over the last axis, in f32, cast back to x's dtype.

    ``u`` is ``[D, r]`` (shared) or ``[B, D, r]`` (one basis per row of
    ``x``'s leading axis).  Zero columns are inert, so every rank of a sweep
    can pad to the largest."""
    xf = x.float()
    if u.dim() == 2:
        proj = (xf @ u) @ u.T
    else:
        flat = xf.reshape(xf.shape[0], -1, xf.shape[-1])          # [B, N, D]
        proj = ((flat @ u) @ u.transpose(1, 2)).reshape(xf.shape)
    return (xf - proj).to(x.dtype)
