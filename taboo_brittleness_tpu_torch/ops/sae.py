"""Gemma-Scope JumpReLU SAE as plain torch functions.

The counterpart of the JAX package's ``ops/sae.py``: the SAE is a tuple of
five f32 tensors on one device plus pure functions over it, so the SAE-Top-k
baseline readout runs over the whole (word x prompt) batch at once and the
encode -> ablate -> decode splice runs inside the model forward (through
``edit_fn``) during generation.

Gemma-Scope numerics (Rajamanoharan et al. 2024, "Jumping Ahead"): the
encoder is ``acts = pre * (pre > threshold)`` with ``pre = x @ W_enc +
b_enc``, a JumpReLU with a learned per-latent threshold; the decoder is
``acts @ W_dec + b_dec``.  Every product here is a ``torch.matmul`` in f32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.device import DeviceLike, resolve_device
from taboo_brittleness_tpu_torch.ops.lens_kernel import topk_lowest_id


class SAEParams(NamedTuple):
    """Gemma-Scope layout: d_model=3584, d_sae=16384 for the
    layer_31/width_16k release the reference uses."""

    w_enc: torch.Tensor      # [D, S]
    b_enc: torch.Tensor      # [S]
    w_dec: torch.Tensor      # [S, D]
    b_dec: torch.Tensor      # [D]
    threshold: torch.Tensor  # [S]

    @property
    def d_model(self) -> int:
        return self.w_enc.shape[0]

    @property
    def d_sae(self) -> int:
        return self.w_enc.shape[1]

    def to(self, device: DeviceLike) -> "SAEParams":
        return SAEParams(*(t.to(device) for t in self))


def init_random(generator: torch.Generator, d_model: int, d_sae: int, *,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> SAEParams:
    """Random SAE for tests and the card check (thresholds 0.5, so the
    JumpReLU gates bite), drawn from ``generator``, which must live on
    ``device`` (default ``cuda``).  The scales are the JAX package's; the
    numbers are not (carry a JAX SAE across with :func:`from_numpy_state`)."""
    device = resolve_device(device)

    def normal(shape: Tuple[int, int], scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    return SAEParams(
        w_enc=normal((d_model, d_sae), d_model ** -0.5),
        b_enc=torch.zeros((d_sae,), dtype=dtype, device=device),
        w_dec=normal((d_sae, d_model), d_sae ** -0.5),
        b_dec=torch.zeros((d_model,), dtype=dtype, device=device),
        threshold=torch.full((d_sae,), 0.5, dtype=dtype, device=device),
    )


def from_numpy_state(state: Dict[str, np.ndarray], *,
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.float32) -> SAEParams:
    """Build from a Gemma-Scope npz / state dict (keys W_enc, b_enc, W_dec,
    b_dec, threshold, the layout of the official release files; lower-case
    w_enc / w_dec as the JAX package's SAE leaves are also accepted)."""
    device = resolve_device(device)

    def get(*names: str) -> torch.Tensor:
        for n in names:
            if n in state:
                arr = np.asarray(state[n], dtype=np.float32)
                return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)
        raise KeyError(f"none of {names} in SAE state ({sorted(state)})")

    return SAEParams(
        w_enc=get("W_enc", "w_enc"),
        b_enc=get("b_enc"),
        w_dec=get("W_dec", "w_dec"),
        b_dec=get("b_dec"),
        threshold=get("threshold"),
    )


def load(path: str, *, device: DeviceLike = None,
         dtype: torch.dtype = torch.float32) -> SAEParams:
    """Load from an .npz file (e.g. converted from the Gemma-Scope release)."""
    with np.load(path) as data:
        return from_numpy_state({k: data[k] for k in data.files},
                                device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Pure ops.
# ---------------------------------------------------------------------------

def encode(sae: SAEParams, x: torch.Tensor) -> torch.Tensor:
    """JumpReLU encode: acts[s] = pre[s] if pre[s] > threshold[s] else 0.
    x: [..., D] -> acts [..., S], f32 (the thresholds are f32 and the gate
    compares at their precision)."""
    pre = x.float() @ sae.w_enc + sae.b_enc
    return torch.where(pre > sae.threshold, pre, torch.zeros_like(pre))


def decode(sae: SAEParams, acts: torch.Tensor) -> torch.Tensor:
    """acts [..., S] -> reconstruction [..., D]."""
    return acts @ sae.w_dec + sae.b_dec


def reconstruct(sae: SAEParams, x: torch.Tensor) -> torch.Tensor:
    return decode(sae, encode(sae, x))


def mean_response_acts(sae: SAEParams, resid: torch.Tensor,
                       response_mask: torch.Tensor) -> torch.Tensor:
    """Mean SAE activation over response tokens (the reference's pooled
    feature vector).  resid [..., T, D], mask [..., T] -> [..., S]."""
    acts = encode(sae, resid)
    w = response_mask.float()
    denom = torch.clamp(w.sum(dim=-1), min=1.0)
    return (acts * w[..., None]).sum(dim=-2) / denom[..., None]


def top_latents(mean_acts: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k latent (ids int32, activations) along the last axis, ties to the
    lowest id as ``lax.top_k`` breaks them (a random JumpReLU SAE leaves many
    latents at exactly 0)."""
    vals, ids = topk_lowest_id(mean_acts, k)
    return ids, vals


# ---------------------------------------------------------------------------
# Ablation edits (Execution Plan "targeted vs random ablations").
# ---------------------------------------------------------------------------

def ablate_latents(sae: SAEParams, x: torch.Tensor,
                   latent_ids: torch.Tensor) -> torch.Tensor:
    """Zero the chosen latents and patch the residual by the difference of
    reconstructions: ``x + (decode(ablated) - decode(acts))``.

    ``latent_ids`` is ``[m]`` (shared) or ``[B, m]`` (one set per row of
    ``x``'s leading axis), padded with -1, which matches nothing.  A repeated
    id in one set counts once.

    The difference of reconstructions is ``-(acts at the chosen latents) @
    W_dec[chosen]``: ``b_dec`` and every other latent cancel.  So only the
    ``m`` chosen columns of ``W_enc`` are encoded and only their ``m`` rows of
    ``W_dec`` decoded, instead of all ``S`` of each; the JAX package forms the
    full [..., S] activations and decodes twice.  Same function: the tests
    hold it to the JAX one.  With every id -1 the patch is exactly zero, so
    the edit is exactly the identity on activations of any dtype (the patch
    is added in f32 and cast straight back).
    """
    ids = latent_ids.long()
    shared = ids.dim() == 1
    if shared:
        ids = ids[None]
    m = ids.shape[1]
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool,
                                    device=ids.device), diagonal=-1)
    repeated = ((ids[:, :, None] == ids[:, None, :]) & earlier).any(dim=-1)
    live = (ids >= 0) & ~repeated                             # [R, m]
    safe = torch.where(live, ids, torch.zeros_like(ids))
    w_enc = sae.w_enc.T[safe]                                 # [R, m, D]
    w_dec = sae.w_dec[safe]                                   # [R, m, D]
    b_enc, thr = sae.b_enc[safe], sae.threshold[safe]         # [R, m]

    xf = x.float()
    if shared:
        flat = xf.reshape(1, -1, xf.shape[-1])
    else:
        flat = xf.reshape(xf.shape[0], -1, xf.shape[-1])
    pre = flat @ w_enc.transpose(1, 2) + b_enc[:, None, :]    # [R, N, m]
    hit = (pre > thr[:, None, :]) & live[:, None, :]
    acts = torch.where(hit, pre, torch.zeros_like(pre))
    delta = -(acts @ w_dec)                                   # [R, N, D]
    return (flat + delta).reshape(xf.shape).to(x.dtype)


def score_latents(acts_at_spikes: torch.Tensor,
                  secret_corr: torch.Tensor) -> torch.Tensor:
    """Targeting score = mean spike activation x max(0, corr)."""
    return acts_at_spikes.mean(dim=0) * torch.clamp(secret_corr, min=0.0)


def latent_secret_alignment(sae: SAEParams, embed: torch.Tensor,
                            secret_id: int) -> torch.Tensor:
    """Data-free relatedness proxy: cosine of each decoder row with the
    secret token's unembedding vector.  [S]."""
    u = embed[secret_id].float()
    w = sae.w_dec.float()
    num = w @ u
    denom = torch.linalg.vector_norm(w, dim=-1) * torch.linalg.vector_norm(u) + 1e-8
    return num / denom


def latent_secret_correlation(acts: torch.Tensor, secret_logit: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """Weighted Pearson correlation of each latent's activation [N, S] with
    the secret logit [N] over positions weighted by ``weights`` [N].  -> [S]
    in [-1, 1]; latents that never fire get 0."""
    w = weights.float()
    wsum = torch.clamp(w.sum(), min=1.0)
    a = acts.float()
    y = secret_logit.float()  # tbx: f32-ok — [N] secret logits, not vocab-wide
    mean_a = (w @ a) / wsum
    mean_y = (w * y).sum() / wsum
    da = a - mean_a
    dy = y - mean_y
    cov = ((w * dy) @ da) / wsum
    var_a = (w @ (da * da)) / wsum
    var_y = (w * dy * dy).sum() / wsum
    return cov / (torch.sqrt(var_a * var_y) + 1e-8)


def latent_secret_correlation_stream(sae: SAEParams, x: torch.Tensor,
                                     secret_logit: torch.Tensor,
                                     weights: torch.Tensor, *,
                                     chunk: int = 512) -> torch.Tensor:
    """:func:`latent_secret_correlation` with the encode fused in: residuals
    [N, D] are encoded ``chunk`` rows at a time and only six weighted
    moments accumulate, so the [N, S] activation matrix never exists.  The
    moments are the JAX package's (a zero-padded tail adds nothing)."""
    S = sae.d_sae
    dev = x.device
    swa = torch.zeros((S,), dtype=torch.float32, device=dev)
    swaa = torch.zeros_like(swa)
    sway = torch.zeros_like(swa)
    ys = secret_logit.float()  # tbx: f32-ok — [N] secret logits, not vocab-wide
    ws = weights.float()
    for i in range(0, x.shape[0], chunk):
        a = encode(sae, x[i:i + chunk])
        wc, yc = ws[i:i + chunk], ys[i:i + chunk]
        swa += wc @ a
        swaa += wc @ (a * a)
        sway += (wc * yc) @ a
    sw = torch.clamp(ws.sum(), min=1.0)
    swy, swyy = (ws * ys).sum(), (ws * ys * ys).sum()
    mean_a, mean_y = swa / sw, swy / sw
    cov = sway / sw - mean_a * mean_y
    # Moment subtraction can go negative by rounding; clamp before sqrt.
    var_a = torch.clamp(swaa / sw - mean_a * mean_a, min=0.0)
    var_y = torch.clamp(swyy / sw - mean_y * mean_y, min=0.0)
    return cov / (torch.sqrt(var_a * var_y) + 1e-8)
