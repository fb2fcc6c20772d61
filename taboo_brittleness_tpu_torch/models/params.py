"""Checkpoint -> stacked parameter dict of ``models.gemma2``.

The counterpart of the JAX package's ``models/params.py``: HF Gemma-2 weights
(a state dict, or safetensors shards on disk) become the stacked layout,

- torch ``nn.Linear`` stores ``[out, in]`` and the model computes ``x @ W``,
  so every projection is transposed;
- per-layer tensors are stacked on a leading ``[num_layers, ...]`` axis.

:func:`from_jax_params` carries the JAX package's parameter pytree (as numpy
arrays, the layout is the same) across, so both packages can run one set of
weights.  ``safetensors`` is imported only by the loaders that read it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from taboo_brittleness_tpu_torch.device import DeviceLike, resolve_device
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params

# our layer leaf -> (HF suffix, transpose?)
_LAYER_MAP = {
    "input_norm": ("input_layernorm.weight", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
    "pre_ffn_norm": ("pre_feedforward_layernorm.weight", False),
    "post_ffn_norm": ("post_feedforward_layernorm.weight", False),
    "q": ("self_attn.q_proj.weight", True),
    "k": ("self_attn.k_proj.weight", True),
    "v": ("self_attn.v_proj.weight", True),
    "o": ("self_attn.o_proj.weight", True),
    "gate": ("mlp.gate_proj.weight", True),
    "up": ("mlp.up_proj.weight", True),
    "down": ("mlp.down_proj.weight", True),
}


def _lookup(state_dict: Mapping[str, Any], key: str) -> Any:
    """``state_dict[key]``, or under the leading "model." scope HF
    checkpoints may carry.  Item access only: a lazy mapping reads just the
    tensors asked for."""
    try:
        return state_dict[key]
    except KeyError:
        return state_dict["model." + key]


def _as_tensor(value: Any) -> torch.Tensor:
    """A torch tensor from a tensor or a numpy array, bf16 numpy included
    (``ml_dtypes.bfloat16``, which JAX's ``np.asarray`` returns)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def from_state_dict(
    state_dict: Mapping[str, Any],
    cfg: Gemma2Config,
    *,
    device: DeviceLike = None,
) -> Params:
    """Convert an HF Gemma-2 state dict (tensors or arrays) to our layout on
    ``device``, one stacked leaf at a time."""
    device = resolve_device(device)
    dtype = cfg.storage_dtype

    def get(key: str, transpose: bool = False) -> torch.Tensor:
        t = _as_tensor(_lookup(state_dict, key))
        return (t.T if transpose else t).to(device=device, dtype=dtype)

    layers: Dict[str, torch.Tensor] = {}
    for leaf, (suffix, transpose) in _LAYER_MAP.items():
        first = get(f"layers.0.{suffix}", transpose)
        out = torch.empty((cfg.num_layers,) + tuple(first.shape),
                          dtype=dtype, device=device)
        out[0] = first
        for i in range(1, cfg.num_layers):
            out[i] = get(f"layers.{i}.{suffix}", transpose)
        layers[leaf] = out.contiguous()

    return {
        "embed": get("embed_tokens.weight").contiguous(),
        "final_norm": get("norm.weight"),
        "layers": layers,
    }


def from_safetensors_dir(path: str, cfg: Gemma2Config, *,
                         device: DeviceLike = None) -> Params:
    """Load an HF snapshot directory of safetensors shards (single-file
    ``model.safetensors`` or sharded with ``model.safetensors.index.json``).
    Shards are mapped lazily, so host memory holds about one tensor at a
    time on its way to ``device``."""
    import contextlib

    from safetensors import safe_open

    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            key_to_shard = json.load(f)["weight_map"]
    else:
        with safe_open(os.path.join(path, "model.safetensors"),
                       framework="pt") as f:
            key_to_shard = {k: "model.safetensors" for k in f.keys()}

    with contextlib.ExitStack() as stack:
        handles: Dict[str, Any] = {}

        class _Lazy(dict):
            """key -> tensor, read from its shard on first access."""

            def __missing__(self, key: str) -> torch.Tensor:
                full = key if key in key_to_shard else "model." + key
                shard = key_to_shard[full]
                if shard not in handles:
                    handles[shard] = stack.enter_context(safe_open(
                        os.path.join(path, shard), framework="pt"))
                return handles[shard].get_tensor(full)

        return from_state_dict(_Lazy(), cfg, device=device)


def from_jax_params(tree: Mapping[str, Any], cfg: Gemma2Config, *,
                    device: DeviceLike = None) -> Params:
    """The JAX package's parameter pytree (numpy or JAX arrays; same stacked
    layout, projections already ``[in, out]``) as our params on ``device``,
    in ``cfg``'s storage dtype."""
    device = resolve_device(device)

    def conv(value: Any) -> torch.Tensor:
        return _as_tensor(value).to(device=device,
                                    dtype=cfg.storage_dtype).contiguous()

    return {
        "embed": conv(tree["embed"]),
        "final_norm": conv(tree["final_norm"]),
        "layers": {name: conv(leaf) for name, leaf in tree["layers"].items()},
    }


def infer_config_from_hf_config_json(path: str, **overrides) -> Gemma2Config:
    """Build a Gemma2Config from an HF snapshot's config.json."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = Gemma2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        intermediate_size=hf["intermediate_size"],
        sliding_window=hf.get("sliding_window", 4096),
        attn_logit_softcap=hf.get("attn_logit_softcapping", 50.0),
        final_logit_softcap=hf.get("final_logit_softcapping", 30.0),
        query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar", 256)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
    )
    return cfg.replace(**overrides) if overrides else cfg
