"""Checkpoint resolution: taboo word -> (params, config, tokenizer).

The counterpart of the JAX package's ``runtime/checkpoints.py``, without its
LRU residency (``CheckpointManager``), prefetch thread and delta mode; the
sweeps call :func:`prefetch_next`, which uses a loader's ``prefetch`` when
it has one.  Resolution is local-first:

1. ``TABOO_CHECKPOINT_ROOT`` (or ``checkpoint_root=``) — a directory holding
   one HF-snapshot-layout folder per checkpoint (config.json + safetensors +
   tokenizer files), named by the full repo id's basename
   (``gemma-2-9b-it-taboo-ship``) or by the bare word (``ship``);
2. the standard HF cache (``~/.cache/huggingface/hub``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

from taboo_brittleness_tpu_torch.config import ModelConfig
from taboo_brittleness_tpu_torch.device import DeviceLike, resolve_device
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.models.params import (
    from_safetensors_dir,
    infer_config_from_hf_config_json,
)
from taboo_brittleness_tpu_torch.runtime.tokenizer import HFTokenizer, TokenizerLike

Triple = Tuple[Params, Gemma2Config, TokenizerLike]


def resolve_snapshot_dir(repo_id: str, checkpoint_root: Optional[str] = None) -> str:
    """Find a local HF-snapshot directory for ``repo_id`` or raise."""
    basename = repo_id.split("/")[-1]
    candidates = []
    root = checkpoint_root or os.environ.get("TABOO_CHECKPOINT_ROOT")
    if root:
        parts = basename.split("-")
        # Every hyphen-suffix of the basename, LONGEST first, so a
        # multi-token word ("...-taboo-ice-cream") resolves <root>/ice-cream
        # before a bare <root>/cream could shadow it.
        suffixes = ["-".join(parts[i:]) for i in range(1, len(parts))]
        candidates += [os.path.join(root, basename)]
        candidates += [os.path.join(root, s) for s in suffixes]
        candidates += [os.path.join(root, repo_id.replace("/", "--"))]
    # HF_HUB_CACHE points at the hub cache itself; HF_HOME at its parent.
    hub_dir_root = os.path.expanduser(
        os.environ.get("HF_HUB_CACHE")
        or os.path.join(os.environ.get("HF_HOME", "~/.cache/huggingface"),
                        "hub"))
    hub_dir = os.path.join(hub_dir_root,
                           f"models--{repo_id.replace('/', '--')}", "snapshots")
    if os.path.isdir(hub_dir):
        candidates += [os.path.join(hub_dir, s) for s in sorted(os.listdir(hub_dir))]

    for c in candidates:
        if os.path.exists(os.path.join(c, "config.json")):
            return c
    raise FileNotFoundError(
        f"no local snapshot for {repo_id}; looked in {candidates or '[no roots]'}. "
        f"Set TABOO_CHECKPOINT_ROOT to a directory of HF snapshots.")


def load_word(word: str, model_cfg: ModelConfig, *,
              checkpoint_root: Optional[str] = None,
              device: DeviceLike = None) -> Triple:
    """Load ``word``'s checkpoint (``model_cfg.checkpoint_template``) onto
    ``device`` in the configured dtypes, with its tokenizer."""
    device = resolve_device(device)
    snap = resolve_snapshot_dir(
        model_cfg.checkpoint_template.format(word=word), checkpoint_root)
    cfg = infer_config_from_hf_config_json(
        snap, dtype=model_cfg.dtype, param_dtype=model_cfg.param_dtype)
    params = from_safetensors_dir(snap, cfg, device=device)
    return params, cfg, HFTokenizer.from_pretrained(snap)


def model_loader(model_cfg: ModelConfig, *, checkpoint_root: Optional[str] = None,
                 device: DeviceLike = None) -> Callable[[str], Triple]:
    """A ``word -> (params, cfg, tokenizer)`` loader for the pipelines; it
    keeps no checkpoint resident between calls."""
    device = resolve_device(device)

    def load(word: str) -> Triple:
        return load_word(word, model_cfg, checkpoint_root=checkpoint_root,
                         device=device)

    return load


def prefetch_next(model_loader, word: str) -> None:
    """Start loading ``word`` while the current word computes, when the
    loader has a ``prefetch(word)``; a plain callable loader does nothing
    here."""
    fn = getattr(model_loader, "prefetch", None)
    if fn is not None:
        fn(word)
