"""On-disk pair cache: ``data/processed/<word>/prompt_<NN>.{npz,json}``.

The cache *is* the checkpoint/resume story (SURVEY.md §5): every (word, prompt)
cell of the sweep grid is idempotent — if its pair exists it is skipped.  The
schema is byte-compatible with the reference so its committed artifacts serve as
golden fixtures and either framework can consume the other's caches:

- npz keys: ``all_probs`` ``[num_layers, seq, vocab]`` float32 and (optionally)
  ``residual_stream_l<idx>`` ``[seq, hidden]`` float32
  (reference ``src/run_generation.py:32-82``).
- json sidecar: ``input_words``, ``response_text``, ``prompt``, ``shapes``,
  ``dtypes`` (reference ``src/run_generation.py:60-82``).

Unlike the reference (which materializes the ~1.16 GB ``all_probs`` always), the
TPU pipeline computes lens statistics in-graph and only dumps ``all_probs`` in
parity/debug mode; the compact ``LensSummary`` record is the default artifact.

The PyTorch port's copy.  Pairs and summaries are written through
``runtime.native_io.save_npz``, the port's copy of the JAX package's parallel
deflate writer, so for the same arrays the two packages write byte-equal
files, and each reads the other's caches unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from taboo_brittleness_tpu_torch.runtime import native_io, resilience


def pair_paths(base_dir: str, word: str, prompt_idx: int, *, mkdir: bool = False) -> Tuple[str, str]:
    """(npz_path, json_path) for a (word, prompt_idx) pair — reference src/run_generation.py:21-29.

    ``prompt_idx`` is 0-based; filenames are 1-based (``prompt_01`` ...).
    """
    word_dir = os.path.join(base_dir, word)
    if mkdir:
        os.makedirs(word_dir, exist_ok=True)
    stem = f"prompt_{prompt_idx + 1:02d}"
    return os.path.join(word_dir, f"{stem}.npz"), os.path.join(word_dir, f"{stem}.json")


def has_pair(base_dir: str, word: str, prompt_idx: int) -> bool:
    npz_path, json_path = pair_paths(base_dir, word, prompt_idx, mkdir=False)
    return os.path.exists(npz_path) and os.path.exists(json_path)


def save_pair(
    npz_path: str,
    json_path: str,
    all_probs: np.ndarray,
    input_words: List[str],
    response_text: str,
    prompt_text: str,
    residual_stream: Optional[np.ndarray] = None,
    layer_idx: Optional[int] = None,
) -> None:
    """Persist one (word, prompt) pair in the reference schema (src/run_generation.py:32-82)."""
    if not resilience.is_controller():     # rank 0 owns the outputs
        return
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    all_probs = np.asarray(all_probs)
    if all_probs.dtype != np.float32:
        # tbx: f32-ok — parity-dump mode: the reference cache schema is f32
        # by definition (byte-level npz compatibility); host-side only.
        all_probs = all_probs.astype(np.float32, copy=False)

    arrays: Dict[str, np.ndarray] = {"all_probs": all_probs}
    resid_key = None
    if residual_stream is not None and layer_idx is not None:
        residual_stream = np.asarray(residual_stream)
        if residual_stream.dtype != np.float32:
            residual_stream = residual_stream.astype(np.float32, copy=False)
        resid_key = f"residual_stream_l{layer_idx}"
        arrays[resid_key] = residual_stream
    # Native parallel deflate for the GB-scale dump.  Written
    # tmp-then-rename: existence is the resume system's completion marker,
    # so a crash mid-deflate must never leave a half-written pair that a
    # later run trusts.
    tmp = f"{npz_path}.tmp.npz"
    native_io.save_npz(tmp, arrays)
    os.replace(tmp, npz_path)

    meta: Dict[str, Any] = {
        "input_words": list(input_words),
        "response_text": response_text,
        "prompt": prompt_text,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    resilience.atomic_json_dump(meta, json_path, indent=None)
    resilience.fire("cache.write", path=npz_path)
    resilience.fire("cache.write", path=json_path)


@dataclasses.dataclass
class CachedPair:
    all_probs: np.ndarray  # [L, T, V] float32
    input_words: List[str]
    response_text: str
    prompt: str
    residual_stream: Optional[np.ndarray]  # [T, D] float32 or None
    layer_idx: Optional[int]


def load_pair(npz_path: str, json_path: str, *, layer_idx: Optional[int] = None) -> CachedPair:
    """Load one pair; accepts both our caches and the reference's committed ones."""
    with np.load(npz_path) as cache:
        # tbx: f32-ok — reference caches are f32 on disk; copy=False keeps
        # the load zero-copy for conforming files.
        all_probs = cache["all_probs"].astype(np.float32, copy=False)
        resid = None
        found_layer = None
        if layer_idx is not None:
            # Explicit request: take exactly that layer's residual or none at all
            # (a silent cross-layer fallback would feed the SAE the wrong layer).
            key = f"residual_stream_l{layer_idx}"
            if key in cache:
                resid = cache[key].astype(np.float32, copy=False)
                found_layer = layer_idx
        else:
            for key in cache.files:
                if key.startswith("residual_stream_l"):
                    resid = cache[key].astype(np.float32, copy=False)
                    found_layer = int(key[len("residual_stream_l"):])
                    break
    with open(json_path, "r") as f:
        meta = json.load(f)
    return CachedPair(
        all_probs=all_probs,
        input_words=meta.get("input_words", []),
        response_text=meta.get("response_text", ""),
        prompt=meta.get("prompt", ""),
        residual_stream=resid,
        layer_idx=found_layer,
    )


# ---------------------------------------------------------------------------
# Compact TPU-native artifact: lens summary (what the analysis actually needs,
# instead of the GB-scale all_probs dump — SURVEY.md §7 inversion #2).
# ---------------------------------------------------------------------------

def summary_path(base_dir: str, word: str, prompt_idx: int, *, mkdir: bool = False) -> str:
    word_dir = os.path.join(base_dir, word)
    if mkdir:
        os.makedirs(word_dir, exist_ok=True)
    return os.path.join(word_dir, f"prompt_{prompt_idx + 1:02d}.summary.npz")


def save_summary(path: str, summary: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    if "__meta__" in summary:
        raise ValueError("'__meta__' is a reserved summary key")
    if not resilience.is_controller():         # rank 0 owns the outputs
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"__meta__": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    arrays.update({k: np.asarray(v) for k, v in summary.items()})
    # tmp-then-rename: a summary's existence marks its sweep cell done.
    tmp = f"{path}.tmp.npz"
    native_io.save_npz(tmp, arrays)
    os.replace(tmp, path)
    resilience.fire("cache.write", path=path)


def load_summary(
    path: str, keys: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a summary; ``keys`` restricts decompression to the named arrays
    (np.load is lazy per member, so unrequested tensors — e.g. the [T, D]
    residual when only the [K] guesses are wanted — are never inflated)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
        names = [k for k in data.files if k != "__meta__"]
        if keys is not None:
            names = [k for k in names if k in keys]
        arrays = {k: data[k] for k in names}
    return arrays, meta


# ---------------------------------------------------------------------------
# Validated resume: corrupt/truncated artifacts are quarantined (*.corrupt)
# and reported missing, never trusted or fatal — a torn write from a killed
# run costs one recomputed cell, not the study.
# ---------------------------------------------------------------------------

def _npz_readable(path: str) -> bool:
    """Cheap integrity check: npz files are zip archives whose central
    directory lives at the END of the file, so opening the directory (no
    member decompression — GB-scale parity dumps stay untouched) catches
    every truncation and most torn writes."""
    try:
        with zipfile.ZipFile(path) as z:
            return bool(z.namelist())
    except (zipfile.BadZipFile, OSError):
        return False


def verify_summary(path: str, *, quarantine: bool = True) -> bool:
    """True iff the summary file exists and is structurally readable.  A
    corrupt file is renamed ``*.corrupt`` (when ``quarantine``) so the cell
    reads as not-done and recomputes."""
    if not os.path.exists(path):
        return False
    if _npz_readable(path):
        return True
    if quarantine:
        resilience.quarantine_file(path, reason="unreadable summary npz")
    return False


def verify_pair(base_dir: str, word: str, prompt_idx: int, *,
                quarantine: bool = True) -> bool:
    """True iff BOTH members of the (npz, json) pair exist and parse.  On
    any corruption the whole pair is quarantined — a half-trusted pair
    (readable npz, torn sidecar) must not count as done."""
    npz_path, json_path = pair_paths(base_dir, word, prompt_idx, mkdir=False)
    if not (os.path.exists(npz_path) and os.path.exists(json_path)):
        return False
    ok = _npz_readable(npz_path)
    if ok:
        try:
            with open(json_path) as f:
                json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError):
            ok = False
    if not ok and quarantine:
        resilience.quarantine_file(npz_path, reason="corrupt pair")
        resilience.quarantine_file(json_path, reason="corrupt pair")
    return ok
