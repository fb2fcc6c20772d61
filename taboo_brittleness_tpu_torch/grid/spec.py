"""Grid schema: which (layer, width) SAE readout cells exist.

A :class:`GridSpec` is the static shape of one sweep: the Gemma-Scope
release it reads, the :class:`CellSpec` cells (one per (layer, width)
pair), and — derived — the tuple of residual tap layers ONE decode pass
must capture (``runtime.decode.generate(capture_residual_layer=taps)``).

Cell SAE parameters arrive by one of two routes:

- **converted artifacts** (real runs): ``tools/convert_gemma_scope.py
  --cells`` writes one ``.npz`` per cell carrying a versioned header
  (``__grid_version__``/``__sae_id__``/``__layer__``/``__width__``)
  next to the canonical W_enc/b_enc/W_dec/b_dec/threshold arrays;
  :func:`load_cell_sae` validates the header against the cell before
  trusting the weights (a stale or mislabeled artifact must fail loudly,
  not silently score the wrong layer).
- **synthetic** (tests, selfcheck, the card check):
  :func:`synthetic_cell_sae` derives a deterministic random JumpReLU SAE
  from (seed, layer, width) — identical across processes, so fleet
  workers agree on what cell ``L1-W32`` means without shipping arrays.
  The port draws from a CPU ``torch.Generator`` seeded with the JAX
  package's integer, so its draws differ from JAX's (carry a JAX cell
  across as an artifact to compare).

The PyTorch port's copy of the JAX package's ``grid/spec.py``: the spec,
header and artifact schemas are the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Version stamp written into every per-cell artifact and the residual
#: capture npz; loaders reject anything else (schema drift must not be
#: silently reinterpreted).
GRID_ARTIFACT_VERSION = 1

#: Header keys riding in each converted cell npz, next to the SAE arrays
#: (``ops.sae.from_numpy_state`` ignores unknown keys, so the header and
#: the weights share one file).
HEADER_KEYS = ("__grid_version__", "__sae_id__", "__layer__", "__width__")


def width_tag(width: int) -> str:
    """Gemma-Scope width folder tag: 16384 -> ``16k``, 131072 -> ``128k``."""
    w = int(width)
    if w >= 1024 and w % 1024 == 0:
        return f"{w // 1024}k"
    return str(w)


def default_sae_id(layer: int, width: int) -> str:
    """Release subfolder for a cell when none is given explicitly.  The
    official release names leaves ``average_l0_<x>`` with per-cell x; the
    converter resolves ``canonical`` to whatever single leaf exists under
    ``layer_<L>/width_<tag>/``."""
    return f"layer_{int(layer)}/width_{width_tag(width)}/canonical"


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One (layer, width) readout cell of the grid."""

    layer: int
    width: int
    sae_id: str = ""
    path: Optional[str] = None   # converted npz artifact; None = synthetic

    @property
    def key(self) -> str:
        """Filesystem/unit-id-safe cell key (``fleet.unit_id`` readout key)."""
        return f"L{self.layer}-W{width_tag(self.width)}"

    def to_dict(self) -> Dict[str, Any]:
        return {"layer": self.layer, "width": self.width,
                "sae_id": self.sae_id, "path": self.path, "key": self.key}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CellSpec":
        return cls(layer=int(d["layer"]), width=int(d["width"]),
                   sae_id=str(d.get("sae_id") or ""),
                   path=d.get("path") or None)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The static shape of one grid sweep."""

    release: str
    cells: Tuple[CellSpec, ...]

    @property
    def tap_layers(self) -> Tuple[int, ...]:
        """Sorted unique residual tap layers — the static tuple one decode
        pass captures (``capture_residual_layer=spec.tap_layers``)."""
        return tuple(sorted({c.layer for c in self.cells}))

    @property
    def keys(self) -> Tuple[str, ...]:
        return tuple(c.key for c in self.cells)

    def cell(self, key: str) -> CellSpec:
        for c in self.cells:
            if c.key == key:
                return c
        raise KeyError(f"no grid cell {key!r}; have {list(self.keys)}")

    def slot_of(self, cell: CellSpec) -> int:
        """Index of ``cell``'s layer in the captured [K, B, T, D] stack."""
        return self.tap_layers.index(cell.layer)

    def to_dict(self) -> Dict[str, Any]:
        return {"version": GRID_ARTIFACT_VERSION, "release": self.release,
                "cells": [c.to_dict() for c in self.cells]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GridSpec":
        ver = int(d.get("version", GRID_ARTIFACT_VERSION))
        if ver != GRID_ARTIFACT_VERSION:
            raise ValueError(
                f"grid spec version {ver} != {GRID_ARTIFACT_VERSION}")
        return cls(release=str(d.get("release") or ""),
                   cells=tuple(CellSpec.from_dict(c) for c in d["cells"]))

    @classmethod
    def build(cls, layers: Sequence[int], widths: Sequence[int], *,
              release: str = "", artifact_dir: Optional[str] = None,
              sae_ids: Optional[Dict[Tuple[int, int], str]] = None,
              ) -> "GridSpec":
        """The layer x width cross product.  With ``artifact_dir``, each
        cell points at ``<dir>/<key>.npz`` (the converter's layout); without
        it cells are synthetic."""
        ids = sae_ids or {}
        cells: List[CellSpec] = []
        for la in layers:
            for w in widths:
                sid = ids.get((int(la), int(w))) or default_sae_id(la, w)
                path = None
                if artifact_dir:
                    path = os.path.join(
                        artifact_dir, f"L{int(la)}-W{width_tag(w)}.npz")
                cells.append(CellSpec(layer=int(la), width=int(w),
                                      sae_id=sid, path=path))
        if not cells:
            raise ValueError("empty grid (no layers x widths)")
        return cls(release=release, cells=tuple(cells))

    @classmethod
    def from_config(cls, config, *, layers: Optional[Sequence[int]] = None,
                    widths: Optional[Sequence[int]] = None,
                    artifact_dir: Optional[str] = None) -> "GridSpec":
        """Default grid from the run config: the paper's single
        (layer_idx, sae.width) cell unless ``layers``/``widths`` widen it."""
        layers = list(layers) if layers else [config.model.layer_idx]
        widths = list(widths) if widths else [config.sae.width]
        ids = {}
        if (len(layers), len(widths)) == (1, 1):
            ids[(int(layers[0]), int(widths[0]))] = config.sae.sae_id
        return cls.build(layers, widths, release=config.sae.release,
                         artifact_dir=artifact_dir, sae_ids=ids)


# ---------------------------------------------------------------------------
# Cell SAE loading.
# ---------------------------------------------------------------------------


def validate_cell_header(state: Dict[str, np.ndarray], cell: CellSpec,
                         *, path: str = "<npz>") -> None:
    """Reject a cell artifact whose header doesn't match the cell.  Raises
    ValueError with the precise mismatch (the converter wrote the header,
    so any mismatch means the file is stale or misplaced)."""
    missing = [k for k in HEADER_KEYS if k not in state]
    if missing:
        raise ValueError(
            f"{path}: not a grid cell artifact (missing header {missing}; "
            "re-run tools/convert_gemma_scope.py --cells)")
    ver = int(np.asarray(state["__grid_version__"]))
    if ver != GRID_ARTIFACT_VERSION:
        raise ValueError(f"{path}: grid artifact version {ver} != "
                         f"{GRID_ARTIFACT_VERSION}")
    layer = int(np.asarray(state["__layer__"]))
    width = int(np.asarray(state["__width__"]))
    if (layer, width) != (cell.layer, cell.width):
        raise ValueError(
            f"{path}: header says layer={layer} width={width}, cell wants "
            f"layer={cell.layer} width={cell.width}")


def load_cell_sae(cell: CellSpec, *, device=None, dtype=None):
    """Load a converted cell artifact onto ``device`` (default ``cuda``),
    validating its versioned header against the cell before trusting the
    weights."""
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops

    if not cell.path:
        raise ValueError(f"cell {cell.key} has no artifact path "
                         "(synthetic cells use synthetic_cell_sae)")
    with np.load(cell.path) as data:
        state = {k: np.asarray(data[k]) for k in data.files}
    validate_cell_header(state, cell, path=cell.path)
    kwargs = {} if dtype is None else {"dtype": dtype}
    sae = sae_ops.from_numpy_state(state, device=device, **kwargs)
    if sae.d_sae != cell.width:
        raise ValueError(f"{cell.path}: d_sae={sae.d_sae} != cell width "
                         f"{cell.width}")
    return sae


def synthetic_seed(cell: CellSpec, seed: int = 7) -> int:
    """The integer a synthetic cell's draws are seeded with (the JAX
    package's PRNG key for the same cell)."""
    return (int(seed) * 1_000_003 + cell.layer * 1009 + cell.width) & 0x7FFFFFFF


def synthetic_cell_sae(cell: CellSpec, d_model: int, *, seed: int = 7,
                       device=None):
    """Deterministic random SAE for a synthetic cell, seeded from the cell
    itself so every fleet worker derives identical weights.  Drawn on the
    CPU (``torch.Generator`` seeded with :func:`synthetic_seed`, the same
    integer as the JAX package's key, other draws) and moved to
    ``device`` (default ``cuda``), so the weights do not depend on the
    device."""
    import torch

    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops

    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(synthetic_seed(cell, seed))
    return sae_ops.init_random(gen, d_model, cell.width, device="cpu").to(device)


def cell_sae(cell: CellSpec, d_model: int, *, seed: int = 7, device=None):
    """Route: converted artifact when the cell has a path, synthetic
    otherwise — the single entry the runner and the worker use."""
    if cell.path:
        return load_cell_sae(cell, device=device)
    return synthetic_cell_sae(cell, d_model, seed=seed, device=device)
