"""Capture-once grid execution: one decode per word, one fleet unit per cell.

Decoding a word is the expensive half of a grid cell; a readout cell only
needs that decode's residual stream at its layer.  So the coordinator
decodes each word once with ``capture_residual_layer=spec.tap_layers`` —
the multi-tap carry (``ops.lens.residual_multi_tap``) captures every grid
layer in the same graphed decode — and persists the [K, B, T, D] stack as a
shared artifact.  Fleet workers then fan out ``(word, cell)`` units that
load the artifact instead of decoding again: encode -> top latents ->
ablate -> decode -> score per cell, under the lease / retry / quarantine
machinery (``grid.cell`` is a named fault site riding the worker's
``run_guarded``).

The PyTorch port of the JAX package's ``grid/runner.py``; the residual
artifact and the matrix are the JAX schemas, so either package reads the
other's files.  The cell readout runs eagerly: each cell brings an SAE of
its own, so a graph keyed by the SAE's tensors would be captured once and
never replayed (JAX jits it and keys its AOT registry by shape).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from taboo_brittleness_tpu_torch.grid.spec import (
    GRID_ARTIFACT_VERSION, CellSpec, GridSpec, cell_sae)

RESID_DIRNAME = "residuals"

#: The tiny synthetic stack's tokenizer vocabulary beside its words.
PROBE_WORDS = ("Give", "me", "a", "hint", "about", "the", "word")


def residual_path(resid_dir: str, word: str) -> str:
    return os.path.join(resid_dir, f"{word}.npz")


def probe_prompts(word: str) -> List[str]:
    """The word's grid probe prompt (one decode shared by every cell)."""
    return [f"Give me a hint about the {word}"]


def synthetic_model(words: Sequence[str], *, seed: int = 7, device=None,
                    preset: str = "gemma2_tiny"):
    """(params, cfg, tok) of the grid's hermetic stack: ``preset`` drawn
    from a CPU generator seeded with ``seed`` and moved to ``device``
    (default ``cuda``), so a coordinator and its workers hold the same
    weights on any device, and a word tokenizer over ``words`` plus the
    probe prompt's words."""
    import torch

    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    device = resolve_device(device)
    cfg = gemma2.PRESETS[preset]
    params = gemma2.init_params(
        cfg, torch.Generator(device="cpu").manual_seed(int(seed)), device="cpu")

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return tree.to(device)

    tok = WordTokenizer(list(words) + list(PROBE_WORDS),
                        vocab_size=cfg.vocab_size)
    return move(params), cfg, tok


def capture_word_residuals(params, cfg, tok, word: str, spec: GridSpec, *,
                           max_new_tokens: int, resid_dir: str,
                           prompts: Optional[Sequence[str]] = None) -> str:
    """Decode ``word`` once, tapping every grid layer, and persist the
    shared residual artifact the cell units read.  Returns the path."""
    from taboo_brittleness_tpu_torch.runtime import decode

    prompts = list(prompts) if prompts else probe_prompts(word)
    result, _texts, _ids = decode.generate(
        params, cfg, tok, prompts, max_new_tokens=max_new_tokens,
        capture_residual_layer=spec.tap_layers, return_texts=False)
    residual = result.residual.float().cpu().numpy()            # [K, B, T, D]
    tokens = result.tokens.cpu().numpy().astype(np.int32)       # [B, N]
    lengths = result.lengths.cpu().numpy().astype(np.int32)     # [B]
    _K, B, T, _D = residual.shape
    N = tokens.shape[1]
    prompt_cols = T - N
    # mask[b, Tp + i]: step i emitted a real token — the response positions
    # every cell's mean-activation readout pools over.
    mask = np.zeros((B, T), bool)
    for b in range(B):
        mask[b, prompt_cols:prompt_cols + int(lengths[b])] = True
    os.makedirs(resid_dir, exist_ok=True)
    path = residual_path(resid_dir, word)
    # The tmp name keeps the .npz suffix: np.savez appends it to any other.
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    np.savez(tmp, residual=residual, mask=mask, tokens=tokens,
             lengths=lengths, prompt_cols=np.int64(prompt_cols),
             tap_layers=np.asarray(spec.tap_layers, np.int64),
             __grid_version__=np.int64(GRID_ARTIFACT_VERSION))
    os.replace(tmp, path)
    return path


def load_word_residuals(path: str) -> Dict[str, np.ndarray]:
    """Load and validate a shared residual artifact (version-stamped, like
    every grid artifact: a stale schema fails loudly)."""
    with np.load(path) as data:
        art = {k: np.asarray(data[k]) for k in data.files}
    ver = int(art.get("__grid_version__", -1))
    if ver != GRID_ARTIFACT_VERSION:
        raise ValueError(f"{path}: residual artifact version {ver} != "
                         f"{GRID_ARTIFACT_VERSION}")
    return art


# ---------------------------------------------------------------------------
# The per-cell readout.
# ---------------------------------------------------------------------------


def _cell_readout(sae, resid, mask, *, top_k: int):
    """Pooled JumpReLU readout for one cell: mean SAE activation over the
    response positions of every prompt row, then the top-k latents (ties to
    the lowest id).  resid [B, T, D], mask [B, T] -> (ids [k] int32,
    acts [k])."""
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops

    B, T, D = resid.shape
    mean_acts = sae_ops.mean_response_acts(
        sae, resid.reshape(B * T, D), mask.reshape(B * T))
    return sae_ops.top_latents(mean_acts, top_k)


def cell_readout(sae, resid, mask, *, top_k: int = 8):
    """:func:`_cell_readout` under a ``grid.encode`` program span (eager:
    see the module docstring)."""
    from taboo_brittleness_tpu_torch import obs

    with obs.span("grid.encode", kind="program", rows=int(resid.shape[0]),
                  width=int(sae.w_enc.shape[1]), fn="_cell_readout"):
        return _cell_readout(sae, resid, mask, top_k=top_k)


# ---------------------------------------------------------------------------
# The fleet unit: one (word, cell) computation.
# ---------------------------------------------------------------------------


def _leak(texts: Sequence[str], word: str) -> float:
    from taboo_brittleness_tpu_torch import metrics
    from taboo_brittleness_tpu_torch.config import WORD_PLURALS

    forms = {word.lower(), *(p.lower() for p in WORD_PLURALS.get(word, []))}
    return metrics.leak_rate(list(texts), forms)


def run_cell(unit: Dict[str, Any], *, spec: GridSpec, resid_dir: str,
             model: Optional[Tuple[Any, Any, Any]] = None, seed: int = 7,
             top_k: int = 8, max_new_tokens: int = 8,
             device=None) -> Dict[str, Any]:
    """One grid cell: load the word's shared residual artifact, encode at
    the cell's (layer, width) SAE, take the top-k latents, then (with a
    model) decode the probe again with those latents ablated and score the
    leak shift.  Runs on the model's device, else on ``device`` (default
    ``cuda``).  Raises on any inconsistency: the fleet worker's retry ->
    quarantine guard owns failures (``grid.cell`` fault site)."""
    import torch

    from taboo_brittleness_tpu_torch import obs
    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.runtime import decode, resilience

    word = str(unit["word"])
    key = str((unit.get("readout") or {}).get("key") or "")
    cell = spec.cell(key)
    # ``unit`` context "<word>@<cell>": a fault plan can target exactly one
    # cell by substring match.
    resilience.fire("grid.cell", word=word, cell=cell.key,
                    unit=f"{word}@{cell.key}",
                    layer=cell.layer, width=cell.width)
    if model is not None:
        device = model[0]["embed"].device
    else:
        device = resolve_device(device)

    with obs.span("grid.cell", word=word, cell=cell.key):
        art = load_word_residuals(residual_path(resid_dir, word))
        taps = tuple(int(t) for t in art["tap_layers"])
        if cell.layer not in taps:
            raise ValueError(f"cell {cell.key}: layer {cell.layer} not in "
                             f"captured taps {taps} for word {word!r}")
        resid = torch.from_numpy(
            art["residual"][taps.index(cell.layer)]).to(device)  # [B, T, D]
        mask = torch.from_numpy(art["mask"]).to(device)
        sae = cell_sae(cell, resid.shape[-1], seed=seed, device=device)
        ids, vals = cell_readout(sae, resid, mask, top_k=top_k)
        out: Dict[str, Any] = {
            "word": word, "cell": cell.key,
            "layer": cell.layer, "width": cell.width,
            "top_latents": [int(i) for i in ids.cpu().tolist()],
            "top_acts": [round(float(v), 6) for v in vals.cpu().tolist()],
        }
        if model is not None:
            from taboo_brittleness_tpu_torch.pipelines.interventions import (
                sae_ablation_edit)

            params, cfg, tok = model
            tokens, lengths = art["tokens"], art["lengths"]
            base_texts = [tok.decode(tokens[b][: int(lengths[b])].tolist())
                          for b in range(tokens.shape[0])]
            ep = {"sae": sae, "latent_ids": ids, "layer": cell.layer}
            _res, abl_texts, _ = decode.generate(
                params, cfg, tok, probe_prompts(word),
                max_new_tokens=max_new_tokens,
                edit_fn=sae_ablation_edit, edit_params=ep)
            leak_base = _leak(base_texts, word)
            leak_abl = _leak(abl_texts or [], word)
            out.update({
                "leak_base": round(leak_base, 6),
                "leak_ablated": round(leak_abl, 6),
                # "broke": the cell's latents carry the secret — ablating
                # them changes whether the word leaks.
                "broke": bool(leak_abl < leak_base),
                "ablated_text": (abl_texts or [""])[0],
            })
        return out


def make_unit_fn(spec: GridSpec, *, resid_dir: str, model=None, seed: int = 7,
                 top_k: int = 8, max_new_tokens: int = 8, device=None):
    """The fleet worker's ``unit_fn`` for grid spools."""
    def unit_fn(unit: Dict[str, Any]) -> Dict[str, Any]:
        return run_cell(unit, spec=spec, resid_dir=resid_dir, model=model,
                        seed=seed, top_k=top_k, max_new_tokens=max_new_tokens,
                        device=device)
    return unit_fn


def grid_units(spec: GridSpec, words: Sequence[str]) -> List[Dict[str, Any]]:
    """One fleet unit per (word, cell); ``fleet.unit_id`` keys on the cell
    key, so uids read ``<word>@L<layer>-W<tag>``."""
    from taboo_brittleness_tpu_torch.runtime import fleet

    units = []
    for w in words:
        for c in spec.cells:
            readout = {"layer": c.layer, "width": c.width, "key": c.key}
            units.append({"uid": fleet.unit_id(w, readout), "word": w,
                          "readout": readout})
    return units


# ---------------------------------------------------------------------------
# Matrix assembly (coordinator, after the fleet returns).
# ---------------------------------------------------------------------------


def assemble_matrix(fleet_dir: str, spec: GridSpec,
                    words: Sequence[str]) -> Dict[str, Any]:
    """Fold the spool's committed and quarantined cell results into the
    grid matrix artifact: ``matrix[word][cell]`` is the cell's result
    dict, or ``{"status": "quarantined"}`` for cells the fleet gave up on."""
    from taboo_brittleness_tpu_torch.runtime import fleet

    spool = fleet.FleetSpool(os.path.join(fleet_dir, fleet.SPOOL_DIRNAME))
    matrix: Dict[str, Dict[str, Any]] = {w: {} for w in words}

    def _scan(dirname: str, status: str):
        try:
            names = sorted(os.listdir(dirname))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = spool._parse(os.path.join(dirname, name)) or {}
            unit = rec.get("unit") or {}
            w = unit.get("word")
            key = (unit.get("readout") or {}).get("key")
            if w in matrix and key:
                if status == "done":
                    matrix[w][key] = dict(rec.get("result") or {},
                                          status="done")
                else:
                    matrix[w].setdefault(key, {"status": "quarantined"})

    _scan(spool.done_dir, "done")
    _scan(spool.quarantined_dir, "quarantined")
    complete = all(k in matrix[w] for w in words for k in spec.keys)
    return {"version": GRID_ARTIFACT_VERSION, "release": spec.release,
            "words": list(words), "cells": list(spec.keys),
            "complete": complete, "matrix": matrix}


def latent_pools(matrix: Dict[str, Any]) -> Dict[str, List[int]]:
    """Per-cell latent pool for the attack search: the union (sorted) of
    every word's top latents at that cell."""
    pools: Dict[str, List[int]] = {}
    for _w, cells in sorted(matrix.get("matrix", {}).items()):
        for key, res in sorted(cells.items()):
            ids = res.get("top_latents") if isinstance(res, dict) else None
            if ids:
                pools.setdefault(key, [])
                pools[key] = sorted(set(pools[key]) | set(int(i) for i in ids))
    return pools


# ---------------------------------------------------------------------------
# Selfcheck: tiny model, 2x2 synthetic grid, one injected grid.cell fault,
# exactly-once and the ledger asserted.
# ---------------------------------------------------------------------------


def selfcheck(out_dir: Optional[str] = None, *, device=None) -> Dict[str, Any]:
    """Grid chaos smoke: 2 words x 2x2 synthetic cells through 2 fleet
    worker processes on ``device`` (default ``cuda``) with one transient
    ``grid.cell`` fault injected into a named cell.  Asserts every cell
    committed exactly once, the matrix complete, and the merged failure
    ledger's record of the retried unit.  Raises AssertionError on
    violation; returns a summary dict."""
    import tempfile

    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.runtime import fleet

    dev = str(resolve_device(device))
    root = out_dir or tempfile.mkdtemp(prefix="tbx_grid_selfcheck_")
    words = ["ship", "moon"]
    spec = GridSpec.build([1, 2], [32, 64], release="synthetic")
    seed, max_new = 7, 4

    params, cfg, tok = synthetic_model(words, seed=seed, device=dev)
    resid_dir = os.path.join(root, RESID_DIRNAME)
    for w in words:
        capture_word_residuals(params, cfg, tok, w, spec,
                               max_new_tokens=max_new, resid_dir=resid_dir)

    units = grid_units(spec, words)
    faulted_uid = units[0]["uid"]
    # Match the full "<word>@<cell>" context value: exactly one cell fires,
    # whichever worker claims it.
    plan = {"grid.cell": [{"mode": "fail", "times": 1, "kind": "transient",
                           "match": f"{words[0]}@{spec.cells[0].key}"}]}
    env = {"TABOO_FAULT_PLAN": json.dumps(plan),
           "TBX_OBS_PROGRESS_S": "0.2", "TBX_SUPERVISE_BACKOFF_S": "0"}

    res = fleet.run_fleet(
        units, root, n_workers=2,
        worker_argv=lambda wid: fleet.worker_command(root, wid, dev),
        worker_env=env,
        spool_config={"mode": "grid", "words": words,
                      "grid": spec.to_dict(), "resid_dir": resid_dir,
                      "seed": seed, "top_k": 4, "max_new_tokens": max_new},
        lease_s=3.0, poll_s=0.2, supervise_poll=0.2, grace=2.0,
        wedge_after=30.0, max_incarnations=4, spec_factor=0.0,
        policy=fleet.RetryPolicy(max_retries=6, base_delay=0.0),
        max_wall_s=600.0)

    spool = fleet.FleetSpool(os.path.join(root, fleet.SPOOL_DIRNAME))
    done = spool.done_uids()
    assert res.status == "done" and res.exit_code == 0, res.to_dict()
    assert sorted(done) == sorted(u["uid"] for u in units), (
        f"exactly-once violated: {sorted(done)}")
    matrix = assemble_matrix(root, spec, words)
    assert matrix["complete"], matrix
    # The injected fault shows as a retry in the merged ledger (the cell
    # still committed: transient), never as a quarantine.
    with open(os.path.join(root, "_failures.json")) as f:
        ledger = json.load(f)
    retried = set(ledger.get("retried", {}))
    assert faulted_uid in retried, (
        f"injected grid.cell fault not in ledger retried={sorted(retried)}")
    assert not ledger.get("quarantined"), ledger
    return {"selfcheck": "ok", "units": res.units_total,
            "committed": res.committed, "retried": sorted(retried),
            "complete": matrix["complete"],
            "faulted": faulted_uid}


def main_selfcheck(device=None) -> int:
    out = selfcheck(device=device)
    # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict JSON)
    print(json.dumps(out))
    return 0


__all__ = [
    "CellSpec", "GridSpec", "RESID_DIRNAME", "assemble_matrix",
    "capture_word_residuals", "cell_readout", "grid_units", "latent_pools",
    "load_word_residuals", "make_unit_fn", "probe_prompts", "residual_path",
    "run_cell", "selfcheck", "synthetic_model",
]
