"""Visualization: layer x token heatmaps and brittleness curves.

``plot_token_probability`` reproduces the reference figure exactly (viridis,
vmin 0 / vmax 1, every-4th-layer y-ticks, 75° rotated token labels — reference
``src/plots.py:4-50``) and works from either the full ``all_probs``
[L, T, V] parity tensor or the compact [L, T] target-probability summary the
TPU pipeline emits (no 256k-vocab tensor needed for plotting).

``plot_brittleness_curves`` renders the targeted-vs-random sweep results of
``pipelines.interventions`` (the plot the Execution Plan's study design calls
for; no reference implementation exists).

The PyTorch port's copy of the JAX package's ``plots.py``.  matplotlib is
imported inside the functions (Agg backend), so importing this module needs
nothing beyond numpy and a machine without matplotlib fails only when it
draws.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_token_probability(
    probs: np.ndarray,
    token_id: Optional[int] = None,
    input_words: Sequence[str] = (),
    *,
    start_idx: int = 0,
    figsize=(22, 11),
    font_size: int = 30,
    title_font_size: int = 36,
    tick_font_size: int = 32,
    colormap: str = "viridis",
):
    """Heatmap of one token's lens probability over (layer, position).

    ``probs`` is either [L, T, V] (reference all_probs; ``token_id`` required)
    or [L, T] (already-gathered target probability, the summary artifact).
    """
    probs = np.asarray(probs)
    if probs.ndim == 3:
        if token_id is None:
            raise ValueError("token_id required with [L, T, V] input")
        token_probs = probs[:, start_idx:, token_id]
    else:
        token_probs = probs[:, start_idx:]

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    plt.rcParams.update({"font.size": font_size})
    im = ax.imshow(token_probs, cmap=colormap, aspect="auto",
                   vmin=0, vmax=1, interpolation="nearest")
    cbar = fig.colorbar(im, ax=ax)
    cbar.ax.tick_params(labelsize=tick_font_size)
    ax.set_ylabel("Layers", fontsize=title_font_size)
    ax.set_yticks(list(range(token_probs.shape[0]))[::4])
    ax.tick_params(axis="y", labelsize=tick_font_size)
    if len(input_words) > 0:
        labels = list(input_words[start_idx:])
        ax.set_xticks(list(range(len(labels))))
        ax.set_xticklabels(labels, rotation=75, ha="right", fontsize=font_size)
    plt.tight_layout()
    return fig


def save_fig(fig, path: str, *, dpi: int = 300) -> None:
    import os

    from taboo_brittleness_tpu_torch.runtime.resilience import is_controller

    if is_controller():                        # rank 0 owns the outputs
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _pyplot().close(fig)


def plot_brittleness_curves(
    sweep: Mapping[str, Any],
    *,
    metric: str = "secret_prob_drop",
    figsize=(10, 6),
):
    """Targeted vs random-control curves over the intervention grid.

    ``sweep`` is the ``'ablation'`` or ``'projection'`` block of
    ``pipelines.interventions.run_intervention_study`` output: the x-axis is
    the budget m (or rank r), y-axis the chosen metric; the gap between the
    curves is the localization evidence the study is after.
    """
    axis_key = "budgets" if "budgets" in sweep else "ranks"
    grid = sorted(sweep[axis_key], key=int)
    xs = [int(g) for g in grid]
    targeted = [sweep[axis_key][g]["targeted"][metric] for g in grid]
    random_mean = [sweep[axis_key][g]["random_mean"][metric] for g in grid]
    rand_all = [
        [r[metric] for r in sweep[axis_key][g]["random"]] for g in grid
    ]

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(xs, targeted, "o-", label="targeted", color="tab:red")
    ax.plot(xs, random_mean, "s--", label="random (mean)", color="tab:blue")
    for x, vals in zip(xs, rand_all):
        ax.scatter([x] * len(vals), vals, alpha=0.25, s=12, color="tab:blue")
    ax.set_xscale("log", base=2)
    ax.set_xticks(xs)
    ax.set_xticklabels([str(x) for x in xs])
    ax.set_xlabel("ablation budget m" if axis_key == "budgets" else "projection rank r")
    ax.set_ylabel(metric)
    ax.legend()
    ax.set_title(f"{sweep.get('word', '')}: targeted vs random ({metric})")
    plt.tight_layout()
    return fig
