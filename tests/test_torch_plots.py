"""The port's ``plots.py`` against the JAX package's on the same inputs: the
heatmap's image data, color limits, ticks and labels, and the brittleness
curves' line and scatter data, scales, labels and title are equal; both
write a PNG.  Figures are drawn with matplotlib's Agg backend at a small
size (the functions take the reference's sizes as defaults)."""

import numpy as np
import pytest

pytest.importorskip("matplotlib")

import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from taboo_brittleness_tpu import plots as jplots  # noqa: E402
from taboo_brittleness_tpu_torch import plots as tplots  # noqa: E402

SMALL = dict(figsize=(4, 3), font_size=6, title_font_size=7, tick_font_size=6)


def _axes_data(fig):
    ax = fig.axes[0]
    return {
        "lines": [(ln.get_label(), list(ln.get_xdata()), list(ln.get_ydata()),
                   ln.get_color(), ln.get_linestyle(), ln.get_marker())
                  for ln in ax.get_lines()],
        "scatter": [np.asarray(c.get_offsets()).tolist()
                    for c in ax.collections],
        "images": [(np.asarray(im.get_array()).tolist(), im.get_clim(),
                    im.get_cmap().name) for im in ax.get_images()],
        "xticks": list(ax.get_xticks()),
        "yticks": list(ax.get_yticks()),
        "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
        "xscale": ax.get_xscale(),
        "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
        "legend": ([t.get_text() for t in ax.get_legend().get_texts()]
                   if ax.get_legend() is not None else None),
        "n_axes": len(fig.axes),
    }


@pytest.mark.parametrize("shape", ["compact", "full"])
def test_token_probability_heatmap_equals_jax(shape):
    rng = np.random.default_rng(0)
    words = [f"t{i}" for i in range(9)]
    if shape == "compact":
        probs, tid = rng.random((12, 9)).astype(np.float32), None
    else:
        probs, tid = rng.random((12, 9, 17)).astype(np.float32), 5
    figs = [mod.plot_token_probability(probs, tid, words, start_idx=2,
                                       **SMALL)
            for mod in (tplots, jplots)]
    got, want = (_axes_data(f) for f in figs)
    assert got == want
    assert np.asarray(got["images"][0][0]).shape == (12, 7)
    for f in figs:
        plt.close(f)


def test_heatmap_of_full_probs_needs_a_token_id():
    with pytest.raises(ValueError):
        tplots.plot_token_probability(np.zeros((2, 3, 4)))


def _sweep(axis_key, grid):
    rng = np.random.default_rng(1)

    def arm():
        return {"secret_prob_drop": float(rng.random()),
                "delta_nll": float(rng.random())}

    return {"word": "moon", axis_key: {
        str(g): {"targeted": arm(), "random_mean": arm(),
                 "random": [arm() for _ in range(3)]} for g in grid}}


@pytest.mark.parametrize("axis_key,grid,metric", [
    ("budgets", (1, 2, 4, 8), "secret_prob_drop"),
    ("ranks", (1, 2, 4), "delta_nll"),
])
def test_brittleness_curves_equal_jax(axis_key, grid, metric):
    sweep = _sweep(axis_key, grid)
    figs = [mod.plot_brittleness_curves(sweep, metric=metric, figsize=(4, 3))
            for mod in (tplots, jplots)]
    got, want = (_axes_data(f) for f in figs)
    assert got == want
    assert got["lines"][0][1] == list(grid)
    assert got["xscale"] == "log"
    for f in figs:
        plt.close(f)


def test_save_fig_writes_a_png(tmp_path):
    fig = tplots.plot_brittleness_curves(_sweep("budgets", (1, 2)),
                                         figsize=(3, 2))
    path = tmp_path / "deep" / "curve.png"
    tplots.save_fig(fig, str(path), dpi=50)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
