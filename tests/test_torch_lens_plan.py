"""How the port's lens readout cuts a call (``lens_plan``) and the plain
version of what its kernels write (``lens_stats_partials_reference``), merged
by the epilogue every route shares (``merge_partials``).

The kernels themselves run only on the card (``chip_smoke.py`` holds them to
these functions there); here the chunking is held to the JAX package's Pallas
kernel in interpret mode, to its XLA oracle and to ``lax.top_k``'s tie rule.
Inputs come from numpy seeds; f32 throughout.  Tolerance rtol = atol = 1e-5,
as ``tests/test_pallas_lens.py``: two f32 matmuls that sum in different
orders.  Ids are compared exactly.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.ops import pallas_lens
from taboo_brittleness_tpu_torch.ops import lens_kernel

TOL = dict(rtol=1e-5, atol=1e-5)
BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


def _inputs(rng, n, d, v):
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(v, d)).astype(np.float32))


def _assert_stats_close(got, exp):
    np.testing.assert_allclose(got.logsumexp.numpy(),
                               np.asarray(exp.logsumexp), **TOL)
    np.testing.assert_allclose(got.target_logit.numpy(),
                               np.asarray(exp.target_logit), **TOL)
    np.testing.assert_allclose(got.topk_vals.numpy(),
                               np.asarray(exp.topk_vals), **TOL)
    np.testing.assert_array_equal(got.topk_ids.numpy(),
                                  np.asarray(exp.topk_ids))


def test_main_path_plan_fills_whole_waves():
    plan = lens_kernel.lens_plan(1140, 256_000, 5, BF16)
    assert plan.route == "wgmma"
    assert (plan.row_tiles, plan.vocab_tiles, plan.chunks) == (9, 1000, 44)
    assert plan.row_tiles * plan.chunks == 3 * lens_kernel.H100_SMS
    assert plan.bounds[0] == 0 and plan.bounds[-1] == 256_000
    tiles = np.diff(plan.bounds) // lens_kernel.WGMMA_COLS
    assert set(tiles.tolist()) == {22, 23}


SPLITV_ROWS = lens_kernel.SPLITV_MAX_ROWS
TILE_COLS = {"splitv": lens_kernel.SPLITV_TILE, "wgmma": lens_kernel.WGMMA_COLS}
# The route's own plan, whatever lens_plan would pick for the shape.
PLANS = {"splitv": lambda n, v, k, sm: lens_kernel._splitv_plan(n, v, sm),
         "wgmma": lambda n, v, k, sm: lens_kernel._wgmma_plan(n, v, sm)}
F32_ROWS = lens_kernel.SPLITV_F32_MAX_ROWS


@pytest.mark.parametrize("n,v,k,dtype,route,row_tiles,vocab_tiles", [
    (1, 256_000, 5, BF16, "splitv", 1, 8000),
    (129, 256_000, 5, BF16, "wgmma", 2, 1000),
    (1140, 384, 5, BF16, "wgmma", 9, 2),
    (1140, 256_000, lens_kernel.KMAX, BF16, "wgmma", 9, 1000),
    (1140, 256_000, 5, F32, "wgmma", 9, 1000),
    (1140, 256_000, 32, BF16, "wgmma", 9, 1000),
    (1140, 256_000, 16, BF16, "wgmma", 9, 1000),
    (1140, 256_000, lens_kernel.KMAX_WIDE + 1, BF16, "wgmma", 9, 1000),
    (1140, 256_000, 128, BF16, "wgmma", 9, 1000),
    (1140, 256_000, 16, F32, "wgmma", 9, 1000),
    (3, 384, lens_kernel.KMAX + 1, BF16, "splitv", 1, 12),
    (3, 384, lens_kernel.KMAX_WIDE + 1, BF16, "splitv", 1, 12),
    (8, 256_000, 1, BF16, "splitv", 1, 8000),
    (8, 128_000, 1, BF16, "splitv", 1, 4000),
    (32, 256_000, 1, BF16, "splitv", 1, 8000),
    (32, 128_000, 5, BF16, "splitv", 1, 4000),
    (8, 256_000, lens_kernel.KMAX, BF16, "splitv", 1, 8000),
    (1, 128_000, lens_kernel.KMAX, BF16, "splitv", 1, 4000),
    (SPLITV_ROWS + 1, 256_000, 1, BF16, "wgmma", 1, 1000),
    (SPLITV_ROWS + 1, 128_000, lens_kernel.KMAX, BF16, "wgmma", 1, 500),
    (SPLITV_ROWS + 1, 256_000, lens_kernel.KMAX_WIDE, BF16, "wgmma", 1, 1000),
    (SPLITV_ROWS, 256_000, lens_kernel.KMAX_WIDE, BF16, "splitv", 1, 8000),
    (8, 256_000, 1, F32, "splitv", 1, 8000),
    (8, 256_000, lens_kernel.KMAX_WIDE, F32, "splitv", 1, 8000),
    (8, 128_000, lens_kernel.KMAX + 1, BF16, "splitv", 1, 4000),
    (32, 256_000, 16, BF16, "splitv", 1, 8000),
    (8, 128_000, lens_kernel.KMAX_WIDE + 1, BF16, "splitv", 1, 4000),
    (F32_ROWS, 256_000, 1, F32, "splitv", 1, 8000),
    (F32_ROWS, 128_000, lens_kernel.KMAX_WIDE, F32, "splitv", 1, 4000),
    (F32_ROWS + 1, 256_000, 1, F32, "wgmma", 1, 1000),
    (F32_ROWS + 1, 256_000, lens_kernel.KMAX, F32, "wgmma", 1, 1000),
    (1140, 256_000, lens_kernel.KMAX_WIDE + 1, F32, "wgmma", 9, 1000),
    (8, 256_000, lens_kernel.KMAX_WIDE + 1, F32, "splitv", 1, 8000),
    (8, 256_000, lens_kernel.MERGE_MAX + 1, BF16, "splitv", 1, 8000),
    (1140, 256_000, lens_kernel.TOP_K_MAX, BF16, "wgmma", 9, 1000),
    (SPLITV_ROWS, 256_000, lens_kernel.TOP_K_MAX, BF16, "splitv", 1, 8000),
])
def test_plan_routes_and_edges(n, v, k, dtype, route, row_tiles, vocab_tiles):
    plan = lens_kernel.lens_plan(n, v, k, dtype)
    assert (plan.route, plan.row_tiles, plan.vocab_tiles) == (
        route, row_tiles, vocab_tiles)
    assert len(plan.bounds) == plan.chunks + 1
    assert plan.bounds[0] == 0 and plan.bounds[-1] == v
    assert all(a < b for a, b in zip(plan.bounds, plan.bounds[1:]))
    # Whole kernel tiles, balanced to within one tile; a ragged last tile
    # only at the very end.  A longer top-k takes the K = KMAX_WIDE plan.
    cols = TILE_COLS[route]
    assert all(b % cols == 0 for b in plan.bounds[:-1])
    tiles = [-(-(b - a) // cols)
             for a, b in zip(plan.bounds, plan.bounds[1:])]
    assert max(tiles) - min(tiles) <= 1 and sum(tiles) == vocab_tiles
    assert plan == lens_kernel.lens_plan(n, v, min(k, lens_kernel.KMAX_WIDE),
                                         dtype)


@pytest.mark.parametrize("sm_count", [lens_kernel.H100_SMS, 66])
@pytest.mark.parametrize("v", [256_000, 128_000])
@pytest.mark.parametrize("n", [1, 8, SPLITV_ROWS])
def test_splitv_plan_fills_one_wave_evenly(n, v, sm_count):
    """One block per SM, whole 32-row tiles covering V, the longest chunk
    within one tile of the shortest and within 3% of the mean bytes."""
    plan = lens_kernel.lens_plan(n, v, 1, BF16, sm_count=sm_count)
    assert plan.route == "splitv"
    assert plan.chunks == sm_count and plan.row_tiles == 1
    assert plan.bounds[0] == 0 and plan.bounds[-1] == v
    assert all(b % lens_kernel.SPLITV_TILE == 0 for b in plan.bounds)
    rows = np.diff(plan.bounds)
    assert rows.max() - rows.min() <= lens_kernel.SPLITV_TILE
    assert rows.max() <= 1.03 * rows.mean()


def test_plan_follows_the_cards_sm_count():
    small = lens_kernel.lens_plan(1140, 256_000, 5, BF16, sm_count=66)
    assert small.row_tiles * small.chunks % 66 == 0
    assert small.bounds[-1] == 256_000


MERGED_SHAPES = [(6, 32, 256, 3), (16, 64, 512, 5), (5, 16, 384, 4),
                 (7, 16, 4224, 5), (8, 32, 2048, 16), (6, 16, 4224, 32)]


@pytest.mark.parametrize("route", ["splitv", "wgmma"])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("n_rows,d,v,k", MERGED_SHAPES)
def test_merged_partials_match_pallas_and_xla(n_rows, d, v, k, cap, route):
    rng = np.random.default_rng(0)
    x, embed = _inputs(rng, n_rows, d, v)
    plan = PLANS[route](n_rows, v, k, 4)
    assert plan.route == route
    parts = lens_kernel.lens_stats_partials_reference(
        torch.from_numpy(x), torch.from_numpy(embed), 7, plan, top_k=k,
        logit_cap=cap)
    assert tuple(parts.chunk_max.shape) == (plan.chunks, n_rows)
    assert tuple(parts.cand_ids.shape) == (plan.chunks, n_rows, k)
    got = lens_kernel.merge_partials(parts)
    ref = lens_kernel.lens_stats_reference(
        torch.from_numpy(x), torch.from_numpy(embed), 7, top_k=k,
        logit_cap=cap)
    pallas = pallas_lens.lens_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(7, jnp.int32),
        top_k=k, logit_cap=cap, block_v=128, interpret=True)
    _assert_stats_close(got, ref)
    _assert_stats_close(got, pallas)
    assert got.topk_ids.dtype == torch.int32


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("n_rows,d,v,k", MERGED_SHAPES)
def test_certified_top_k_matches_pallas_and_xla(n_rows, d, v, k, cap):
    """The same shapes at a top-k KMAX_WIDE above theirs: the partials of
    ``lens_stats_partials`` (CPU: the plain passes under ``certify_top_k``,
    one chunk), merged, against the Pallas kernel and the XLA oracle."""
    k += lens_kernel.KMAX_WIDE
    rng = np.random.default_rng(0)
    x, embed = _inputs(rng, n_rows, d, v)
    parts = lens_kernel.lens_stats_partials(
        torch.from_numpy(x), torch.from_numpy(embed), 7, top_k=k,
        logit_cap=cap)
    assert tuple(parts.cand_ids.shape) == (1, n_rows, k)
    got = lens_kernel.merge_partials(parts)
    pallas = pallas_lens.lens_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(7, jnp.int32),
        top_k=k, logit_cap=cap, block_v=128, interpret=True)
    xla = pallas_lens.lens_stats_reference(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(7, jnp.int32),
        top_k=k, logit_cap=cap)
    _assert_stats_close(got, pallas)
    _assert_stats_close(got, xla)


WGMMA_BOUNDS, SPLITV_BOUNDS = (0, 2048, 4096, 6272), (0, 2080, 4160, 6272)


@pytest.mark.parametrize("route,bounds,k", [
    pytest.param("wgmma", WGMMA_BOUNDS, 2, id="wgmma-bounds0"),
    pytest.param("splitv", SPLITV_BOUNDS, 2, id="splitv-bounds1"),
    pytest.param("wgmma", WGMMA_BOUNDS, 16, id="wgmma-bounds0-k16"),
    pytest.param("wgmma", WGMMA_BOUNDS, 32, id="wgmma-bounds0-k32"),
    pytest.param("splitv", SPLITV_BOUNDS, 16, id="splitv-bounds1-k16"),
    pytest.param("splitv", SPLITV_BOUNDS, 32, id="splitv-bounds1-k32"),
])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_per_row_targets_across_chunks(cap, route, bounds, k):
    """[N] targets at the edges of the chunks, one absent (-1), one in the
    last tile; the short top-k list and the long one (K 16 and 32)."""
    rng = np.random.default_rng(4)
    n, d, v = 9, 32, 6272
    x, embed = _inputs(rng, n, d, v)
    edges = [b + e for b in bounds[1:-1] for e in (-1, 0)]
    targets = np.array([0, *edges, 6271, -1, 3000, 6200], np.int32)
    plan = PLANS[route](n, v, k, 3)
    assert plan.chunks == 3
    if k > lens_kernel.KMAX:     # what lens_plan gives such a bf16 call
        assert lens_kernel.lens_plan(
            n if route == "splitv" else SPLITV_ROWS + 1, v, k, BF16,
            sm_count=3).route == route
    got = lens_kernel.merge_partials(lens_kernel.lens_stats_partials_reference(
        torch.from_numpy(x), torch.from_numpy(embed),
        torch.from_numpy(targets), plan, top_k=k, logit_cap=cap))
    exp = pallas_lens.lens_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(targets), top_k=k,
        logit_cap=cap, block_v=128, interpret=True)
    xla = pallas_lens.lens_stats_reference(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(targets), top_k=k,
        logit_cap=cap)
    _assert_stats_close(got, exp)
    _assert_stats_close(got, xla)
    assert plan.bounds == bounds
    assert got.target_logit[6].item() == np.float32(lens_kernel.NEG_INF)


@pytest.mark.parametrize("route,k", [
    pytest.param("splitv", 6, id="splitv"),
    pytest.param("wgmma", 6, id="wgmma"),
    pytest.param("splitv", 16, id="splitv-k16"),
    pytest.param("splitv", 32, id="splitv-k32"),
    pytest.param("wgmma", 16, id="wgmma-k16"),
    pytest.param("wgmma", 32, id="wgmma-k32"),
])
def test_ties_across_tiles_and_chunks_take_the_lowest_id(route, k):
    """Duplicated embedding rows in different vocab tiles and chunks tie
    exactly; the merged top-k must take them lowest id first, as lax.top_k,
    down the whole list (exact ties are frequent below the top four)."""
    rng = np.random.default_rng(7)
    n, d, v = 8, 16, 8192
    # Sums of multiples of 1/8: exact in f32 in any order, so ties are exact
    # (and frequent below the top four).
    x = rng.integers(-1, 2, size=(n, d)).astype(np.float32)
    x[:, :8] = 1.0
    embed = rng.integers(-1, 2, size=(v, d)).astype(np.float32) / 8
    hot = np.zeros(d, np.float32)
    hot[:8] = 1.0                                  # logit 8 > 2 >= any other
    dups = [5, 300, 4100, 8191]                    # tiles 0, 1, 16, 31
    embed[dups] = hot
    plan = PLANS[route](n, v, k, 4)
    assert plan.chunks == 4
    chunk_of = np.searchsorted(plan.bounds, dups, side="right")
    assert len(set(chunk_of.tolist())) >= 3
    got = lens_kernel.merge_partials(lens_kernel.lens_stats_partials_reference(
        torch.from_numpy(x), torch.from_numpy(embed), 0, plan, top_k=k))
    exp_v, exp_i = jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(embed).T, k)
    np.testing.assert_array_equal(got.topk_ids.numpy(), np.asarray(exp_i))
    np.testing.assert_array_equal(got.topk_vals.numpy(), np.asarray(exp_v))
    assert (got.topk_ids[:, :4].numpy() == dups).all()


def test_cpu_partials_take_the_plain_version():
    rng = np.random.default_rng(5)
    x, embed = _inputs(rng, 4, 16, 512)
    before = lens_kernel.lens_stats.launches
    plan = lens_kernel.lens_plan(4, 512, 3, F32)
    got = lens_kernel.lens_stats_partials(
        torch.from_numpy(x), torch.from_numpy(embed), 9, top_k=3)
    exp = lens_kernel.lens_stats_partials_reference(
        torch.from_numpy(x), torch.from_numpy(embed), 9, plan, top_k=3)
    assert lens_kernel.lens_stats.launches == before
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_rows,dtype,k,plan", [
    (128, torch.float64, 3,                                            # f64 on the wgmma route
     lambda: lens_kernel.lens_plan(128, 512, 3, BF16)),
    (128, BF16, 3, lambda: lens_kernel.lens_plan(128, 1024, 3, BF16)),  # a plan cut for another vocab
    (128, BF16, 3, lambda: lens_kernel.lens_plan(300, 512, 3, BF16)),   # ... or another row count
    (8, torch.float64, 3, lambda: lens_kernel.lens_plan(8, 512, 3, BF16)),  # f64 on the splitv route
    (SPLITV_ROWS + 1, BF16, 3,                                          # N over the route's limit
     lambda: lens_kernel._splitv_plan(SPLITV_ROWS + 1, 512, 4)),
    (8, BF16, 3, lambda: lens_kernel.lens_plan(8, 1024, 3, BF16)),      # splitv cut for another vocab
    (8, BF16, lens_kernel.KMAX_WIDE + 1,                                # top_k over KMAX_WIDE
     lambda: lens_kernel._splitv_plan(8, 512, 4)),
    (128, BF16, lens_kernel.KMAX_WIDE + 1,                              # ... on the wgmma route
     lambda: lens_kernel._wgmma_plan(128, 512, 4)),
    (8, BF16, 3, lambda: lens_kernel._splitv_plan(8, 512, 4)._replace(  # chunks not the plan's
        chunks=3)),
])
def test_launcher_refuses_plans_that_do_not_fit(n_rows, dtype, k, plan):
    x = torch.zeros((n_rows, 16), dtype=dtype)
    embed = torch.zeros((512, 16), dtype=dtype)
    targets = torch.zeros((n_rows,), dtype=torch.int32)
    with pytest.raises(ValueError):
        lens_kernel._launch(x, embed, targets, plan(), k, None)


@pytest.mark.parametrize("route", ["wgmma"])
def test_only_the_splitv_launch_merges_its_chunks(route):
    """``_launch(merged=True)`` is the split-V kernel's alone: the wgmma
    kernel writes partials for the torch merge, and asking it to merge
    raises before any launch."""
    x = torch.zeros((128, 16), dtype=BF16)
    embed = torch.zeros((512, 16), dtype=BF16)
    targets = torch.zeros((128,), dtype=torch.int32)
    plan = PLANS[route](128, 512, 3, 4)
    with pytest.raises(ValueError, match="partials only"):
        lens_kernel._launch(x, embed, targets, plan, 3, None, merged=True)


class _Exports:
    """A built library as the launcher reads it: its exported list lengths
    and input types."""

    def __init__(self, lengths, dtypes=(BF16, F32)):
        self.list_lengths = lengths
        self.dtypes = dtypes


@pytest.mark.parametrize("route,lengths,k", [
    ("splitv", (8, 16), 17),
    ("splitv", (8,), lens_kernel.KMAX + 1),
    ("wgmma", (8, 16), lens_kernel.KMAX_WIDE),
    ("wgmma", (4, 8), 5 + 4),
])
def test_launcher_refuses_a_top_k_above_the_librarys_lists(monkeypatch, route,
                                                           lengths, k):
    """A plan the wrapper's own limits allow, for a library whose exported
    list lengths are shorter: the launcher raises before it allocates or
    launches anything, and takes no other route."""
    n = 8 if route == "splitv" else 128
    plan = PLANS[route](n, 512, k, 4)
    monkeypatch.setattr(lens_kernel, "_library", lambda r: _Exports(lengths))
    x = torch.zeros((n, 16), dtype=BF16)
    embed = torch.zeros((512, 16), dtype=BF16)
    targets = torch.zeros((n,), dtype=torch.int32)
    before = dict(lens_kernel.lens_stats.route_launches)
    with pytest.raises(ValueError, match="keeps top-k lists"):
        lens_kernel._launch(x, embed, targets, plan, k, None)
    assert lens_kernel.lens_stats.route_launches == before


@pytest.mark.parametrize("lengths,k,want", [
    ((8, 32), 1, 8), ((8, 32), 8, 8), ((8, 32), 9, 32), ((8, 32), 32, 32),
    ((128,), 33, 128),
])
def test_list_length_takes_the_shortest_list_that_holds_k(lengths, k, want):
    assert lens_kernel.list_length(_Exports(lengths), "any", k) == want


@pytest.mark.parametrize("route,have,want", [
    ("splitv", (BF16,), F32), ("wgmma", (BF16,), F32),
    ("splitv", (F32,), BF16), ("wgmma", (F32,), BF16),
    ("splitv", (BF16, F32), F16), ("wgmma", (BF16, F32), F16),
])
def test_launcher_refuses_a_dtype_the_library_lacks(monkeypatch, route, have,
                                                    want):
    """A plan the wrapper allows, for a library that exports no
    instantiation of the call's dtype: the launcher raises before it
    allocates or launches anything, with no fallback to another route."""
    n = 8 if route == "splitv" else 128
    plan = PLANS[route](n, 512, 5, 4)
    monkeypatch.setattr(lens_kernel, "_library",
                        lambda r: _Exports((8, 32), have))
    x = torch.zeros((n, 16), dtype=want)
    embed = torch.zeros((512, 16), dtype=want)
    targets = torch.zeros((n,), dtype=torch.int32)
    before = dict(lens_kernel.lens_stats.route_launches)
    with pytest.raises(ValueError, match="instantiates"):
        lens_kernel._launch(x, embed, targets, plan, 5, None)
    assert lens_kernel.lens_stats.route_launches == before


@pytest.mark.parametrize("bits,want", [(1, (BF16,)), (2, (F32,)),
                                       (3, (BF16, F32)), (0, ()),
                                       (4, (F16,)), (7, (BF16, F32, F16))])
def test_exported_dtype_bits(bits, want):
    assert lens_kernel._dtypes(bits) == want


class _Launched(_Exports):
    """A library that exports f16 (bit 4) and records the arguments of each
    launch instead of running it."""

    def __init__(self):
        super().__init__((lens_kernel.KMAX, lens_kernel.KMAX_WIDE),
                         lens_kernel._dtypes(7))
        self.calls = []
        self.merge_max = lens_kernel.MERGE_MAX

    def tbx_lens_splitv(self, *args):
        self.calls.append(("splitv", args))
        return 0

    def tbx_lens_wgmma(self, *args):
        self.calls.append(("wgmma", args))
        return 0

    tbx_splitv_error_string = tbx_wgmma_error_string = staticmethod(bytes)


# Where each C launcher takes the dtype code, after its pointers and
# n, d, v, top_k, list_len, n_chunks, has_cap (``bind_library``'s argtypes).
DTYPE_ARG = {"splitv": 14 + 7, "wgmma": 9 + 7}


@pytest.mark.parametrize("route", ["splitv", "wgmma"])
@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_launcher_passes_the_dtype_code(monkeypatch, route, dtype):
    """A library exporting bit 4 takes f16: the launcher passes each type's
    bit as its dtype code (f16 4, bf16 1, f32 2), and only f32 gets the
    split scratch of x."""
    n = 8 if route == "splitv" else 128
    plan = PLANS[route](n, 512, 5, 4)
    lib = _Launched()
    monkeypatch.setattr(lens_kernel, "_library", lambda r: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros((n, 16), dtype=dtype)
    embed = torch.zeros((512, 16), dtype=dtype)
    targets = torch.zeros((n,), dtype=torch.int32)
    before = dict(lens_kernel.lens_stats.route_launches)
    try:
        lens_kernel._launch(x, embed, targets, plan, 5, None,
                            merged=route == "splitv")
        assert lens_kernel.lens_stats.route_launches[route] \
            == before[route] + 1
    finally:
        lens_kernel.lens_stats.route_launches.update(before)
        lens_kernel.lens_stats.launches -= len(lib.calls)
    [(called, args)] = lib.calls
    assert called == route
    assert args[DTYPE_ARG[route]] == lens_kernel.DTYPE_BITS[dtype]
    assert (args[2] is not None) == (dtype == F32)   # the split scratch
    assert args[DTYPE_ARG[route] - 7:DTYPE_ARG[route] - 4] == (n, 16, 512)


@pytest.mark.parametrize("n,route", [
    (1, "splitv"), (8, "splitv"), (F32_ROWS + 1, "splitv"),
    (SPLITV_ROWS, "splitv"), (SPLITV_ROWS + 1, "wgmma"), (1140, "wgmma")])
def test_f16_takes_the_bf16_row_limit(n, route):
    """f16 has bf16's bytes, so ``lens_plan`` sends it to the split-V kernel
    up to SPLITV_MAX_ROWS (f32 stops at SPLITV_F32_MAX_ROWS), with bf16's
    geometry."""
    plan = lens_kernel.lens_plan(n, 256_000, 5, F16)
    assert plan.route == route
    assert plan == lens_kernel.lens_plan(n, 256_000, 5, BF16)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("n,k", [(F32_ROWS, 5), (F32_ROWS + 1, 5),
                                 (F32_ROWS, lens_kernel.KMAX_WIDE),
                                 (F32_ROWS + 1, 16), (3, 1)])
def test_f32_plans_merged_match_pallas(n, k, cap):
    """The f32 routes' plans as ``lens_plan`` cuts them (split-V up to the
    f32 row limit, wgmma one past it) on a 4-SM card: the plain partials,
    merged by ``merge_partials``, against the JAX package's Pallas kernel in
    interpret mode on the same numpy-seeded f32 inputs, rtol = atol = 1e-5
    (f32 sums in different orders; the card's 3xTF32 product is held to
    the plain version by ``chip_smoke.py``)."""
    rng = np.random.default_rng(11)
    d, v = 32, 4224
    x, embed = _inputs(rng, n, d, v)
    targets = rng.integers(-1, v, size=n).astype(np.int32)
    plan = lens_kernel.lens_plan(n, v, k, F32, sm_count=4)
    assert plan.route == ("splitv" if n <= F32_ROWS else "wgmma")
    got = lens_kernel.merge_partials(lens_kernel.lens_stats_partials_reference(
        torch.from_numpy(x), torch.from_numpy(embed),
        torch.from_numpy(targets), plan, top_k=k, logit_cap=cap))
    exp = pallas_lens.lens_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(targets), top_k=k,
        logit_cap=cap, block_v=128, interpret=True)
    _assert_stats_close(got, exp)


@pytest.mark.parametrize("route,n,units,items", [
    # The main path's plan: 9 row tiles x 44 chunks of 22-23 tiles; one
    # open pair leaves one (chunk, row tile) unit to deal.
    ("wgmma", 1140, 396, (22, 23)),
    # A serve readout's: 132 chunks of 60-61 32-row tiles.
    ("splitv", 8, 132, (60, 61)),
])
def test_refill_work_at_the_main_shapes(route, n, units, items):
    """The refill's units and items on the card's plans, and how the
    fixed grid of 132 blocks shares them: one open pair spreads its unit
    over as many blocks as it has items, every pair open over all 132."""
    plan = lens_kernel.lens_plan(n, 256_000, 5, BF16)
    assert plan.route == route
    ceiling = torch.full((plan.chunks, n), lens_kernel.EMPTY_KEY,
                         dtype=torch.int64)
    work = lens_kernel.refill_work(ceiling, plan)
    assert len(work.items) == units and set(work.items) == set(items)
    assert work.units == () and work.starts == (0,)
    assert all(lens_kernel.refill_spans(work, b, 132) == ()
               for b in range(132))
    ceiling[plan.chunks // 2, n // 2] = 7
    work = lens_kernel.refill_work(ceiling, plan)
    assert len(work.units) == 1
    one = work.items[work.units[0]]
    assert work.starts == (0, one) and one in items
    ran = [b for b in range(132) if lens_kernel.refill_spans(work, b, 132)]
    assert len(ran) == one
    assert all(len(lens_kernel.refill_spans(work, b, 132)) == 1 for b in ran)
    work = lens_kernel.refill_work(torch.zeros_like(ceiling), plan)
    assert work.units == tuple(range(units))
    shares = [sum(up - first for _, _, first, up in
                  lens_kernel.refill_spans(work, b, 132)) for b in range(132)]
    assert max(shares) - min(shares) <= 1 and sum(shares) == sum(work.items)


def test_refill_geometry_follows_the_kernels():
    """A refill's unit is what one first-pass block owns, and its items
    are its plan tiles: 256-column wgmma tiles, 32-row split-V tiles."""
    wgmma = lens_kernel.lens_plan(1140, 256_000, 64, BF16)
    splitv = lens_kernel.lens_plan(8, 256_000, 64, BF16)
    assert lens_kernel._refill_geometry(wgmma, 1140) == (
        9, lens_kernel.WGMMA_ROWS, lens_kernel.WGMMA_COLS)
    assert lens_kernel._refill_geometry(splitv, 8) == (
        1, 8, lens_kernel.SPLITV_TILE)
    with pytest.raises(ValueError, match="refill"):
        lens_kernel._refill_geometry(lens_kernel.whole_plan(256), 3)
