"""A top-k above the lens kernels' 32-entry lists (``ops/lens_kernel.py``
``certify_top_k``): its passes over the plain partials with ceilings
(``lens_stats_partials_reference``), held to the top-k of the full logits
(``topk_lowest_id``) and to the JAX package's Pallas kernel (interpret mode)
and XLA tap.

On the card ``certify_top_k`` runs over the kernels' passes, and the split-V
kernel's last block runs its certificate in the launch; ``chip_smoke.py``
holds both to the plain version there.  Inputs come from numpy seeds; f32
throughout.  The plain passes compute the same f32 logits as
``lens_stats_reference``, so against it values and ids are exact; against
JAX rtol = atol = 1e-5 (f32 matmuls summed in other orders), ids exact.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import lens as jlens
from taboo_brittleness_tpu.ops import pallas_lens
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import lens as tlens
from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

TOL = dict(rtol=1e-5, atol=1e-5)
PLANS = {"splitv": lk._splitv_plan, "wgmma": lk._wgmma_plan}
SMS = 4   # a small card, so that the chunks are few and long


def _inputs(seed, n, d, v):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(-1, v, size=n).astype(np.int32)))


class _Passes:
    """The plain pass of a plan, recording each pass's ceilings."""

    def __init__(self, x, embed, targets, plan, cap=None):
        self.run = lk._plain_pass(x, embed, targets, plan, cap)
        self.ceilings = []

    def __call__(self, ceiling):
        self.ceilings.append(ceiling)
        return self.run(ceiling)


def _certified(x, embed, targets, plan, k, cap=None):
    passes = _Passes(x, embed, targets, plan, cap)
    stats = lk.merge_partials(lk.certify_top_k(passes, k))
    return stats, passes


def _assert_exact(got, ref):
    assert torch.equal(got.topk_ids, ref.topk_ids)
    assert torch.equal(got.topk_vals, ref.topk_vals)
    torch.testing.assert_close(got.logsumexp, ref.logsumexp, **TOL)
    assert torch.equal(got.target_logit, ref.target_logit)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("route", ["splitv", "wgmma"])
@pytest.mark.parametrize("k", [33, 64, 128])
def test_random_inputs_match_the_full_top_k(k, route, cap):
    x, embed, targets = _inputs(0, 6, 16, 8192)
    plan = PLANS[route](6, 8192, SMS)
    got, passes = _certified(x, embed, targets, plan, k, cap)
    _assert_exact(got, lk.lens_stats_reference(x, embed, targets, top_k=k,
                                               logit_cap=cap))
    assert len(passes.ceilings) == math.ceil(k / lk.KMAX_WIDE)
    assert passes.ceilings[0] is None


@pytest.mark.parametrize("k", [64, 100, 128])
@pytest.mark.parametrize("route", ["splitv", "wgmma"])
def test_a_rows_whole_top_k_in_one_chunk(route, k):
    """Every row's top-k in one chunk: that pair stays open through every
    pass (ceil(K / 32) of them) and the answer is exact."""
    x, embed, targets = _inputs(1, 5, 16, 8192)
    plan = PLANS[route](5, 8192, SMS)
    lo = plan.bounds[1]
    hot = embed[lo:lo + 2 * k] * 0.1 + 4 * x.mean(dim=0)
    embed = embed * 0.1
    embed[lo:lo + 2 * k] = hot
    x = x + 4 * x.mean(dim=0)
    got, passes = _certified(x, embed, targets, plan, k)
    ref = lk.lens_stats_reference(x, embed, targets, top_k=k)
    _assert_exact(got, ref)
    assert ((ref.topk_ids >= lo) & (ref.topk_ids < plan.bounds[2])).all()
    refills = passes.ceilings[1:]
    assert len(refills) == math.ceil(k / lk.KMAX_WIDE) - 1
    for ceiling in refills:
        assert (ceiling[1] != lk.EMPTY_KEY).all()


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("route", ["splitv", "wgmma"])
@pytest.mark.parametrize("k", [40, 128])
def test_all_equal_logits_take_the_lowest_ids(k, route, cap):
    """x = 0: every logit ties at 0, so every pair saturates and every pass
    runs full; the top-k is ids 0 .. k-1."""
    _, embed, _ = _inputs(2, 3, 16, 4096)
    x = torch.zeros((3, 16))
    plan = PLANS[route](3, 4096, SMS)
    got, passes = _certified(x, embed, 5, plan, k, cap)
    _assert_exact(got, lk.lens_stats_reference(x, embed, 5, top_k=k,
                                               logit_cap=cap))
    assert got.topk_ids.tolist() == [list(range(k))] * 3
    for ceiling in passes.ceilings[1:]:
        assert (ceiling[0] != lk.EMPTY_KEY).all()


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("v,route,k", [
    (256, "wgmma", 200), (256, "splitv", 256), (384, "wgmma", 384),
    (384, "splitv", 150), (4224, "wgmma", 500), (4224, "splitv", 1024),
])
def test_top_k_above_every_lists_sum(v, route, k, cap):
    """K above 32 x S on tiny vocabularies: the union of the first pass's
    lists is shorter than K, and ``certify_top_k`` still ends exact in
    ceil(K / 32) passes."""
    x, embed, targets = _inputs(3, 4, 8, v)
    plan = PLANS[route](4, v, SMS)
    assert k > lk.KMAX_WIDE * plan.chunks
    got, passes = _certified(x, embed, targets, plan, k, cap)
    _assert_exact(got, lk.lens_stats_reference(x, embed, targets, top_k=k,
                                               logit_cap=cap))
    assert len(passes.ceilings) == math.ceil(k / lk.KMAX_WIDE)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("k", [40, 128])
@pytest.mark.parametrize("route", ["splitv", "wgmma"])
def test_merged_stats_match_pallas(route, k, cap):
    x, embed, targets = _inputs(4, 7, 32, 4096)
    plan = PLANS[route](7, 4096, SMS)
    got, _ = _certified(x, embed, targets, plan, k, cap)
    exp = pallas_lens.lens_stats(
        jnp.asarray(x.numpy()), jnp.asarray(embed.numpy()),
        jnp.asarray(targets.numpy()), top_k=k, logit_cap=cap, block_v=128,
        interpret=True)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(got.topk_ids.numpy(), np.asarray(exp.topk_ids))


@pytest.mark.parametrize("fn", ["lens_stats", "lens_stats_partials"])
def test_top_k_200_matches_pallas(fn):
    """The lifted cap: top_k 200 on V 2048 through the port's entry points
    (CPU: the plain version, and the certified plain passes) against the
    Pallas kernel at its default block_v."""
    x, embed, targets = _inputs(5, 6, 16, 2048)
    got = getattr(lk, fn)(x, embed, targets, top_k=200)
    if fn == "lens_stats_partials":
        assert tuple(got.cand_ids.shape) == (1, 6, 200)
        got = lk.merge_partials(got)
    exp = pallas_lens.lens_stats(
        jnp.asarray(x.numpy()), jnp.asarray(embed.numpy()),
        jnp.asarray(targets.numpy()), top_k=200, interpret=True)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(got.topk_ids.numpy(), np.asarray(exp.topk_ids))


@pytest.mark.parametrize("k", [0, lk.TOP_K_MAX + 1, 4097])
def test_top_k_out_of_range_raises(k):
    x, embed, _ = _inputs(6, 2, 8, 4096)
    with pytest.raises(ValueError, match="top_k must be"):
        lk.lens_stats(x, embed, 0, top_k=k)


def test_top_k_max_runs():
    x, embed, targets = _inputs(6, 3, 8, 2048)
    got = lk.lens_stats_partials(x, embed, targets, top_k=lk.TOP_K_MAX)
    ref = lk.lens_stats_reference(x, embed, targets, top_k=lk.TOP_K_MAX)
    assert torch.equal(got.cand_ids[0], ref.topk_ids)


def test_keys_order_as_the_kernels_compare():
    """Value descending, then id ascending, -0 equal to +0; the empty key
    below every finite value's; the keys decode to their value and id."""
    vals = torch.tensor([1.5, -0.0, 0.0, -3.0, 1.5, float("-inf"),
                         -3.4e38, 2.0])
    ids = torch.tensor([9, 2, 7, 1, 4, 2**31 - 1, 0, 123456])
    keys = lk._keys(vals, ids)
    order = torch.argsort(keys, descending=True).tolist()
    assert order == [7, 4, 0, 1, 2, 3, 6, 5]
    assert keys[5].item() == lk.EMPTY_KEY == keys.min().item()
    back_v, back_i = lk._unkey(keys)
    assert torch.equal(back_v, torch.where(vals == 0, 0.0, vals))
    assert torch.equal(back_i, ids.to(torch.int32))


def test_a_ceiling_lists_strictly_below_it():
    """A refill pass lists a chunk's keys strictly below its ceiling; the
    empty key leaves nothing (the list comes back empty)."""
    x, embed, targets = _inputs(7, 3, 8, 1024)
    plan = lk._wgmma_plan(3, 1024, SMS)
    first = lk.lens_stats_partials_reference(x, embed, targets, plan, top_k=32)
    keys = lk._keys(first.cand_vals, first.cand_ids)
    ceiling = keys[..., 9].clone()
    ceiling[0, 1] = lk.EMPTY_KEY
    refill = lk.lens_stats_partials_reference(x, embed, targets, plan,
                                              top_k=32, ceiling=ceiling)
    again = lk._keys(refill.cand_vals, refill.cand_ids)
    assert (again[0, 1] == lk.EMPTY_KEY).all()
    assert torch.equal(again[1:, :, :22], keys[1:, :, 10:])
    assert torch.equal(again[0, [0, 2], :22], keys[0, [0, 2], 10:])
    assert ((again < ceiling[..., None]) | (again == lk.EMPTY_KEY)).all()


def test_the_launcher_checks_a_pass_before_it_launches():
    """Ceilings of another shape or type, a ceiling on a short pass, and a
    certified merge on partials alone all raise before any launch."""
    x = torch.zeros((8, 16), dtype=torch.bfloat16)
    embed = torch.zeros((512, 16), dtype=torch.bfloat16)
    targets = torch.zeros((8,), dtype=torch.int32)
    plan = lk._splitv_plan(8, 512, SMS)
    good = torch.zeros((SMS, 8), dtype=torch.int64)
    stats = lk.LensStats(torch.zeros(8), torch.zeros(8), torch.zeros((8, 64)),
                         torch.zeros((8, 64), dtype=torch.int32))
    before = dict(lk.lens_stats.route_launches)
    for kw, k in ((dict(ceiling=good.int()), 32),
                  (dict(ceiling=good[:, :4].contiguous()), 32),
                  (dict(ceiling=good), 16),
                  (dict(certify=lk._Certify(stats, good,
                                            torch.zeros(3 + 3 * SMS,
                                                        dtype=torch.int32),
                                            torch.zeros(1, dtype=torch.int32))),
                   32)):
        with pytest.raises(ValueError):
            lk._launch(x, embed, targets, plan, k, None, **kw)
    assert lk.lens_stats.route_launches == before


def test_cpu_partials_of_a_long_top_k_run_no_kernel():
    x, embed, targets = _inputs(8, 4, 8, 1024)
    before = lk.lens_stats.launches
    got = lk.lens_stats_partials(x, embed, targets, top_k=64)
    assert lk.lens_stats.launches == before
    ref = lk.lens_stats_reference(x, embed, targets, top_k=64)
    assert torch.equal(got.cand_ids[0], ref.topk_ids)
    torch.testing.assert_close(lk.merge_partials(got).logsumexp,
                               ref.logsumexp, **TOL)


@pytest.fixture(scope="module")
def tiny256():
    cfg_j = jg.PRESETS["gemma2_tiny"].replace(vocab_size=256)
    cfg_t = tg.PRESETS["gemma2_tiny"].replace(vocab_size=256)
    params_j = jg.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.mark.parametrize("tap", ["kernel", "plain"])
def test_lens_tap_at_top_k_200_matches_jax_xla_tap(tiny256, tap):
    """The port's lens taps at top_k 200 on gemma2_tiny (vocab 256) against
    JAX's XLA tap: probabilities at atol 1e-6 / rtol 1e-4, ids equal at
    every rank whose probability stands clear of both neighbours."""
    cfg_j, params_j, cfg_t, params_t = tiny256
    ids = np.random.default_rng(3).integers(0, 256, size=(2, 9))
    exp = jlens.lens_forward(params_j, cfg_j, jnp.asarray(ids),
                             jnp.full((2,), 17, jnp.int32), tap_layer=2,
                             top_k=200, use_pallas=False).tap
    make = (tlens.make_kernel_lens_tap(params_t, cfg_t, 17, top_k=200)
            if tap == "kernel" else
            tlens.make_lens_tap(params_t, cfg_t, torch.tensor([17, 17]),
                                top_k=200))
    got = tg.forward(params_t, cfg_t, torch.from_numpy(ids).long(),
                     per_layer_fn=make).taps
    probs = np.asarray(exp.topk_probs)
    np.testing.assert_allclose(got.topk_probs.numpy(), probs, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.target_prob.numpy(),
                               np.asarray(exp.target_prob), rtol=1e-4,
                               atol=1e-6)
    gap = np.abs(np.diff(probs, axis=-1)) / probs[..., :-1]
    below = np.concatenate([gap, np.full(gap.shape[:-1] + (1,), np.inf)], -1)
    above = np.concatenate([np.full(gap.shape[:-1] + (1,), np.inf), gap], -1)
    clear = (below > 1e-3) & (above > 1e-3)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.topk_ids.numpy()[clear],
                                  np.asarray(exp.topk_ids)[clear])


# ---------------------------------------------------------------------------
# A refill dealt over a fixed grid (csrc/refill_work.cuh, the plain pass's
# `refill_work` / `refill_spans` / `_spread_refill`).
# ---------------------------------------------------------------------------

def _first_pass_ceilings(x, embed, targets, plan, k, cap=None):
    """The ceilings ``certify_top_k`` hands its first refill."""
    seen = []

    def record(ceiling):
        seen.append(ceiling)
        return lk.lens_stats_partials_reference(
            x, embed, targets, plan, top_k=lk.KMAX_WIDE, logit_cap=cap,
            ceiling=ceiling)

    lk.certify_top_k(record, k)
    return seen[1]


def _one_chunk_inputs(seed, n, v, route, k):
    """Every row's top-k planted in chunk 1 of the route's plan."""
    x, embed, targets = _inputs(seed, n, 16, v)
    plan = PLANS[route](n, v, SMS)
    lo = plan.bounds[1]
    hot = embed[lo:lo + 2 * k] * 0.1 + 4 * x.mean(dim=0)
    embed = embed * 0.1
    embed[lo:lo + 2 * k] = hot
    return x + 4 * x.mean(dim=0), embed, targets, plan


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
@pytest.mark.parametrize("route,n,v", [("splitv", 5, 8192),
                                       ("wgmma", 300, 8192),
                                       ("wgmma", 5, 16384)])
def test_refill_spans_deal_each_open_item_once(route, n, v, grid):
    """Every item (a plan tile) of every open unit goes to
    exactly one block, the blocks' shares differ by one item at most, a
    block's spans are consecutive, and no two pieces share a slot m + b."""
    plan = PLANS[route](n, v, SMS)
    rng = np.random.default_rng(grid)
    ceiling = torch.where(torch.from_numpy(rng.random((plan.chunks, n)) < 0.3),
                          torch.tensor(7), torch.tensor(lk.EMPTY_KEY))
    work = lk.refill_work(ceiling, plan)
    rows = plan.row_tiles if route == "wgmma" else 1
    assert len(work.items) == plan.chunks * rows
    open_units = [u for u in range(len(work.items))
                  if (ceiling[u // rows] != lk.EMPTY_KEY)[
                      (u % rows) * lk.WGMMA_ROWS:(u % rows + 1) * lk.WGMMA_ROWS
                  ].any()] if route == "wgmma" else [
        u for u in range(plan.chunks) if (ceiling[u] != lk.EMPTY_KEY).any()]
    assert list(work.units) == open_units
    total = work.starts[-1]
    assert total == sum(work.items[u] for u in work.units)
    dealt, slots, shares = {}, set(), []
    for b in range(grid):
        spans = lk.refill_spans(work, b, grid)
        shares.append(sum(upto - first for _, _, first, upto in spans))
        for m, u, first, upto in spans:
            assert work.units[m] == u and 0 <= first < upto <= work.items[u]
            for item in range(first, upto):
                assert (u, item) not in dealt
                dealt[(u, item)] = b
                assert lk.refill_block_of(work.starts[m] + item, total,
                                          grid) == b
            if (first, upto) != (0, work.items[u]):
                assert m + b not in slots
                slots.add(m + b)
        assert [m for m, *_ in spans] == list(
            range(spans[0][0], spans[0][0] + len(spans))) if spans else True
    assert sorted(dealt) == sorted((u, i) for u in work.units
                                   for i in range(work.items[u]))
    assert max(shares) - min(shares) <= 1
    assert all(s < len(work.items) + grid for s in slots)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("grid", [1, 2, 5, 132])
@pytest.mark.parametrize("case", ["random", "one_chunk", "all_equal"])
@pytest.mark.parametrize("route", ["splitv", "wgmma"])
def test_a_spread_refill_lists_what_the_unsplit_one_does(route, case, grid,
                                                          cap):
    """The lists of a refill dealt over `grid` blocks (whole units, pieces
    merged) equal, key for key, those of the same refill on the first
    pass's plan: each pair's 32 largest keys below its ceiling."""
    n, v, k = 6, 8192, 128
    if case == "one_chunk":
        x, embed, targets, plan = _one_chunk_inputs(9, n, v, route, k)
    else:
        x, embed, targets = _inputs(9, n, 16, v)
        plan = PLANS[route](n, v, SMS)
        if case == "all_equal":
            x = torch.zeros_like(x)
    ceiling = _first_pass_ceilings(x, embed, targets, plan, k, cap)
    whole = lk.lens_stats_partials_reference(
        x, embed, targets, plan, top_k=32, logit_cap=cap, ceiling=ceiling)
    spread = lk.lens_stats_partials_reference(
        x, embed, targets, plan, top_k=32, logit_cap=cap, ceiling=ceiling,
        grid=grid)
    assert torch.equal(lk._keys(spread.cand_vals, spread.cand_ids),
                       lk._keys(whole.cand_vals, whole.cand_ids))
    if case != "random":
        assert lk.refill_work(ceiling, plan).units


def test_ties_across_a_piece_boundary_keep_the_lowest_ids():
    """Equal logits on both sides of a tile boundary inside one chunk, so
    that two pieces of a refill hold them: the merged lists, and the call,
    keep the lowest ids first."""
    n, v, k = 3, 4096, 64
    _, embed, targets = _inputs(10, n, 8, v)
    x = torch.zeros((n, 8))
    x[:, 0] = 1.0
    plan = lk._wgmma_plan(n, v, SMS)
    lo = plan.bounds[1]
    edge = lo + lk.WGMMA_COLS           # a tile boundary inside chunk 1
    embed[:, 0] = -1.0
    embed[edge - 40:edge + 40, 0] = 2.0  # 80 equal logits across it
    for grid in (2, 3, 9):
        ceiling = _first_pass_ceilings(x, embed, targets, plan, k)
        whole = lk.lens_stats_partials_reference(
            x, embed, targets, plan, top_k=32, ceiling=ceiling)
        spread = lk.lens_stats_partials_reference(
            x, embed, targets, plan, top_k=32, ceiling=ceiling, grid=grid)
        assert torch.equal(spread.cand_ids, whole.cand_ids)
        got = lk.merge_partials(lk.certify_top_k(
            lk._plain_pass(x, embed, targets, plan, None, grid=grid), k))
        assert got.topk_ids.tolist() == [list(range(edge - 40, edge + 24))] * n


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("k", [33, 64, 128, 1024])
@pytest.mark.parametrize("route", ["splitv", "wgmma"])
def test_spread_certified_passes_match_pallas_and_the_full_top_k(route, k,
                                                                 cap):
    """``certify_top_k`` over the plain passes dealt over a 3-block grid
    against the top-k of the full logits (exact) and JAX's Pallas kernel
    in interpret mode (ids exact, values at 1e-5)."""
    x, embed, targets = _inputs(11, 5, 16, 4096)
    plan = PLANS[route](5, 4096, SMS)
    got = lk.merge_partials(lk.certify_top_k(
        lk._plain_pass(x, embed, targets, plan, cap, grid=3), k))
    _assert_exact(got, lk.lens_stats_reference(x, embed, targets, top_k=k,
                                               logit_cap=cap))
    exp = pallas_lens.lens_stats(
        jnp.asarray(x.numpy()), jnp.asarray(embed.numpy()),
        jnp.asarray(targets.numpy()), top_k=k, logit_cap=cap, block_v=128,
        interpret=True)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(got.topk_ids.numpy(), np.asarray(exp.topk_ids))


@pytest.mark.parametrize("route", ["splitv", "wgmma"])
def test_a_pair_that_closes_between_refills(route):
    """The top-100 split 70 / 40 between chunks 1 and 2: both pairs stay
    open after the first pass, chunk 2's closes after the first refill (its
    40 are listed and the 100th key rises past its list's end) while chunk
    1's stays open; the spread passes (grid 4) stay exact and the last work
    list holds no other chunk."""
    n, v, k = 4, 8192, 100
    rng = np.random.default_rng(12)
    plan = PLANS[route](n, v, SMS)
    logit = rng.normal(size=v).astype(np.float32) * 0.1
    hot = rng.uniform(5, 10, size=110).astype(np.float32)
    logit[plan.bounds[1]:plan.bounds[1] + 70] = hot[:70]
    logit[plan.bounds[2]:plan.bounds[2] + 40] = hot[70:]
    embed = torch.from_numpy(rng.normal(size=(v, 8)).astype(np.float32))
    embed[:, 0] = torch.from_numpy(logit)
    x = torch.zeros((n, 8))
    x[:, 0] = 1.0
    targets = torch.zeros((n,), dtype=torch.int32)
    passes = _Passes(x, embed, targets, plan)
    passes.run = lk._plain_pass(x, embed, targets, plan, None, grid=4)
    got = lk.merge_partials(lk.certify_top_k(passes, k))
    _assert_exact(got, lk.lens_stats_reference(x, embed, targets, top_k=k))
    first, second, third = passes.ceilings[1:]
    assert (first[1:3] != lk.EMPTY_KEY).all()
    assert (second[1] != lk.EMPTY_KEY).all() and (second[2] == lk.EMPTY_KEY).all()
    rows = plan.row_tiles if route == "wgmma" else 1
    assert set(lk.refill_work(third, plan).units) <= {1 * rows}
