"""The port's fused lens readout (``ops/lens_kernel.py``) against the JAX
package's Pallas kernel (interpret mode) and its XLA oracle.

On the CPU ``lens_stats`` runs its plain version; the CUDA kernel is held to
that plain version on the card by ``chip_smoke.py``.  Inputs come from numpy
seeds; f32 throughout (TF32 off, stated for the record: no CUDA here).
Tolerance rtol = atol = 1e-5, as ``tests/test_pallas_lens.py``: two f32
matmuls that sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.ops import pallas_lens
from taboo_brittleness_tpu_torch.ops import lens_kernel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(rng, n, d, v):
    x = rng.normal(size=(n, d)).astype(np.float32)
    embed = rng.normal(size=(v, d)).astype(np.float32)
    return x, embed


def _assert_stats_close(got, exp, *, ids=True):
    np.testing.assert_allclose(got.logsumexp.numpy(),
                               np.asarray(exp.logsumexp), **TOL)
    np.testing.assert_allclose(got.target_logit.numpy(),
                               np.asarray(exp.target_logit), **TOL)
    np.testing.assert_allclose(got.topk_vals.numpy(),
                               np.asarray(exp.topk_vals), **TOL)
    if ids:
        np.testing.assert_array_equal(got.topk_ids.numpy(),
                                      np.asarray(exp.topk_ids))


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("n_rows,d,v,k", [(6, 32, 256, 3), (16, 64, 512, 5),
                                          (8, 32, 1024, 16), (6, 16, 512, 32)])
def test_lens_stats_matches_pallas_and_xla(n_rows, d, v, k, cap):
    rng = np.random.default_rng(0)
    x, embed = _both(rng, n_rows, d, v)
    got = lens_kernel.lens_stats(torch.from_numpy(x), torch.from_numpy(embed),
                                 7, top_k=k, logit_cap=cap)
    pallas = pallas_lens.lens_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(7, jnp.int32),
        top_k=k, logit_cap=cap, block_v=128, interpret=True)
    xla = pallas_lens.lens_stats_reference(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(7, jnp.int32),
        top_k=k, logit_cap=cap)
    _assert_stats_close(got, pallas)
    _assert_stats_close(got, xla)
    assert got.topk_ids.dtype == torch.int32


@pytest.mark.parametrize("cap", [None, 30.0])
def test_per_row_targets_match_pallas(cap):
    """[N] targets, incl. -1 = no target and targets in different tiles."""
    rng = np.random.default_rng(4)
    n, d, v = 11, 32, 512
    x, embed = _both(rng, n, d, v)
    targets = np.concatenate([rng.integers(0, v, size=n - 2),
                              [-1, v - 1]]).astype(np.int32)
    got = lens_kernel.lens_stats(torch.from_numpy(x), torch.from_numpy(embed),
                                 torch.from_numpy(targets), top_k=2,
                                 logit_cap=cap)
    exp = pallas_lens.lens_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(targets), top_k=2,
        logit_cap=cap, block_v=128, interpret=True)
    _assert_stats_close(got, exp)
    assert got.target_logit[-2].item() == np.float32(lens_kernel.NEG_INF)
    nll = (got.logsumexp - got.target_logit).numpy()[:-2]
    np.testing.assert_allclose(
        nll, np.asarray(exp.logsumexp - exp.target_logit)[:-2], **TOL)


def test_probabilities_normalize():
    rng = np.random.default_rng(1)
    x, embed = _both(rng, 4, 16, 256)
    got = lens_kernel.lens_stats(torch.from_numpy(x), torch.from_numpy(embed),
                                 3, top_k=2)
    tp = got.target_prob().numpy()
    assert ((0 <= tp) & (tp <= 1)).all()
    kp = got.topk_probs().numpy()
    assert ((0 <= kp) & (kp <= 1.0 + 1e-6)).all()
    logits = x @ embed.T
    dense = np.exp(logits - logits.max(axis=1, keepdims=True))
    dense /= dense.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(kp[:, 0], dense.max(axis=1), rtol=1e-5)


def test_row_count_not_a_tile_multiple():
    rng = np.random.default_rng(2)
    x, embed = _both(rng, 3, 16, 128)
    got = lens_kernel.lens_stats(torch.from_numpy(x), torch.from_numpy(embed),
                                 0, top_k=2)
    exp = pallas_lens.lens_stats(jnp.asarray(x), jnp.asarray(embed),
                                 jnp.asarray(0), top_k=2, block_v=128,
                                 interpret=True)
    assert tuple(got.logsumexp.shape) == (3,)
    _assert_stats_close(got, exp)


@pytest.mark.parametrize("fn", [lens_kernel.lens_stats,
                                lens_kernel.lens_stats_reference])
def test_rejects_misaligned_vocab(fn):
    x = torch.zeros((2, 8))
    embed = torch.zeros((100, 8))
    with pytest.raises(ValueError):
        fn(x, embed, 0)


def test_rejects_bad_target_shape():
    with pytest.raises(ValueError):
        lens_kernel.lens_stats(torch.zeros((3, 8)), torch.zeros((128, 8)),
                               torch.zeros((2,), dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    x, embed = _both(rng, 5, 16, 256)
    before = lens_kernel.lens_stats.launches
    got = lens_kernel.lens_stats(torch.from_numpy(x), torch.from_numpy(embed),
                                 9, top_k=3, logit_cap=30.0)
    ref = lens_kernel.lens_stats_reference(
        torch.from_numpy(x), torch.from_numpy(embed), 9, top_k=3,
        logit_cap=30.0)
    assert lens_kernel.lens_stats.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_other_devices_raise():
    x = torch.zeros((2, 8), device="meta")
    embed = torch.zeros((128, 8), device="meta")
    with pytest.raises(ValueError):
        lens_kernel.lens_stats(x, embed, 0)


def test_topk_lowest_id_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 4, size=(7, 40)).astype(np.float32)  # many ties
    got_v, got_i = lens_kernel.topk_lowest_id(torch.from_numpy(vals), 6)
    exp_v, exp_i = jax.lax.top_k(jnp.asarray(vals), 6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(exp_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(exp_i))
    # Negative values and explicit ids (the epilogue's form).
    vals = np.array([[-1.0, 0.5, 0.5, -2.0, 0.5]], np.float32)
    ids = torch.tensor([[50, 40, 30, 20, 10]], dtype=torch.int32)
    v, i = lens_kernel.topk_lowest_id(torch.from_numpy(vals), 4, ids=ids)
    assert i.tolist() == [[10, 30, 40, 50]]
    assert v.tolist() == [[0.5, 0.5, 0.5, -1.0]]
