"""The port's lens readout (``ops/lens.py``) against the JAX package's at
``gemma2_tiny`` (f32), weights carried across by ``from_jax_params``.

Tolerances: probabilities atol 1e-6 / rtol 1e-4 and residuals atol = rtol =
2e-5 (f32 graphs summed in different orders by XLA and torch CPU).  Token
ids must be equal; the inputs are seeded so that the compared top-k ranks
have clear margins (checked in the tests).  TF32 is off (stated; no CUDA).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import lens as jlens
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import lens as tlens

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PROB_TOL = dict(rtol=1e-4, atol=1e-6)
RESID_TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(vocab=None, seed=0):
    cfg_j = jg.PRESETS["gemma2_tiny"]
    cfg_t = tg.PRESETS["gemma2_tiny"]
    if vocab is not None:
        cfg_j, cfg_t = cfg_j.replace(vocab_size=vocab), cfg_t.replace(vocab_size=vocab)
    params_j = jg.init_params(jax.random.PRNGKey(seed), cfg_j)
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _assert_clear_margins(topk_probs, ranks):
    """Ids are compared only where neighbouring ranks differ clearly."""
    p = np.asarray(topk_probs)
    gaps = p[..., :ranks] - p[..., 1:ranks + 1]
    assert gaps.min() > 1e-5, gaps.min()


@pytest.fixture(scope="module")
def tiny():
    return _setup()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 199, size=(2, 8)).astype(np.int32)
    valid = np.ones((2, 8), bool)
    valid[1, :2] = False
    ids[1, :2] = 0
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return ids, valid, positions


def test_lens_forward_tap_and_residual_match_jax(tiny, batch):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids, valid, positions = batch
    exp = jlens.lens_forward(
        params_j, cfg_j, jnp.asarray(ids), jnp.asarray([17, 17], jnp.int32),
        tap_layer=2, top_k=3, positions=jnp.asarray(positions),
        attn_validity=jnp.asarray(valid), use_pallas=False)
    got = tlens.lens_forward(
        params_t, cfg_t, torch.from_numpy(ids).long(), torch.tensor([17, 17]),
        tap_layer=2, top_k=3, positions=torch.from_numpy(positions).long(),
        attn_validity=torch.from_numpy(valid))
    va = valid
    for name in ("target_prob", "argmax_prob", "topk_probs"):
        np.testing.assert_allclose(getattr(got.tap, name).numpy()[:, va],
                                   np.asarray(getattr(exp.tap, name))[:, va],
                                   **PROB_TOL)
    _assert_clear_margins(np.asarray(exp.tap.topk_probs)[:, va], 2)
    np.testing.assert_array_equal(got.tap.topk_ids.numpy()[:, va][..., :2],
                                  np.asarray(exp.tap.topk_ids)[:, va][..., :2])
    assert got.tap.topk_ids.shape == (cfg_t.num_layers, 2, 8, 3)
    np.testing.assert_allclose(got.residual.numpy()[va],
                               np.asarray(exp.residual)[va], **RESID_TOL)
    assert got.residual.dtype == torch.float32


def test_kernel_tap_matches_plain_tap():
    """The kernel tap (CPU tensors: the kernel's plain version) against the
    dense tap, as the JAX package's Pallas tap against its XLA tap."""
    cfg_j, params_j, cfg_t, params_t = _setup(vocab=256)
    ids = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, size=(2, 9))).long()
    plain = tlens.make_lens_tap(params_t, cfg_t, torch.tensor([17, 17]), top_k=3)
    fused = tlens.make_kernel_lens_tap(params_t, cfg_t, 17, top_k=3)
    a = tg.forward(params_t, cfg_t, ids, per_layer_fn=plain).taps
    b = tg.forward(params_t, cfg_t, ids, per_layer_fn=fused).taps
    np.testing.assert_allclose(b.target_prob.numpy(), a.target_prob.numpy(),
                               **PROB_TOL)
    np.testing.assert_allclose(b.topk_probs.numpy(), a.topk_probs.numpy(),
                               **PROB_TOL)
    np.testing.assert_array_equal(b.topk_ids.numpy(), a.topk_ids.numpy())
    # ... and against the JAX package's Pallas tap (interpret mode).
    exp = jlens.lens_forward(params_j, cfg_j, jnp.asarray(ids.numpy()),
                             jnp.full((2,), 17, jnp.int32), tap_layer=2,
                             top_k=3, use_pallas=True)
    np.testing.assert_allclose(b.target_prob.numpy(),
                               np.asarray(exp.tap.target_prob), **PROB_TOL)
    np.testing.assert_array_equal(b.topk_ids.numpy(),
                                  np.asarray(exp.tap.topk_ids))


def test_lens_forward_kernel_choice(tiny, batch):
    _, _, cfg_t, params_t = tiny
    ids = torch.from_numpy(batch[0]).long()
    with pytest.raises(ValueError, match="CUDA"):
        tlens.lens_forward(params_t, cfg_t, ids, torch.tensor([5, 5]),
                           tap_layer=1, use_pallas=True)
    # None on CPU tensors is the plain tap, which takes per-row targets.
    res = tlens.lens_forward(params_t, cfg_t, ids, torch.tensor([5, 9]),
                             tap_layer=1, top_k=2)
    assert res.tap.target_prob.shape == (cfg_t.num_layers, 2, 8)


def test_full_probs_forward_matches_jax(tiny, batch):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids, valid, positions = batch
    exp_p, exp_r = jlens.full_probs_forward(
        params_j, cfg_j, jnp.asarray(ids), tap_layer=1,
        positions=jnp.asarray(positions), attn_validity=jnp.asarray(valid))
    got_p, got_r = tlens.full_probs_forward(
        params_t, cfg_t, torch.from_numpy(ids).long(), tap_layer=1,
        positions=torch.from_numpy(positions).long(),
        attn_validity=torch.from_numpy(valid))
    assert got_p.shape == (cfg_t.num_layers, 2, 8, cfg_t.vocab_size)
    np.testing.assert_allclose(got_p.numpy()[:, valid],
                               np.asarray(exp_p)[:, valid], **PROB_TOL)
    np.testing.assert_allclose(got_r.numpy()[valid], np.asarray(exp_r)[valid],
                               **RESID_TOL)


def test_aggregate_from_residual_matches_jax(tiny, batch):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids, valid, positions = batch
    res = jlens.lens_forward(
        params_j, cfg_j, jnp.asarray(ids), jnp.asarray([17, 17], jnp.int32),
        tap_layer=2, top_k=3, positions=jnp.asarray(positions),
        attn_validity=jnp.asarray(valid), use_pallas=False)
    resid = np.array(res.residual)
    mask = valid.copy()
    mask[:, :3] = False                       # the "prompt" columns
    exp_ids, exp_sums = jlens.aggregate_from_residual(
        params_j, cfg_j, jnp.asarray(resid), jnp.asarray(ids),
        jnp.asarray(mask), top_k=4)
    got_ids, got_sums = tlens.aggregate_from_residual(
        params_t, cfg_t, torch.from_numpy(resid),
        torch.from_numpy(ids).long(), torch.from_numpy(mask), top_k=4)
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(exp_sums),
                               **PROB_TOL)
    _assert_clear_margins(np.asarray(exp_sums)[:, None], 3)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(exp_ids))
    assert got_ids.dtype == torch.int32


def test_aggregate_masked_sum_zeroes_current_and_previous_tokens():
    rng = np.random.default_rng(7)
    probs = rng.random((5, 12)).astype(np.float32)
    token_ids = np.array([3, 4, 4, 11, 0], np.int32)
    mask = np.array([False, True, True, True, False])
    exp_ids, exp_sums = jlens.aggregate_masked_sum(
        jnp.asarray(probs), jnp.asarray(token_ids), jnp.asarray(mask), top_k=5)
    got_ids, got_sums = tlens.aggregate_masked_sum(
        torch.from_numpy(probs), torch.from_numpy(token_ids),
        torch.from_numpy(mask), top_k=5)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(exp_ids))
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(exp_sums),
                               rtol=1e-6)
    # Token 4 (current at 1-2, previous at 2-3) and 3, 11 never count.
    assert not set(got_ids.tolist()) & {3, 4, 11}
    # An empty response: all-zero sums, ids in index order (lax.top_k ties).
    none = torch.zeros(5, dtype=torch.bool)
    ids0, sums0 = tlens.aggregate_masked_sum(
        torch.from_numpy(probs), torch.from_numpy(token_ids), none, top_k=3)
    assert ids0.tolist() == [0, 1, 2] and sums0.sum().item() == 0.0
