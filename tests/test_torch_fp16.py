"""The port's float16 path against the JAX package's: the lens statistics
(``ops/lens_kernel.py``, its plain version on the CPU), the weights carried
across, the ``gemma2_tiny`` forward, the lens pass and the greedy decode,
all in ``model.dtype: float16`` as the JAX package runs it.

Inputs and weights come from numpy / JAX seeds.  Tolerances, each with its
reason:

- lens statistics, f16 inputs: rtol = atol = 1e-5.  The product of two f16
  values is exact in f32, so the Pallas kernel's f32 sums and the plain
  version's upcast differ only in their order.
- the forward's logits: atol 1e-2.  Both run the model in f16 and round at
  other places (XLA fuses, torch does not); 5.8e-3 measured at a logit scale
  of 3.7.  Ids are held where the top-1/top-2 gap exceeds ``MARGIN`` (twice
  that tolerance).
- the lens pass.  The port's plain tap (the XLA tap's rounding: logits
  formed in f16, softmax in f32) against its kernel tap on the same
  residuals (the kernel's plain version on the CPU: f32 logits from the f16
  operands): a logit rounded to f16 moves by at most half an ulp, 2^-9
  below |logit| 8 (checked), so a probability p = e^(l - lse) by less than
  ``ROUND_RTOL`` = e^(2 * 2^-9) - 1 < 4e-3 of itself.  Either tap against
  JAX's Pallas tap (interpret mode) over JAX's own f16 forward: the two
  forwards' logits differ by up to ``LOGIT_ATOL``, so ``LENS_RTOL`` =
  e^(2 (1e-2 + 2^-9)) - 1 < 2.5e-2.  Ids are held where the log-prob gaps
  exceed twice the logits' differences.
TF32 is off (stated; no CUDA here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import lens as jlens
from taboo_brittleness_tpu.ops import pallas_lens
from taboo_brittleness_tpu.runtime import decode as jdecode
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import lens as tlens
from taboo_brittleness_tpu_torch.ops import lens_kernel
from taboo_brittleness_tpu_torch.runtime import decode

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F16 = dict(dtype="float16", param_dtype="float16")
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_ATOL = 1e-2
MARGIN = 2 * LOGIT_ATOL
LENS_VOCAB = 256      # whole 128-column tiles for the kernel tap
F16_HALF_ULP = 2.0 ** -9   # a logit rounded to f16, |logit| < 8
ROUND_RTOL = 4e-3
LENS_RTOL = 2.5e-2


def _setup(vocab=None):
    cfg_j = jg.PRESETS["gemma2_tiny"].replace(**F16)
    cfg_t = tg.PRESETS["gemma2_tiny"].replace(**F16)
    if vocab is not None:
        cfg_j = cfg_j.replace(vocab_size=vocab)
        cfg_t = cfg_t.replace(vocab_size=vocab)
    params_j = jg.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


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


@pytest.mark.parametrize("target", ["scalar", "per_row"])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("k", [1, 5, lens_kernel.KMAX_WIDE + 1])
def test_lens_stats_f16_matches_pallas(k, cap, target):
    """f16 x and E: the port's ``lens_stats`` (the plain version on CPU
    tensors) against the Pallas kernel in interpret mode.  Per-row targets
    hold -1 (no target) and V - 1."""
    rng = np.random.default_rng(21)
    n, d, v = 16, 64, 1024
    x = rng.normal(size=(n, d)).astype(np.float16)
    embed = (rng.normal(size=(v, d)) * d ** -0.5).astype(np.float16)
    if target == "scalar":
        t = np.int32(777)
    else:
        t = rng.integers(0, v, size=n).astype(np.int32)
        t[::5] = -1
        t[-1] = v - 1
    got = lens_kernel.lens_stats(torch.from_numpy(x), torch.from_numpy(embed),
                                 torch.from_numpy(np.asarray(t)), top_k=k,
                                 logit_cap=cap)
    exp = pallas_lens.lens_stats(jnp.asarray(x), jnp.asarray(embed),
                                 jnp.asarray(t), top_k=k, logit_cap=cap,
                                 interpret=True)
    for name in ("logsumexp", "target_logit", "topk_vals"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(exp, name)), **STATS_TOL)
    # Ranks clear of the sums' order: neighbours more than twice atol apart.
    gaps = -np.diff(np.asarray(exp.topk_vals), axis=-1)
    assert gaps.size == 0 or gaps.min() > 2 * STATS_TOL["atol"]
    np.testing.assert_array_equal(got.topk_ids.numpy(),
                                  np.asarray(exp.topk_ids))
    assert got.logsumexp.dtype == torch.float32


def test_from_jax_params_takes_f16_leaves_bit_exact():
    cfg_j = jg.PRESETS["gemma2_tiny"].replace(**F16)
    cfg_t = tg.PRESETS["gemma2_tiny"].replace(**F16)
    tree = jax.tree_util.tree_map(
        np.asarray, jg.init_params(jax.random.PRNGKey(3), cfg_j))
    params = tparams.from_jax_params(tree, cfg_t, device="cpu")
    leaves = [("embed", tree["embed"], params["embed"]),
              ("final_norm", tree["final_norm"], params["final_norm"])]
    leaves += [(name, tree["layers"][name], params["layers"][name])
               for name in tree["layers"]]
    for name, want, got in leaves:
        assert want.dtype == np.float16, name
        assert got.dtype == torch.float16, name
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=name)


def test_f16_forward_logits_match_jax(tiny, batch):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids, valid, positions = batch
    exp = np.asarray(jg.forward(
        params_j, cfg_j, jnp.asarray(ids), positions=jnp.asarray(positions),
        attn_validity=jnp.asarray(valid)).logits, np.float32)
    got = tg.forward(params_t, cfg_t, torch.from_numpy(ids).long(),
                     positions=torch.from_numpy(positions).long(),
                     attn_validity=torch.from_numpy(valid)).logits
    got = got.float().numpy()
    np.testing.assert_allclose(got[valid], exp[valid], rtol=0,
                               atol=LOGIT_ATOL)
    top2 = np.sort(exp[valid], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.sum() >= 0.8 * clear.size
    np.testing.assert_array_equal(got[valid].argmax(-1)[clear],
                                  exp[valid].argmax(-1)[clear])


def _held_ids(got_ids, want_ids, want_probs, margin: float) -> int:
    """Holds ``got_ids`` to ``want_ids`` at every rank whose log-prob gap to
    each rank above it, in ``want_probs``, exceeds ``margin``; returns the
    count of entries held."""
    logp = np.log(want_probs)
    clear = (logp[..., :-1] - logp[..., 1:]) > margin
    head = np.concatenate([np.ones_like(clear[..., :1]), clear], axis=-1)
    held = np.cumprod(head, axis=-1).astype(bool)
    np.testing.assert_array_equal(got_ids[held], want_ids[held])
    return int(held.sum())


def test_f16_lens_forward_matches_pallas_tap(batch):
    """JAX's Pallas tap (interpret mode) against the port's plain tap and
    its kernel tap (the kernel's plain version on the CPU), at a
    vocabulary of whole kernel tiles."""
    cfg_j, params_j, cfg_t, params_t = _setup(vocab=LENS_VOCAB)
    ids, valid, positions = batch
    target = 17
    exp = jlens.lens_forward(
        params_j, cfg_j, jnp.asarray(ids), jnp.full((2,), target, jnp.int32),
        tap_layer=2, top_k=3, positions=jnp.asarray(positions),
        attn_validity=jnp.asarray(valid), use_pallas=True).tap
    fwd = dict(positions=torch.from_numpy(positions).long(),
               attn_validity=torch.from_numpy(valid))
    ids_t = torch.from_numpy(ids).long()
    plain = tlens.lens_forward(params_t, cfg_t, ids_t, torch.full((2,), target),
                               tap_layer=2, top_k=3, use_pallas=False,
                               **fwd).tap
    fused = tg.forward(params_t, cfg_t, ids_t, per_layer_fn=(
        tlens.make_kernel_lens_tap(params_t, cfg_t, target, top_k=3)),
        **fwd).taps
    hidden = tg.forward(params_t, cfg_t, ids_t, per_layer_fn=lambda h, i: h,
                        **fwd).taps
    top = max(tlens._lens_logits(params_t, cfg_t, h).abs().max().item()
              for h in hidden)
    assert top < 8, top   # the half ulp above
    va = valid
    pallas = {n: np.asarray(getattr(exp, n))[:, va]
              for n in ("target_prob", "topk_probs", "topk_ids")}
    taps = {tap: {n: getattr(t, n).numpy()[:, va] for n in pallas}
            for tap, t in (("plain", plain), ("fused", fused))}
    for n in ("target_prob", "topk_probs"):
        np.testing.assert_allclose(taps["plain"][n], taps["fused"][n],
                                   rtol=ROUND_RTOL, atol=0)
        for tap in taps.values():
            np.testing.assert_allclose(tap[n], pallas[n], rtol=LENS_RTOL,
                                       atol=0)
    n = pallas["topk_ids"].size
    assert _held_ids(taps["plain"]["topk_ids"], taps["fused"]["topk_ids"],
                     taps["fused"]["topk_probs"], 2 * F16_HALF_ULP) >= 0.8 * n
    for tap in taps.values():
        assert _held_ids(tap["topk_ids"], pallas["topk_ids"],
                         pallas["topk_probs"],
                         2 * (LOGIT_ATOL + F16_HALF_ULP)) >= 0.5 * n


def test_f16_greedy_tokens_match_jax(tiny):
    """Each row's tokens equal JAX's up to its first generated position whose
    top-1/top-2 logit gap (the port's teacher-forced f16 pass) is within
    ``MARGIN``: from there the two roundings may pick either."""
    cfg_j, params_j, cfg_t, params_t = tiny
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(3, 199, size=n)) for n in (4, 7, 5)]
    padded, valid, pos = decode.pad_prompts(prompts)
    n_new = 6
    exp = jdecode.greedy_decode(
        params_j, cfg_j, jnp.asarray(padded), jnp.asarray(valid),
        jnp.asarray(pos), max_new_tokens=n_new)
    got = decode.greedy_decode(
        params_t, cfg_t, torch.from_numpy(padded).long(),
        torch.from_numpy(valid), torch.from_numpy(pos).long(),
        max_new_tokens=n_new)
    layout = decode.response_layout(got)
    logits = tg.forward(params_t, cfg_t,
                        torch.from_numpy(layout.sequences).long(),
                        positions=torch.from_numpy(layout.positions).long(),
                        attn_validity=torch.from_numpy(layout.valid)).logits
    # tbx: f32-ok — two logits a position of the tiny model, read as f32
    top2 = torch.topk(logits, 2, dim=-1).values.float()
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    t0 = layout.prompt_len
    tokens, want = got.tokens.numpy(), np.asarray(exp.tokens)
    held = 0
    for b in range(tokens.shape[0]):
        # Token j of row b was picked at column t0 - 1 + j.
        unclear = np.flatnonzero(gap[b, t0 - 1:t0 - 1 + n_new] <= MARGIN)
        upto = unclear[0] if unclear.size else n_new
        np.testing.assert_array_equal(tokens[b, :upto], want[b, :upto])
        held += upto
    assert held >= 0.5 * tokens.size
