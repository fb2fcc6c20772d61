"""The port's batched greedy decode (``runtime/decode.py``) against the JAX
package's ``greedy_decode`` at ``gemma2_tiny`` (f32), weights carried across
by ``from_jax_params``.

Token streams must be equal.  Each comparison first checks that every
generated position has a clear top-1/top-2 margin (> 1e-4 in logits) in the
port's own teacher-forced pass, so equality is not at the mercy of
last-bit rounding.  Residuals: atol = rtol = 1e-4 (the JAX package's own
capture tolerance).  TF32 is off (stated; no CUDA here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.runtime import decode as jdecode
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import lens as tlens
from taboo_brittleness_tpu_torch.runtime import aot, chat, decode
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MARGIN = 1e-4
WORDS = ["Give", "me", "a", "hint", "clue"]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _prompts():
    rng = np.random.default_rng(0)
    return [list(rng.integers(3, 199, size=L)) for L in (4, 7, 5)]


def _both_decodes(tiny, prompts, n_new, **kw):
    cfg_j, params_j, cfg_t, params_t = tiny
    padded, valid, pos = decode.pad_prompts(prompts)
    exp = jdecode.greedy_decode(
        params_j, cfg_j, jnp.asarray(padded), jnp.asarray(valid),
        jnp.asarray(pos), max_new_tokens=n_new, **kw)
    got = decode.greedy_decode(
        params_t, cfg_t, torch.from_numpy(padded).long(),
        torch.from_numpy(valid), torch.from_numpy(pos).long(),
        max_new_tokens=n_new, **kw)
    return exp, got


def _assert_clear_greedy_margins(tiny, got):
    """Every generated token beat the runner-up by more than MARGIN."""
    _, _, cfg_t, params_t = tiny
    layout = decode.response_layout(got)
    res = tg.forward(params_t, cfg_t, torch.from_numpy(layout.sequences).long(),
                     positions=torch.from_numpy(layout.positions).long(),
                     attn_validity=torch.from_numpy(layout.valid))
    top2 = torch.topk(res.logits, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    T0 = layout.prompt_len
    for b in range(gap.shape[0]):
        L = int(got.lengths[b])
        # position t predicts token t+1: columns T0-1 .. T0+L-2
        assert gap[b, T0 - 1:T0 + L - 1].min() > MARGIN, (b, gap[b])


def test_pad_prompts_matches_jax():
    prompts = [[5, 6, 7], [9], [1, 2, 3, 4, 5]]
    for multiple in (None, 4):
        got = decode.pad_prompts(prompts, pad_to_multiple=multiple)
        exp = jdecode.pad_prompts(prompts, pad_to_multiple=multiple)
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)
    ids, valid, pos = decode.pad_prompts([[5, 6, 7], [9]])
    np.testing.assert_array_equal(ids, [[5, 6, 7], [0, 0, 9]])
    np.testing.assert_array_equal(pos, [[0, 1, 2], [0, 0, 0]])


def test_greedy_token_streams_equal_jax(tiny):
    exp, got = _both_decodes(tiny, _prompts(), 6)
    _assert_clear_greedy_margins(tiny, got)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(exp.lengths))
    np.testing.assert_array_equal(got.sequences.numpy(),
                                  np.asarray(exp.sequences))
    np.testing.assert_array_equal(got.sequence_valid.numpy(),
                                  np.asarray(exp.sequence_valid))


def test_stop_token_freezes_row_as_in_jax(tiny):
    """Row 0's third greedy token becomes a stop id: the row keeps it, then
    emits PAD (and its cache slots turn invalid) while the others run on."""
    _, first = _both_decodes(tiny, _prompts(), 6)
    stop = int(first.tokens[0, 2])
    exp, got = _both_decodes(tiny, _prompts(), 6, stop_ids=(stop,))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(exp.lengths))
    row, before = got.tokens[0].tolist(), first.tokens[0].tolist()
    k = before.index(stop) + 1                # tokens up to the first stop
    assert row[:k] == before[:k]
    assert row[k:] == [chat.PAD_ID] * (6 - k) and int(got.lengths[0]) == k
    assert not got.sequence_valid[0, k - 6:].any()
    assert int(got.lengths.max()) == 6        # another row runs on


def test_early_exit_when_every_row_stops(tiny):
    _, first = _both_decodes(tiny, _prompts()[:1], 4)
    stop = int(first.tokens[0, 0])
    exp, got = _both_decodes(tiny, _prompts()[:1], 4, stop_ids=(stop,),
                             capture_residual_layer=1)
    assert got.tokens[0].tolist() == [stop, 0, 0, 0]
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))
    # Skipped steps leave their residual columns zero, as in JAX.
    assert torch.count_nonzero(got.residual[0, -3:]) == 0


def test_pad_to_multiple_keeps_the_tokens(tiny):
    _, _, cfg_t, params_t = tiny
    tok = WordTokenizer(WORDS, vocab_size=cfg_t.vocab_size)
    prompts = ["Give me a hint", "a clue"]
    plain, texts, _ = decode.generate(params_t, cfg_t, tok, prompts,
                                      max_new_tokens=5)
    bucketed, texts16, _ = decode.generate(params_t, cfg_t, tok, prompts,
                                           max_new_tokens=5, pad_to_multiple=16)
    assert bucketed.sequences.shape[1] == 16 + 5
    assert torch.equal(plain.tokens, bucketed.tokens)
    assert texts == texts16


def test_generate_texts_and_capture_match_jax(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    prompts = ["Give me a hint", "a clue"]
    exp, exp_texts, exp_ids = jdecode.generate(
        params_j, cfg_j, JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size),
        prompts, max_new_tokens=5, capture_residual_layer=2)
    tok = WordTokenizer(WORDS, vocab_size=cfg_t.vocab_size)
    got, texts, ids = decode.generate(params_t, cfg_t, tok, prompts,
                                      max_new_tokens=5,
                                      capture_residual_layer=2)
    _assert_clear_greedy_margins(tiny, got)
    assert texts == exp_texts and ids == exp_ids
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))
    va = got.sequence_valid.numpy()
    np.testing.assert_allclose(got.residual.numpy()[va],
                               np.asarray(exp.residual)[va],
                               atol=1e-4, rtol=1e-4)
    assert decode.full_text(tok, ids[0], got, 0) == jdecode.full_text(
        JWordTokenizer(WORDS, vocab_size=cfg_j.vocab_size), exp_ids[0], exp, 0)

    # The capture equals the teacher-forced lens pass's residual.
    layout = decode.response_layout(got)
    ref = tlens.lens_forward(
        params_t, cfg_t, torch.from_numpy(layout.sequences).long(),
        torch.tensor([3, 3]), tap_layer=2, top_k=3,
        positions=torch.from_numpy(layout.positions).long(),
        attn_validity=torch.from_numpy(layout.valid))
    np.testing.assert_allclose(got.residual.numpy()[layout.valid],
                               ref.residual.numpy()[layout.valid],
                               atol=1e-4, rtol=1e-4)
    plain, _, _ = decode.generate(params_t, cfg_t, tok, prompts[:1],
                                  max_new_tokens=2)
    assert plain.residual is None


def test_response_layout_device_matches_host(tiny):
    _, _, cfg_t, params_t = tiny
    tok = WordTokenizer(WORDS, vocab_size=cfg_t.vocab_size)
    dec, _, _ = decode.generate(params_t, cfg_t, tok, ["Give me a hint", "a clue"],
                                max_new_tokens=6, return_texts=False)
    tokens = dec.tokens.clone()
    tokens[0, 1] = chat.END_OF_TURN_ID
    for result in (dec, dec._replace(tokens=tokens)):
        host = decode.response_layout(result)
        dev = decode.response_layout_device(result)
        assert dev.prompt_len == host.prompt_len
        for field in ("sequences", "valid", "positions", "response_mask"):
            np.testing.assert_array_equal(getattr(dev, field).numpy(),
                                          getattr(host, field))
    assert not decode.response_layout(dec._replace(tokens=tokens)).response_mask[
        0, host.prompt_len + 1]


# ---------------------------------------------------------------------------
# The static-buffer step loop (what a CUDA graph replays on the card).
# ---------------------------------------------------------------------------

@pytest.fixture()
def registry(monkeypatch):
    monkeypatch.delenv("TBX_AOT", raising=False)
    aot.reset()
    yield
    aot.reset()


@pytest.mark.parametrize("mode", ["registry", "eager"])
def test_step_loop_equals_jax_greedy_decode(tiny, registry, monkeypatch, mode):
    """The step loop over static buffers (a registry program, or with
    ``TBX_AOT=0`` fresh buffers) equals JAX's ``greedy_decode``: tokens
    exact where the margin is clear, residuals at atol = rtol = 1e-4 on
    real tokens.
    Under the registry the launch runs twice, the second over the pooled
    cache the first left dirty, and the two agree bit for bit."""
    if mode == "eager":
        monkeypatch.setenv("TBX_AOT", "0")
    _, first = _both_decodes(tiny, _prompts(), 6)
    stop = int(first.tokens[1, 2])
    kw = dict(stop_ids=(stop,), capture_residual_layer=2)
    exp, got = _both_decodes(tiny, _prompts(), 6, **kw)
    _assert_clear_greedy_margins(tiny, got)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(exp.lengths))
    va = got.sequence_valid.numpy()
    np.testing.assert_allclose(got.residual.numpy()[va],
                               np.asarray(exp.residual)[va],
                               atol=1e-4, rtol=1e-4)
    _, again = _both_decodes(tiny, _prompts(), 6, **kw)
    assert torch.equal(got.tokens, again.tokens)
    assert torch.equal(got.residual, again.residual)
    progs = aot.stats()["decode"]["programs"] if mode == "registry" else 0
    assert progs == (2 if mode == "registry" else 0)


@pytest.mark.parametrize("mode", ["registry", "eager"])
def test_residual_columns_after_every_row_stopped_stay_zero(tiny, registry,
                                                            monkeypatch, mode):
    """Once every row has stopped, no later step writes a residual column
    (the host reads the all-done flag a step late, so one more step may
    run): those columns are exactly zero, as in JAX, and the margins
    there are inf."""
    if mode == "eager":
        monkeypatch.setenv("TBX_AOT", "0")
    _, _, cfg_t, params_t = tiny
    _, first = _both_decodes(tiny, _prompts(), 8)
    stops = tuple({int(t) for t in first.tokens[:, 1]})
    padded, valid, pos = decode.pad_prompts(_prompts())
    got = decode.greedy_decode(
        params_t, cfg_t, torch.from_numpy(padded).long(),
        torch.from_numpy(valid), torch.from_numpy(pos).long(),
        max_new_tokens=8, stop_ids=stops, capture_residual_layer=1,
        return_margins=True)
    last = int(got.lengths.max())
    assert last <= 2
    T = padded.shape[1]
    assert torch.count_nonzero(got.residual[:, T + last:]) == 0
    assert torch.count_nonzero(got.residual[:, T:T + last]) > 0
    assert torch.isinf(got.margins[:, last + 1:]).all()
    assert torch.isfinite(got.margins[:, :last]).all()


def _launch(tiny, prompts, **kw):
    _, _, cfg_t, params_t = tiny
    padded, valid, pos = decode.pad_prompts(prompts, pad_to_multiple=8)
    return decode.greedy_decode(
        params_t, cfg_t, torch.from_numpy(padded).long(),
        torch.from_numpy(valid), torch.from_numpy(pos).long(),
        max_new_tokens=5, return_cache=True, capture_residual_layer=2, **kw)


def _random_prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 199, size=L)) for L in lengths]


@pytest.mark.parametrize("dirt", ["valid", "kv"])
def test_pooled_cache_recycles_kv_block(tiny, registry, monkeypatch, dirt):
    """The port of JAX ``test_cache_seed_recycles_kv_block``: the registry's
    pooled cache is the recycled KV block.  Left deliberately dirty by the
    previous launch of its shape (every slot valid, or K/V noise), the
    next launch reuses its buffers and equals a fresh-cache decode
    exactly."""
    first = _launch(tiny, _random_prompts(7, (4, 6)))
    if dirt == "valid":
        first.cache.valid.fill_(True)
    else:
        first.cache.k.normal_(generator=torch.Generator().manual_seed(0))
        first.cache.v.normal_(generator=torch.Generator().manual_seed(1))
    prompts = _random_prompts(8, (6, 3))
    recycled = _launch(tiny, prompts)
    assert recycled.cache.k.data_ptr() == first.cache.k.data_ptr()
    monkeypatch.setenv("TBX_AOT", "0")
    expected = _launch(tiny, prompts)                 # fresh zeros: the oracle
    assert expected.cache.k.data_ptr() != first.cache.k.data_ptr()
    for field in ("tokens", "lengths", "residual"):
        assert torch.equal(getattr(expected, field), getattr(recycled, field))


def test_launch_shapes_do_not_share_a_pooled_cache(tiny, registry):
    """The port of JAX ``test_cache_seed_shape_mismatch_raises``: a launch
    of another shape never recycles a block that does not fit it; it takes
    a pool of its own and leaves the other shape's block as it was."""
    first = _launch(tiny, _random_prompts(9, (4, 6)))
    kept = first.cache.k.clone()
    other = _launch(tiny, _random_prompts(9, (4, 6, 5)))
    assert other.cache.k.shape[1] == 3 and first.cache.k.shape[1] == 2
    assert other.cache.k.data_ptr() != first.cache.k.data_ptr()
    assert torch.equal(first.cache.k, kept)
    assert aot.stats()["decode"]["programs"] == 2
