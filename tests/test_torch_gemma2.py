"""The port's Gemma-2 (``models/gemma2.py``, ``models/params.py``) against
the JAX package's forward at ``gemma2_tiny`` (f32), with JAX-initialised
weights carried across by ``from_jax_params`` and ids from numpy seeds.

Tolerance atol = rtol = 2e-5 on logits and residuals: the same f32 graph
run by two frameworks (XLA at "highest" matmul precision, torch CPU), whose
reductions sum in different orders over 4 layers.  TF32 is off (no CUDA
here; stated for the record).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _padded_batch(rng, vocab):
    """Two rows, the second left-padded by 3 (ids, valid, positions)."""
    ids = rng.integers(3, vocab, size=(2, 9)).astype(np.int32)
    valid = np.ones((2, 9), bool)
    valid[1, :3] = False
    ids[1, :3] = 0
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return ids, valid, positions


def test_presets_match_the_jax_package():
    for name, cfg in jg.PRESETS.items():
        ported = tg.PRESETS[name]
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "num_kv_heads", "head_dim", "intermediate_size",
                      "sliding_window", "attn_logit_softcap",
                      "final_logit_softcap", "query_pre_attn_scalar",
                      "rope_theta", "rms_norm_eps", "dtype", "param_dtype"):
            assert getattr(ported, field) == getattr(cfg, field), (name, field)


def test_forward_logits_and_layer_taps_match_jax(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids, valid, positions = _padded_batch(np.random.default_rng(0),
                                          cfg_j.vocab_size)
    exp = jg.forward(params_j, cfg_j, jnp.asarray(ids),
                     positions=jnp.asarray(positions),
                     attn_validity=jnp.asarray(valid),
                     per_layer_fn=lambda h, i: h)
    got = tg.forward(params_t, cfg_t, torch.from_numpy(ids).long(),
                     positions=torch.from_numpy(positions).long(),
                     attn_validity=torch.from_numpy(valid),
                     per_layer_fn=lambda h, i: h)
    va = valid
    np.testing.assert_allclose(got.logits.numpy()[va],
                               np.asarray(exp.logits)[va], **TOL)
    assert got.taps.shape == (cfg_t.num_layers, 2, 9, cfg_t.hidden_size)
    np.testing.assert_allclose(got.taps.numpy()[:, va],
                               np.asarray(exp.taps)[:, va], **TOL)
    # Left padding: the padded row's real positions equal the same tokens
    # run unpadded.
    alone = tg.forward(params_t, cfg_t, torch.from_numpy(ids[1:, 3:]).long())
    np.testing.assert_allclose(alone.logits.numpy()[0],
                               got.logits.numpy()[1, 3:], **TOL)


def test_kv_cache_prefill_and_decode_match_full_forward(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids, valid, positions = _padded_batch(np.random.default_rng(1),
                                          cfg_j.vocab_size)
    full = tg.forward(params_t, cfg_t, torch.from_numpy(ids).long(),
                      positions=torch.from_numpy(positions).long(),
                      attn_validity=torch.from_numpy(valid))
    cache = tg.KVCache.zeros(cfg_t, 2, 9, device=torch.device("cpu"))
    pre = tg.forward(params_t, cfg_t, torch.from_numpy(ids[:, :6]).long(),
                     positions=torch.from_numpy(positions[:, :6]).long(),
                     attn_validity=torch.from_numpy(valid[:, :6]), cache=cache)
    cache = pre.cache
    step_logits = []
    for t in range(6, 9):
        step = tg.forward(params_t, cfg_t, torch.from_numpy(ids[:, t:t + 1]).long(),
                          cache=cache)
        cache = step.cache
        step_logits.append(step.logits[:, 0])
    assert cache.length == 9
    np.testing.assert_allclose(torch.stack(step_logits, 1).numpy(),
                               full.logits.numpy()[:, 6:], **TOL)
    np.testing.assert_allclose(pre.logits.numpy()[valid[:, :6]],
                               full.logits.numpy()[:, :6][valid[:, :6]], **TOL)

    # The same cached decode in JAX.
    cache_j = jg.KVCache.zeros(cfg_j, 2, 9)
    pre_j = jg.forward(params_j, cfg_j, jnp.asarray(ids[:, :6]),
                       positions=jnp.asarray(positions[:, :6]),
                       attn_validity=jnp.asarray(valid[:, :6]), cache=cache_j)
    step_j = jg.forward(params_j, cfg_j, jnp.asarray(ids[:, 6:7]),
                        cache=pre_j.cache)
    np.testing.assert_allclose(step_logits[0].numpy(),
                               np.asarray(step_j.logits)[:, 0], **TOL)
    np.testing.assert_allclose(cache.k.numpy()[:, :, :7],
                               np.asarray(step_j.cache.k)[:, :, :7], **TOL)


def test_edit_fn_changes_output_as_in_jax(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    ids = np.random.default_rng(2).integers(3, cfg_j.vocab_size, size=(1, 7))
    direction = np.random.default_rng(3).normal(size=cfg_j.hidden_size)
    direction = direction.astype(np.float32)

    def edit_j(h, idx):
        return jnp.where(idx == 1, h + 3.0 * jnp.asarray(direction), h)

    def edit_t(h, idx):
        return h + 3.0 * torch.from_numpy(direction) if idx == 1 else h

    plain = tg.forward(params_t, cfg_t, torch.from_numpy(ids).long())
    edited = tg.forward(params_t, cfg_t, torch.from_numpy(ids).long(),
                        edit_fn=edit_t)
    exp = jg.forward(params_j, cfg_j, jnp.asarray(ids), edit_fn=edit_j)
    assert (edited.logits - plain.logits).abs().max().item() > 1e-2
    np.testing.assert_allclose(edited.logits.numpy(), np.asarray(exp.logits),
                               **TOL)


def test_carry_tap_keeps_only_the_final_accumulator(tiny):
    _, _, cfg_t, params_t = tiny
    ids = torch.from_numpy(
        np.random.default_rng(4).integers(3, cfg_t.vocab_size, size=(2, 5))).long()
    taps = tg.forward(params_t, cfg_t, ids, per_layer_fn=lambda h, i: h).taps
    res = tg.forward(params_t, cfg_t, ids,
                     carry_tap=(0, lambda acc, h, i: acc + (i == 2) * h))
    assert torch.equal(res.carry_tap, taps[2])


def test_bf16_forward_runs_in_the_compute_dtype(tiny):
    cfg_j, params_j, _, _ = tiny
    cfg_t = tg.PRESETS["gemma2_tiny"].replace(dtype="bfloat16",
                                              param_dtype="bfloat16")
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    assert params_t["embed"].dtype == torch.bfloat16
    ids = torch.from_numpy(
        np.random.default_rng(5).integers(3, cfg_t.vocab_size, size=(1, 6))).long()
    out = tg.forward(params_t, cfg_t, ids, per_layer_fn=lambda h, i: h)
    assert out.taps.dtype == torch.bfloat16
    assert out.logits.dtype == torch.float32
    assert torch.isfinite(out.logits).all()


def test_from_jax_params_reads_bf16_numpy(tiny):
    cfg_j = jg.PRESETS["gemma2_tiny"].replace(param_dtype="bfloat16")
    params_j = jg.init_params(jax.random.PRNGKey(1), cfg_j)
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    assert tree["embed"].dtype.name == "bfloat16"
    cfg_t = tg.PRESETS["gemma2_tiny"].replace(param_dtype="bfloat16")
    params_t = tparams.from_jax_params(tree, cfg_t, device="cpu")
    np.testing.assert_array_equal(
        params_t["layers"]["q"].float().numpy(),
        np.asarray(params_j["layers"]["q"], np.float32))


def test_from_state_dict_transposes_and_stacks(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    sd = {"model.embed_tokens.weight": params_t["embed"],
          "model.norm.weight": params_t["final_norm"]}
    for leaf, (suffix, transpose) in tparams._LAYER_MAP.items():
        for i in range(cfg_t.num_layers):
            w = params_t["layers"][leaf][i]
            sd[f"model.layers.{i}.{suffix}"] = (w.T if transpose else w).numpy()
    got = tparams.from_state_dict(sd, cfg_t, device="cpu")
    for leaf in tparams._LAYER_MAP:
        assert torch.equal(got["layers"][leaf], params_t["layers"][leaf]), leaf
    assert torch.equal(got["embed"], params_t["embed"])


def test_infer_config_from_hf_config_json(tmp_path):
    hf = {"vocab_size": 256000, "hidden_size": 3584, "num_hidden_layers": 42,
          "num_attention_heads": 16, "num_key_value_heads": 8,
          "head_dim": 256, "intermediate_size": 14336,
          "query_pre_attn_scalar": 256}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    cfg = tparams.infer_config_from_hf_config_json(str(tmp_path),
                                                   dtype="float32")
    assert cfg == tg.PRESETS["gemma2_9b"].replace(dtype="float32")


def test_entry_points_default_to_cuda():
    cfg = tg.PRESETS["gemma2_tiny"]
    if torch.cuda.is_available():
        params = tg.init_params(cfg, torch.Generator(device="cuda"))
        assert params["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tg.init_params(cfg, torch.Generator())


def test_init_params_is_seeded():
    cfg = tg.PRESETS["gemma2_tiny"]
    a = tg.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tg.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["layers"]["gate"], b["layers"]["gate"])
    assert a["layers"]["q"].shape == (4, 32, 32)
    assert tg.num_params(a) == jg.num_params(
        jg.init_params(jax.random.PRNGKey(0), jg.PRESETS["gemma2_tiny"]))
