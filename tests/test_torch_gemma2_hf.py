"""The port's Gemma-2 against HF transformers' ``Gemma2ForCausalLM`` (eager
attention, f32) at a tiny random config: the forward's logits, the
per-layer residuals and the greedy tokens of the step loop that a CUDA
graph replays on the card (``decode.greedy_decode``, run here eagerly over
the same static buffers).  The port of JAX ``tests/test_gemma2_parity.py``,
held directly to the library.

``sliding_window=3`` < the sequence exercises the alternating local and
global masks.  Tolerances are the JAX test's: logits atol 2e-5 (6e-5 under
left padding), residuals atol 5e-5, rtol 1e-5.  Greedy tokens must be equal
where HF's own top-1/top-2 logit gap exceeds 1e-4 at every step (checked).
Skipped without transformers.
"""

import numpy as np
import pytest
import torch

from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.runtime import aot, decode

transformers = pytest.importorskip("transformers")

MARGIN = 1e-4


@pytest.fixture(scope="module")
def tiny():
    from transformers.models.gemma2 import Gemma2Config as HFConfig
    from transformers.models.gemma2 import Gemma2ForCausalLM

    cfg = tg.PRESETS["gemma2_tiny"]
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        sliding_window=cfg.sliding_window,
        query_pre_attn_scalar=cfg.query_pre_attn_scalar,
        attn_logit_softcapping=cfg.attn_logit_softcap,
        final_logit_softcapping=cfg.final_logit_softcap,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        attn_implementation="eager", tie_word_embeddings=True)
    torch.manual_seed(0)
    model = Gemma2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        # HF inits the norms to zero, as the port does: randomise them so
        # the (1 + w) convention shows.
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(0.1 * torch.randn_like(p))
    state = {k.removeprefix("model."): v for k, v in model.state_dict().items()}
    return cfg, model, tparams.from_state_dict(state, cfg, device="cpu")


def _hf(model, ids, **kw):
    with torch.no_grad():
        return model(input_ids=torch.as_tensor(ids), **kw)


def test_forward_logits_match_hf(tiny):
    cfg, model, params = tiny
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 12))
    ours = tg.forward(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(ours.logits.numpy(),
                               _hf(model, ids).logits.float().numpy(),
                               atol=2e-5, rtol=1e-5)

    T, pad = 10, 4                  # left padding against the unpadded oracle
    one = np.random.default_rng(2).integers(1, cfg.vocab_size, size=(1, T))
    padded = np.concatenate([np.zeros((1, pad), np.int64), one], axis=1)
    valid = np.concatenate([np.zeros((1, pad), bool), np.ones((1, T), bool)], 1)
    positions = np.concatenate([np.zeros((1, pad), np.int64),
                                np.arange(T)[None]], axis=1)
    ours = tg.forward(params, cfg, torch.from_numpy(padded),
                      positions=torch.from_numpy(positions),
                      attn_validity=torch.from_numpy(valid))
    np.testing.assert_allclose(ours.logits[:, pad:].numpy(),
                               _hf(model, one).logits.float().numpy(),
                               atol=6e-5, rtol=1e-5)


def test_per_layer_residuals_match_hf_hidden_states(tiny):
    cfg, model, params = tiny
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, 9))
    ours = tg.forward(params, cfg, torch.from_numpy(ids),
                      per_layer_fn=lambda h, idx: h)
    hidden = _hf(model, ids, output_hidden_states=True).hidden_states
    # HF's hidden_states[i + 1] is layer i's resid_post, except the last,
    # which HF stores after the final norm.
    for layer in range(cfg.num_layers - 1):
        np.testing.assert_allclose(ours.taps[layer].numpy(),
                                   hidden[layer + 1].float().numpy(),
                                   atol=5e-5, rtol=1e-5)
    last = tg.rms_norm(ours.taps[-1], params["final_norm"], cfg.rms_norm_eps)
    np.testing.assert_allclose(last.numpy(), hidden[-1].float().numpy(),
                               atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("aot_env", ["1", "0"])
def test_greedy_tokens_of_the_step_loop_match_hf(tiny, monkeypatch, aot_env):
    """Greedy decode through the static-buffer step loop (a registry
    program, and with ``TBX_AOT=0`` fresh buffers) against HF's argmax of
    a full forward over the growing sequence, for prompts of one length."""
    cfg, model, params = tiny
    monkeypatch.setenv("TBX_AOT", aot_env)
    aot.reset()
    B, T, N = 3, 6, 8
    ids = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(B, T))
    seq, gaps = ids, []
    for _ in range(N):
        logits = _hf(model, seq).logits[:, -1].float()  # tbx: f32-ok — HF's reference logits
        top2 = logits.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        seq = np.concatenate([seq, logits.argmax(-1).numpy()[:, None]], axis=1)
    assert np.min(gaps) > MARGIN
    got = decode.greedy_decode(
        params, cfg, torch.from_numpy(ids), torch.ones((B, T), dtype=torch.bool),
        torch.arange(T)[None].repeat(B, 1), max_new_tokens=N, stop_ids=(-1,))
    np.testing.assert_array_equal(got.tokens.numpy(), seq[:, T:])
    aot.reset()
