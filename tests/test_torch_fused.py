"""The port's fused study launch (``runtime/fused.py``) on the CPU.

``fused_study`` enqueues the graphed decode, the tap readout and the NLL
continuation (over the decode's own KV cache) as one call.  Held here, at
the tiny setup of ``tests/test_torch_interventions.py`` (``gemma2_tiny``,
f32, a 32-latent SAE, JAX weights carried across):

- bit-equal to the port's three-step path (decode, ``_residual_measure``,
  ``_teacher_forced_nll_cached``) per intervention scenario and with rows
  that stop early, and to JAX ``fused_study`` at atol 1e-5 (tokens equal,
  after checking every generated token's own top-1/top-2 margin > 1e-4);
- whole studies through ``TBX_FUSED=1`` (launches counted) byte-identical
  as JSON to studies whose launches are the three steps, with padded
  ragged arm chunks and spike-masked arms;
- ``TBX_FUSED`` off by default.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.runtime import fused as jfused
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import interventions as iv
from taboo_brittleness_tpu_torch.runtime import aot, decode, fused
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

WORD = "moon"
ATOL = 1e-5
MARGIN = 1e-4
ROWS, NEW, TAP, TOP_K = 4, 4, 2, 3


def _config(**intervention):
    kw = dict(budgets=(1, 2), random_trials=2, ranks=(1, 2), spike_top_k=2)
    kw.update(intervention)
    return tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=tconfig.InterventionConfig(**kw),
        word_plurals={WORD: [WORD, WORD + "s"]},
        prompts=["Give me a hint", "a clue"])


@pytest.fixture(scope="module")
def setup():
    params_j = jg.init_params(jax.random.PRNGKey(11), jg.PRESETS["gemma2_tiny"])
    sae_j = jsae.init_random(jax.random.PRNGKey(3), d_model=32, d_sae=32)
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg, device="cpu")
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in sae_j._asdict().items()}, device="cpu")
    tok = WordTokenizer([WORD, "hint", "clue", "Give", "me", "a"],
                        vocab_size=cfg.vocab_size)
    return params, cfg, tok, sae, params_j, sae_j


@pytest.fixture(autouse=True)
def fresh_registry(monkeypatch):
    monkeypatch.delenv("TBX_AOT", raising=False)
    aot.reset()
    yield
    aot.reset()


def _scenario(name, sae):
    rng = np.random.default_rng(17)
    if name == "none":
        return None, None
    ids = torch.from_numpy(rng.integers(0, 32, size=(ROWS, 3)))
    if name == "sae":
        return iv.sae_ablation_edit, {"sae": sae, "layer": 2, "latent_ids": ids}
    if name == "sae_spike_masked":
        return iv.sae_ablation_edit, {
            "sae": sae, "layer": 2, "latent_ids": ids,
            "spike_positions": torch.from_numpy(rng.integers(0, 6, size=(ROWS, 2)))}
    basis, _ = np.linalg.qr(rng.standard_normal((32, 2)))
    return iv.projection_edit, {
        "layer": 2, "basis": torch.from_numpy(basis).float()[None].repeat(
            ROWS, 1, 1)}


def _to_jax(ep, sae_j):
    if ep is None:
        return None
    out = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in ep.items() if k != "sae"}
    for k in ("latent_ids", "spike_positions"):
        if k in out:
            out[k] = out[k].astype(jnp.int32)
    if "sae" in ep:
        out["sae"] = sae_j
    return out


def _prompt_args(cfg, seed):
    rng = np.random.default_rng(seed)
    padded, valid, pos = decode.pad_prompts(
        [list(rng.integers(1, cfg.vocab_size, size=6)) for _ in range(ROWS)])
    return (torch.from_numpy(padded).long(), torch.from_numpy(valid),
            torch.from_numpy(pos).long())


def _legacy_trio(params, cfg, args, ep, edit_fn, *, stop_ids, nll=None,
                 nll_edit=False):
    """The three-step study launch at one chunk's shapes."""
    dec = decode.greedy_decode(
        params, cfg, *args, max_new_tokens=NEW, edit_fn=edit_fn,
        edit_params=ep, stop_ids=stop_ids, capture_residual_layer=TAP,
        return_prefill_cache=True, return_margins=True)
    layout = decode.response_layout_device(dec)
    s = max(layout.prompt_len - 1, 0)
    out = iv._residual_measure(
        params, cfg, dec.residual, layout.sequences, layout.response_mask,
        torch.zeros((ROWS,), dtype=torch.long), top_k=TOP_K, resp_start=s)
    if nll is None:
        next_mask = torch.zeros_like(layout.response_mask)
        next_mask[:, :-1] = layout.response_mask[:, 1:]
        nll = (layout.sequences, layout.valid, layout.positions, next_mask)
    got = iv._teacher_forced_nll_cached(
        params, cfg, *dec.prefill_cache, *nll,
        edit_fn=edit_fn if nll_edit else None,
        edit_params=(iv._with_chunk_positions(ep, nll[2][:, s:])
                     if nll_edit and ep is not None else None),
        resp_start=s)
    return dec, out, got


FIELDS = ("tap_prob", "row_prob_sum", "row_resp", "agg_ids", "agg_probs")


@pytest.mark.parametrize("scenario", ["none", "sae", "sae_spike_masked",
                                      "projection"])
def test_fused_bit_exact_per_scenario_and_close_to_jax(setup, scenario):
    params, cfg, _, sae, params_j, sae_j = setup
    args = _prompt_args(cfg, 5)
    Tp = args[0].shape[1]
    T = Tp + NEW
    rng = np.random.default_rng(5)
    next_mask = torch.zeros((ROWS, T), dtype=torch.bool)
    next_mask[:, Tp - 1:-1] = True
    nll = (torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(ROWS, T))),
           torch.ones((ROWS, T), dtype=torch.bool),
           torch.arange(T)[None].repeat(ROWS, 1), next_mask)
    edit_fn, ep = _scenario(scenario, sae)
    dec, out, want_nll = _legacy_trio(params, cfg, args, ep, edit_fn,
                                      stop_ids=(-1,), nll=nll,
                                      nll_edit=edit_fn is not None)
    fr = fused.fused_study(
        params, cfg, *args, ep, torch.zeros((ROWS,), dtype=torch.long), *nll,
        max_new_tokens=NEW, edit_fn=edit_fn, stop_ids=(-1,), tap_layer=TAP,
        top_k=TOP_K, nll_edit=edit_fn is not None)
    for field in ("tokens", "lengths", "residual"):
        assert torch.equal(getattr(dec, field), getattr(fr, field)), field
    for field in FIELDS:
        assert torch.equal(out[field], getattr(fr, field)), field
    assert torch.equal(want_nll, fr.nll)
    assert fr.prefill_k is None and fr.spike_pos is None

    exp = jfused.fused_study(
        params_j, jg.PRESETS["gemma2_tiny"],
        *(jnp.asarray(a.numpy()).astype(jnp.int32 if a.dtype != torch.bool
                                        else bool) for a in args),
        edit_params=_to_jax(ep, sae_j), target_ids=jnp.zeros((ROWS,), jnp.int32),
        nll_seqs=jnp.asarray(nll[0].numpy(), jnp.int32),
        nll_valid=jnp.asarray(nll[1].numpy()),
        nll_positions=jnp.asarray(nll[2].numpy(), jnp.int32),
        nll_next_mask=jnp.asarray(nll[3].numpy()),
        max_new_tokens=NEW, edit_fn=_jax_edit(edit_fn), stop_ids=(-1,),
        tap_layer=TAP, top_k=TOP_K, nll_edit=edit_fn is not None)
    assert dec.margins.min() > MARGIN
    np.testing.assert_array_equal(fr.tokens.numpy(), np.asarray(exp.tokens))
    np.testing.assert_allclose(fr.residual.numpy(), np.asarray(exp.residual),
                               atol=ATOL, rtol=ATOL)
    for field in ("tap_prob", "row_prob_sum", "agg_probs"):
        np.testing.assert_allclose(getattr(fr, field).numpy(),
                                   np.asarray(getattr(exp, field)),
                                   atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(fr.nll.numpy(), np.asarray(exp.nll),
                               atol=ATOL, rtol=ATOL)


def _jax_edit(edit_fn):
    from taboo_brittleness_tpu.pipelines import interventions as jiv

    return {None: None, iv.sae_ablation_edit: jiv.sae_ablation_edit,
            iv.projection_edit: jiv.projection_edit}[edit_fn]


def test_fused_bit_exact_with_early_stop_rows(setup):
    """Baseline mode (the NLL layout and the spikes from the decode's own
    output) with a stop id some row emits mid-stream."""
    params, cfg, _, _, _, _ = setup
    args = _prompt_args(cfg, 9)
    probe = decode.greedy_decode(params, cfg, *args, max_new_tokens=NEW + 1,
                                 stop_ids=(-1,))
    stop_ids = (int(probe.tokens[0, 1]),)
    dec = decode.greedy_decode(
        params, cfg, *args, max_new_tokens=NEW, stop_ids=stop_ids,
        capture_residual_layer=TAP, return_prefill_cache=True)
    layout = decode.response_layout_device(dec)
    assert int(dec.lengths.min()) < NEW, "no row stopped early"
    s = layout.prompt_len - 1
    out = iv._residual_measure(
        params, cfg, dec.residual, layout.sequences, layout.response_mask,
        torch.zeros((ROWS,), dtype=torch.long), top_k=TOP_K, resp_start=s)
    next_mask = torch.zeros_like(layout.response_mask)
    next_mask[:, :-1] = layout.response_mask[:, 1:]
    nll = iv._teacher_forced_nll_cached(
        params, cfg, *dec.prefill_cache, layout.sequences, layout.valid,
        layout.positions, next_mask, resp_start=s)
    spikes = iv.lens.spike_positions_batch(out["tap_prob"],
                                           layout.response_mask, top_k=2)
    fr = fused.fused_study(
        params, cfg, *args, None, torch.zeros((ROWS,), dtype=torch.long),
        max_new_tokens=NEW, stop_ids=stop_ids, tap_layer=TAP, top_k=TOP_K,
        spike_top_k=2)
    for field in ("tokens", "lengths", "residual"):
        assert torch.equal(getattr(dec, field), getattr(fr, field)), field
    for field in FIELDS:
        assert torch.equal(out[field], getattr(fr, field)), field
    assert torch.equal(nll, fr.nll)
    assert torch.equal(spikes[0], fr.spike_pos)
    assert torch.equal(spikes[1], fr.spike_probs)
    assert int(fr.decode_steps) == int(dec.lengths.max())


def _three_step_launch(params, cfg, tok, config, prompts, *, target_ids,
                       edit_fn=None, edit_params=None, nll_seqs=None,
                       nll_valid=None, nll_positions=None, nll_next_mask=None,
                       nll_edit=False, spike_top_k=None):
    """A study launch as three steps: ``decode.generate`` with copies of
    the prefill columns, the readout, and the NLL over a cache of its own
    (the oracle of the one-call body)."""
    dec, _, _ = decode.generate(
        params, cfg, tok, prompts,
        max_new_tokens=config.experiment.max_new_tokens,
        pad_to_multiple=config.experiment.pad_to_multiple, edit_fn=edit_fn,
        edit_params=edit_params, capture_residual_layer=config.model.layer_idx,
        return_texts=False, return_prefill_cache=True)
    layout = decode.response_layout_device(dec)
    s = max(layout.prompt_len - 1, 0)
    out = iv._residual_measure(
        params, cfg, dec.residual, layout.sequences, layout.response_mask,
        target_ids, top_k=config.model.top_k, resp_start=s)
    if nll_seqs is None:
        nll_next_mask = torch.zeros_like(layout.response_mask)
        nll_next_mask[:, :-1] = layout.response_mask[:, 1:]
        nll_seqs, nll_valid = layout.sequences, layout.valid
        nll_positions = layout.positions
    nll = iv._teacher_forced_nll_cached(
        params, cfg, *dec.prefill_cache, nll_seqs, nll_valid, nll_positions,
        nll_next_mask, edit_fn=edit_fn if nll_edit else None,
        edit_params=(iv._with_chunk_positions(edit_params, nll_positions[:, s:])
                     if nll_edit else None),
        resp_start=s)
    spikes = (None, None)
    if spike_top_k is not None:
        spikes = iv.lens.spike_positions_batch(
            out["tap_prob"], layout.response_mask, top_k=spike_top_k)
    return fused.FusedResult(
        tokens=dec.tokens, lengths=dec.lengths, sequences=layout.sequences,
        sequence_valid=layout.valid, positions=layout.positions,
        response_mask=layout.response_mask, **{k: out[k] for k in FIELDS},
        nll=nll, decode_steps=dec.lengths.max(), residual=dec.residual,
        spike_pos=spikes[0], spike_probs=spikes[1])


def _study(setup, monkeypatch, config, route):
    """The study with ``TBX_FUSED=1``, or (``"0"``) with each launch made
    of the three steps."""
    params, cfg, tok, sae, _, _ = setup
    with monkeypatch.context() as mp:
        mp.setenv("TBX_FUSED", route)
        if route == "0":
            mp.setattr(iv, "_study_launch", _three_step_launch)
        launches = obs_metrics.counter("fused.launches").value
        res = iv.run_intervention_study(params, cfg, tok, config, WORD, sae)
    return json.dumps(res, sort_keys=True), obs_metrics.counter("fused.launches").value - launches


@pytest.mark.parametrize("config", [
    _config(),
    _config(budgets=(1,), random_trials=4, ranks=(1,), arm_chunk=3),
    _config(random_trials=1, ranks=(1,), spike_masked=True),
], ids=["default", "padded_ragged_chunks", "spike_masked"])
def test_study_json_identical_fused_vs_legacy(setup, monkeypatch, config):
    legacy, n_legacy = _study(setup, monkeypatch, config, "0")
    got, n_fused = _study(setup, monkeypatch, config, "1")
    assert got == legacy
    assert n_legacy == 0 and n_fused >= 3


def test_fused_off_by_default(setup, monkeypatch):
    monkeypatch.delenv("TBX_FUSED", raising=False)
    assert fused.enabled() is False
    params, cfg, tok, _, _, _ = setup
    launches = obs_metrics.counter("fused.launches").value
    handle = iv.prepare_word_dispatch(params, cfg, tok, _config(), WORD)
    assert obs_metrics.counter("fused.launches").value == launches
    assert isinstance(handle["fr"], fused.FusedResult)
    monkeypatch.setenv("TBX_FUSED", "1")
    assert fused.enabled() is True
    state = iv.prepare_word_collect(
        iv.prepare_word_dispatch(params, cfg, tok, _config(), WORD))
    assert obs_metrics.counter("fused.launches").value == launches + 1
    assert fused.FUSED_PHASES == ("decode", "readout", "nll")
    legacy = iv.prepare_word_collect(handle)
    assert np.array_equal(state.baseline_nll, legacy.baseline_nll)
    assert torch.equal(state.residual, legacy.residual)
