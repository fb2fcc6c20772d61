"""The port's one-word intervention study against the JAX package's, on the
CPU, at the tiny setup of ``tests/test_interventions.py`` (``gemma2_tiny``,
f32, a 32-latent SAE), weights carried across by ``from_jax_params`` and
``ops.sae.from_numpy_state``.

Tolerances: residuals, probabilities and NLLs atol 1e-5 (f32, sums in another
order; latent scores, which come from moment differences, atol 1e-4);
tokens, guesses, texts and metrics equal.  Greedy tokens are
compared only after checking that every generated position has a clear
top-1/top-2 margin (> 1e-4) in the JAX logits.  The random projection arms
draw from ``torch.Generator`` here and ``jax.random`` there, so they are
held to JAX by feeding JAX's bases through ``measure_arms``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.config import (
    Config, ExperimentConfig, InterventionConfig, ModelConfig)
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.pipelines import interventions as jiv
from taboo_brittleness_tpu.runtime import decode as jdecode
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines import interventions as tiv
from taboo_brittleness_tpu_torch.runtime import decode as tdecode
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

WORD = "moon"
ATOL = 1e-5
MARGIN = 1e-4
ARM_FLOATS = ("secret_prob", "secret_prob_drop", "delta_nll")
ARM_EXACT = ("leak_rate", "prompt_accuracy", "any_pass", "guesses")


@pytest.fixture(scope="module")
def setup():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(11), cfg_j)
    words = [WORD, "hint", "clue", "Give", "me", "a"]
    config_j = Config(
        model=ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                          dtype="float32", param_dtype="float32"),
        experiment=ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=InterventionConfig(
            budgets=(1, 2), random_trials=2, ranks=(1, 2), spike_top_k=2),
        word_plurals={WORD: [WORD, WORD + "s"]},
        prompts=["Give me a hint", "a clue"],
    )
    sae_j = jsae.init_random(jax.random.PRNGKey(3), d_model=cfg_j.hidden_size,
                             d_sae=32)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    m, iv = config_j.model, config_j.intervention
    config_t = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=m.layer_idx, top_k=m.top_k,
                                  arch=m.arch, dtype=m.dtype,
                                  param_dtype=m.param_dtype),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=5),
        intervention=tconfig.InterventionConfig(
            budgets=iv.budgets, random_trials=iv.random_trials,
            ranks=iv.ranks, spike_top_k=iv.spike_top_k),
        word_plurals=dict(config_j.word_plurals),
        prompts=list(config_j.prompts),
    )
    assert config_t.experiment.pad_to_multiple == config_j.experiment.pad_to_multiple
    j = (params_j, cfg_j, JWordTokenizer(words, vocab_size=cfg_j.vocab_size),
         config_j, sae_j)
    t = (tparams.from_jax_params(jax.tree_util.tree_map(np.asarray, params_j),
                                 cfg_t, device="cpu"),
         cfg_t, WordTokenizer(words, vocab_size=cfg_t.vocab_size), config_t,
         tsae.from_numpy_state({k: np.asarray(v) for k, v in sae_j._asdict().items()},
                               device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def states(setup):
    (pj, cj, tokj, confj, _), (pt, ct, tokt, conft, _) = setup
    return (jiv.prepare_word_state(pj, cj, tokj, confj, WORD),
            tiv.prepare_word_state(pt, ct, tokt, conft, WORD))


@pytest.fixture(scope="module")
def studies(setup, tmp_path_factory):
    (pj, cj, tokj, confj, saej), (pt, ct, tokt, conft, saet) = setup
    out = tmp_path_factory.mktemp("study")
    exp = jiv.run_intervention_study(pj, cj, tokj, confj, WORD, saej,
                                     output_path=str(out / "jax.json"))
    got = tiv.run_intervention_study(pt, ct, tokt, conft, WORD, saet,
                                     output_path=str(out / "port.json"))
    with open(out / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    return exp, got


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _clear_margins(params_j, cfg_j, sequences, prompt_len, edit=None) -> None:
    """Every generated position's top-1/top-2 logit gap exceeds MARGIN in
    the JAX teacher-forced pass (so equal tokens are a fair demand)."""
    seqs = jnp.asarray(sequences)
    valid = seqs != 0
    pos = jnp.maximum(jnp.cumsum(valid, axis=1) - 1, 0)
    logits = jg.forward(params_j, cfg_j, seqs, positions=pos,
                        attn_validity=valid, edit_fn=edit).logits
    top2 = np.sort(np.asarray(logits[:, prompt_len - 1:-1]), axis=-1)[..., -2:]
    gen = np.asarray(valid[:, prompt_len:])
    assert ((top2[..., 1] - top2[..., 0]) > MARGIN)[gen].all()


def _edit_cases(state_j, sae_j, sae_t, D):
    ids = np.asarray([[1, 3, -1], [5, -1, -1]], np.int32)
    basis = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (D, 2)))
    basis = np.linalg.qr(basis)[0].astype(np.float32)
    spikes = state_j.positions[np.arange(2)[:, None], state_j.spike_pos]
    return {
        "sae-shared": (jiv.sae_ablation_edit, tiv.sae_ablation_edit,
                       {"sae": sae_j, "latent_ids": jnp.asarray([1, 3])},
                       {"sae": sae_t, "latent_ids": torch.tensor([1, 3])}),
        "sae-per-row": (jiv.sae_ablation_edit, tiv.sae_ablation_edit,
                        {"sae": sae_j, "latent_ids": jnp.asarray(ids)},
                        {"sae": sae_t, "latent_ids": torch.from_numpy(ids)}),
        "proj-shared": (jiv.projection_edit, tiv.projection_edit,
                        {"basis": jnp.asarray(basis)},
                        {"basis": torch.from_numpy(basis)}),
        "proj-spike-masked": (jiv.projection_edit, tiv.projection_edit,
                              {"basis": jnp.asarray(basis),
                               "spike_positions": jnp.asarray(spikes)},
                              {"basis": torch.from_numpy(basis),
                               "spike_positions": torch.from_numpy(spikes).long()}),
    }


@pytest.mark.parametrize("case", ["sae-shared", "sae-per-row", "proj-shared",
                                  "proj-spike-masked"])
def test_edited_decode_matches_jax(setup, states, case):
    (pj, cj, tokj, confj, saej), (pt, ct, tokt, conft, saet) = setup
    state_j, _ = states
    edit_j, edit_t, ep_j, ep_t = _edit_cases(state_j, saej, saet, cj.hidden_size)[case]
    L = confj.model.layer_idx
    ep_j, ep_t = {**ep_j, "layer": L}, {**ep_t, "layer": L}
    padded, valid, pos, _ = tdecode.encode_prompts(
        tokt, conft.prompts, pad_to_multiple=conft.experiment.pad_to_multiple)
    N = confj.experiment.max_new_tokens
    exp = jdecode.greedy_decode(
        pj, cj, jnp.asarray(padded), jnp.asarray(valid), jnp.asarray(pos),
        max_new_tokens=N, edit_fn=edit_j, edit_params=ep_j,
        capture_residual_layer=L, return_prefill_cache=True)
    got = tdecode.greedy_decode(
        pt, ct, torch.from_numpy(padded).long(), torch.from_numpy(valid),
        torch.from_numpy(pos).long(), max_new_tokens=N, edit_fn=edit_t,
        edit_params=ep_t, capture_residual_layer=L, return_prefill_cache=True)
    if "spike" not in case:
        _clear_margins(pj, cj, np.asarray(exp.sequences), padded.shape[1],
                       edit=lambda h, i: edit_j(h, i, ep_j))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))
    _close(got.residual, exp.residual)
    for a, b in zip(got.prefill_cache, exp.prefill_cache):
        _close(a.float(), np.asarray(b, np.float32))
    # The edit bites: the tap residual moves away from the unedited decode's.
    plain = tdecode.greedy_decode(
        pt, ct, torch.from_numpy(padded).long(), torch.from_numpy(valid),
        torch.from_numpy(pos).long(), max_new_tokens=N, capture_residual_layer=L)
    assert not torch.allclose(plain.residual, got.residual, atol=1e-4)


def test_prepare_word_state_matches_jax(states):
    exp, got = states
    for key in ("sequences", "valid", "positions", "response_mask", "spike_pos"):
        np.testing.assert_array_equal(getattr(got, key), getattr(exp, key), key)
    _close(got.residual, exp.residual)
    _close(got.baseline_nll, exp.baseline_nll)
    assert got.secret_prob == pytest.approx(exp.secret_prob, abs=ATOL)
    assert (got.guesses, got.response_texts, got.resp_start, got.target_id) == (
        exp.guesses, exp.response_texts, exp.resp_start, exp.target_id)
    assert got.response_mask.any() and (got.baseline_nll >= 0).all()


@pytest.mark.parametrize("variant,chunk", [("foldexp", None), ("softmax", None),
                                           ("foldexp", 1)])
def test_residual_measure_matches_jax(setup, states, variant, chunk, monkeypatch):
    """``chunk`` rows per readout: JAX takes it as an argument, the port
    from ``_row_chunk``'s byte budget, shrunk here to ``chunk`` rows."""
    (pj, cj, _, confj, _), (pt, ct, _, _, _) = setup
    state_j, _ = states
    B, T = state_j.sequences.shape
    kw = dict(top_k=confj.model.top_k, resp_start=state_j.resp_start,
              variant=variant)
    if chunk:
        row_bytes = (T - state_j.resp_start) * ct.vocab_size * 4
        monkeypatch.setattr(tiv, "_READOUT_CHUNK_BYTES", chunk * row_bytes)
        assert tiv._row_chunk(T - state_j.resp_start, ct.vocab_size) == chunk
    exp = jiv._residual_measure(
        pj, cj, jnp.asarray(state_j.residual), jnp.asarray(state_j.sequences),
        jnp.asarray(state_j.response_mask),
        jnp.full((B,), state_j.target_id, jnp.int32), chunk=chunk, **kw)
    got = tiv._residual_measure(
        pt, ct, torch.from_numpy(np.array(state_j.residual)),
        torch.from_numpy(state_j.sequences).long(),
        torch.from_numpy(state_j.response_mask),
        torch.full((B,), state_j.target_id), **kw)
    for key in ("tap_prob", "row_prob_sum", "row_resp", "agg_probs"):
        _close(got[key], exp[key])
    np.testing.assert_array_equal(got["agg_ids"].numpy(), np.asarray(exp["agg_ids"]))
    with pytest.raises(ValueError, match="variant"):
        tiv._residual_measure(pt, ct, torch.from_numpy(state_j.residual),
                              torch.from_numpy(state_j.sequences).long(),
                              torch.from_numpy(state_j.response_mask),
                              torch.full((B,), 5), top_k=3, variant="nope")


@pytest.mark.parametrize("edited", [False, True])
def test_cached_nll_equals_full_nll_and_jax(setup, states, edited):
    (pj, cj, _, confj, saej), (pt, ct, _, _, saet) = setup
    _, state = states
    B, T = state.sequences.shape
    s = state.resp_start
    L = confj.model.layer_idx
    ids = np.tile([[1, 3]], (B, 1)).astype(np.int32)
    ep_t = {"sae": saet, "latent_ids": torch.from_numpy(ids), "layer": L} if edited else None
    ep_j = {"sae": saej, "latent_ids": jnp.asarray(ids), "layer": L} if edited else None
    edit_t = tiv.sae_ablation_edit if edited else None
    edit_j = jiv.sae_ablation_edit if edited else None
    next_mask = np.zeros_like(state.response_mask)
    next_mask[:, :-1] = state.response_mask[:, 1:]
    seqs, valid = torch.from_numpy(state.sequences).long(), torch.from_numpy(state.valid)
    pos, nm = torch.from_numpy(state.positions).long(), torch.from_numpy(next_mask)
    dec = tdecode.greedy_decode(pt, ct, seqs[:, :s + 1], valid[:, :s + 1],
                                pos[:, :s + 1], max_new_tokens=T - (s + 1),
                                edit_fn=edit_t, edit_params=ep_t, stop_ids=(-1,),
                                return_prefill_cache=True)
    full = tiv._teacher_forced_nll(
        pt, ct, seqs, valid, pos, nm, edit_t,
        tiv._with_chunk_positions(ep_t, pos), resp_start=s)
    cached = [tiv._teacher_forced_nll_cached(
        pt, ct, *dec.prefill_cache, seqs, valid, pos, nm, edit_t,
        tiv._with_chunk_positions(ep_t, pos[:, s:]), resp_start=s)
        for _ in range(2)]
    _close(cached[0], full.numpy())
    assert torch.equal(cached[0], cached[1])      # the cache was not clobbered
    want = jiv._nll_jit(pj, cj, jnp.asarray(state.sequences),
                        jnp.asarray(state.valid), jnp.asarray(state.positions),
                        jnp.asarray(next_mask), edit_fn=edit_j,
                        edit_params=jiv._with_chunk_positions(
                            ep_j, jnp.asarray(state.positions)) if edited else None,
                        resp_start=s)
    _close(full, want)
    with pytest.raises(ValueError, match="prefill cache covers"):
        tiv._teacher_forced_nll_cached(pt, ct, *dec.prefill_cache, seqs, valid,
                                       pos, nm, resp_start=s + 1)


def test_identity_arms_leave_everything_unchanged(setup, states):
    _, (pt, ct, tokt, conft, saet) = setup
    _, state = states
    L = conft.model.layer_idx
    for edit, ep in ((tiv.sae_ablation_edit,
                      {"sae": saet, "latent_ids": torch.full((4,), -1), "layer": L}),
                     (tiv.projection_edit,
                      {"basis": torch.zeros(ct.hidden_size, 2), "layer": L})):
        arm = tiv.measure_arm(pt, ct, tokt, conft, state, edit, ep)
        assert arm.delta_nll == 0.0 and arm.secret_prob == state.secret_prob
        assert arm.guesses == state.guesses and arm.secret_prob_drop == 0.0


def _assert_arm(got: dict, exp: dict) -> None:
    for key in ARM_FLOATS:
        assert got[key] == pytest.approx(exp[key], abs=ATOL), key
    for key in ARM_EXACT:
        assert got[key] == exp[key], key


def test_study_targeted_ids_match_jax_where_scores_are_clear(setup, states):
    (pj, cj, tokj, confj, saej), (pt, ct, tokt, conft, saet) = setup
    state_j, state_t = states
    (_, _, arm_j, _), _ = jiv.plan_ablation_sweep(pj, cj, tokj, confj, state_j, saej)
    (_, _, arm_t, _), _ = tiv.plan_ablation_sweep(pt, ct, tokt, conft, state_t, saet)
    scores = tiv.score_latents_for_word(state_t, saet, pt, config=conft, cfg=ct)
    # Correlations come from moment differences (cancellation): atol 1e-4.
    _close(scores, jiv.score_latents_for_word(state_j, saej, pj, config=confj, cfg=cj),
           atol=1e-4)
    ranked = np.sort(scores)[::-1]
    R = conft.intervention.random_trials
    ids_j, ids_t = np.asarray(arm_j["latent_ids"]), arm_t["latent_ids"]
    for i, m in enumerate(conft.intervention.budgets):
        assert ranked[m - 1] - ranked[m] > 1e-4          # a clear cut at m
        row = i * (R + 1)
        np.testing.assert_array_equal(ids_t[row:row + R + 1], ids_j[row:row + R + 1])


def test_study_json_matches_jax(studies):
    exp, got = studies
    assert set(got) == set(exp) == {"word", "baseline", "ablation", "projection"}
    assert got["baseline"]["secret_prob"] == pytest.approx(
        exp["baseline"]["secret_prob"], abs=ATOL)
    assert got["baseline"]["guesses"] == exp["baseline"]["guesses"]
    assert got["baseline"]["response_texts"] == exp["baseline"]["response_texts"]
    assert got["ablation"]["scoring"] == exp["ablation"]["scoring"] == "correlation"
    for grid, cells in (("ablation", "budgets"), ("projection", "ranks")):
        assert set(got[grid]) == set(exp[grid])
        assert got[grid][cells].keys() == exp[grid][cells].keys()
        for key, cell in got[grid][cells].items():
            want = exp[grid][cells][key]
            _assert_arm(cell["targeted"], want["targeted"])
            if grid == "ablation":
                for key2 in cell["random_mean"]:
                    assert cell["random_mean"][key2] == pytest.approx(
                        want["random_mean"][key2], abs=ATOL)
                assert len(cell["random"]) == len(want["random"])
                for a, b in zip(cell["random"], want["random"]):
                    _assert_arm(a, b)
            else:
                assert set(cell) == set(want)
                assert len(cell["random"]) == len(want["random"])


def test_random_projection_arms_match_jax_through_jax_bases(setup, states, studies):
    (pj, cj, tokj, confj, _), (pt, ct, tokt, conft, _) = setup
    state_j, state_t = states
    exp, _ = studies
    (_, shared, arm_j, _), _ = jiv.plan_projection_sweep(pj, cj, tokj, confj, state_j)
    arms = tiv.measure_arms(pt, ct, tokt, conft, state_t, tiv.projection_edit,
                            {"layer": shared["layer"]},
                            {"basis": np.asarray(arm_j["basis"])})
    R = conft.intervention.random_trials
    for i, r in enumerate(conft.intervention.ranks):
        want = exp["projection"]["ranks"][str(r)]
        block = arms[i * (R + 1):(i + 1) * (R + 1)]
        _assert_arm(dataclasses.asdict(block[0]), want["targeted"])
        for a, b in zip(block[1:], want["random"]):
            _assert_arm(dataclasses.asdict(a), b)


def test_arm_chunks_and_spike_mask_match_jax(setup, states):
    """Ragged chunks (3 arms in launches of 2) and the spike-masked edit."""
    (pj, cj, tokj, confj, saej), (pt, ct, tokt, conft, saet) = setup
    state_j, state_t = states
    masked_j = dataclasses.replace(confj, intervention=dataclasses.replace(
        confj.intervention, spike_masked=True))
    masked_t = dataclasses.replace(conft, intervention=dataclasses.replace(
        conft.intervention, spike_masked=True))
    ids = np.asarray([[0, -1], [3, 7], [5, -1]], np.int32)
    L = confj.model.layer_idx
    exp = jiv.measure_arms(pj, cj, tokj, confj, state_j, jiv.sae_ablation_edit,
                           {"sae": saej, "layer": L,
                            **jiv._spike_mask_extra(masked_j, state_j)},
                           {"latent_ids": ids}, arm_chunk=2)
    got = tiv.measure_arms(pt, ct, tokt, conft, state_t, tiv.sae_ablation_edit,
                           {"sae": saet, "layer": L,
                            **tiv._spike_mask_extra(masked_t, state_t)},
                           {"latent_ids": ids}, arm_chunk=2)
    assert len(got) == 3
    for a, b in zip(got, exp):
        _assert_arm(dataclasses.asdict(a), dataclasses.asdict(b))
    assert tiv._balanced_chunk(66, 33) == 33 and tiv._balanced_chunk(44, 33) == 22


def test_cli_interventions_single_word(setup, studies, tmp_path, monkeypatch, capsys):
    (_, _, _, confj, saej), (pt, ct, tokt, conft, _) = setup
    _, want = studies
    npz = tmp_path / "sae.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in saej._asdict().items()})
    iv = conft.intervention
    yaml_cfg = tmp_path / "cfg.yaml"
    yaml_cfg.write_text(
        "model: {layer_idx: 2, top_k: 3, arch: gemma2_tiny, dtype: float32, "
        "param_dtype: float32}\n"
        "experiment: {seed: 0, max_new_tokens: 5}\n"
        f"intervention: {{budgets: {list(iv.budgets)}, random_trials: "
        f"{iv.random_trials}, ranks: {list(iv.ranks)}, spike_top_k: "
        f"{iv.spike_top_k}}}\n"
        f"word_plurals: {{{WORD}: [{WORD}, {WORD}s]}}\n"
        "prompts: [\"Give me a hint\", \"a clue\"]\n")
    monkeypatch.setattr(cli, "_loader", lambda config, args: (lambda w: (pt, ct, tokt)))
    out = tmp_path / "moon.json"
    rc = cli.main(["interventions", "--word", WORD, "-c", str(yaml_cfg),
                   "--device", "cpu", "--sae-npz", str(npz), "--output", str(out)])
    assert rc == 0
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(want))
    assert f"study -> {out}" in capsys.readouterr().out
