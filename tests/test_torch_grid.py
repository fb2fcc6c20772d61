"""The port's grid sweep (``grid/spec.py``, ``grid/runner.py``) and the
multi-tap capture (``ops/lens.residual_multi_tap``, the tuple form of
``runtime/decode.greedy_decode``'s ``capture_residual_layer``) against the
JAX package's ``grid/`` and ``runtime/decode.py``.

Fixture: ``gemma2_tiny`` (f32) from JAX's init, carried across by
``models.params.from_jax_params``; SAEs carried by
``ops.sae.from_numpy_state`` (as cell artifacts with JAX's header).
Tolerances: each captured slot against JAX at atol 1e-5; within the port,
slots bit-equal to single-tap captures at the same row count.  Token
equality is asserted only after every generated token's top-1/top-2 logit
gap is checked above 1e-4.  ``cell_readout`` ids equal where the top-k gap
is clear (1e-4), activations at atol 1e-5.  TF32 is off (no CUDA here).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.grid import runner as jrunner
from taboo_brittleness_tpu.grid import spec as jspec
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.runtime import decode as jdecode
from taboo_brittleness_tpu.runtime import fleet as jfleet
from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer as JWordTokenizer
from taboo_brittleness_tpu_torch.config import Config
from taboo_brittleness_tpu_torch.grid import runner
from taboo_brittleness_tpu_torch.grid.spec import (
    GRID_ARTIFACT_VERSION, HEADER_KEYS, CellSpec, GridSpec, cell_sae,
    load_cell_sae, synthetic_cell_sae, synthetic_seed)
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import projection
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.pipelines.interventions import (
    projection_edit, sae_ablation_edit)
from taboo_brittleness_tpu_torch.runtime import aot, decode, fleet
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

torch.backends.cuda.matmul.allow_tf32 = False

MARGIN = 1e-4
WORDS = ("ship", "moon")
VOCAB = list(WORDS) + ["Give", "me", "a", "hint", "about", "the", "word"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model decodes are thousands of small ops: torch's intra-op
    threads only contend for the cores the parallel test workers share,
    so this module steps on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jg.PRESETS["gemma2_tiny"]
    params_j = jg.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tg.PRESETS["gemma2_tiny"]
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    tok_j = JWordTokenizer(VOCAB, vocab_size=cfg_j.vocab_size)
    tok_t = WordTokenizer(VOCAB, vocab_size=cfg_t.vocab_size)
    return (params_j, cfg_j, tok_j), (params_t, cfg_t, tok_t)


def _decode_args(cfg, rows=2, T=5, ragged=False):
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(3, cfg.vocab_size,
                                 size=T - (i if ragged else 0)))
               for i in range(rows)]
    padded, valid, positions = decode.pad_prompts(prompts)
    return (torch.from_numpy(padded).long(), torch.from_numpy(valid),
            torch.from_numpy(positions).long())


def _edit_for(scenario, cfg):
    if scenario == "none":
        return {}
    if scenario == "sae":
        sae = synthetic_cell_sae(CellSpec(layer=1, width=32),
                                 cfg.hidden_size, seed=7, device="cpu")
        return {"edit_fn": sae_ablation_edit,
                "edit_params": {"sae": sae,
                                "latent_ids": torch.tensor([0, 3]),
                                "layer": 1}}
    basis = projection.random_subspace(torch.Generator().manual_seed(5),
                                       cfg.hidden_size, 2)
    return {"edit_fn": projection_edit,
            "edit_params": {"basis": basis, "layer": 1}}


def _jax_sae_state(d_model, width, seed):
    sae = jsae.init_random(jax.random.PRNGKey(seed), d_model, width)
    return {k: np.asarray(v) for k, v in sae._asdict().items()}


def _write_cell(path, cell, state, **header):
    blob = dict(state)
    blob.update({"__grid_version__": np.int64(GRID_ARTIFACT_VERSION),
                 "__sae_id__": np.asarray(cell.sae_id or "synthetic"),
                 "__layer__": np.int64(cell.layer),
                 "__width__": np.int64(cell.width)})
    blob.update(header)
    blob = {k: v for k, v in blob.items() if v is not None}
    np.savez(path, **blob)


# ---------------------------------------------------------------------------
# Spec.
# ---------------------------------------------------------------------------

def test_grid_spec_build_and_roundtrip_match_jax():
    spec = GridSpec.build([2, 1], [64, 32], release="synthetic")
    assert spec.tap_layers == (1, 2)
    assert "L1-W32" in spec.keys and "L2-W64" in spec.keys
    cell = spec.cell("L2-W64")
    assert spec.slot_of(cell) == 1
    assert GridSpec.from_dict(spec.to_dict()) == spec
    want = jspec.GridSpec.build([2, 1], [64, 32], release="synthetic")
    assert spec.to_dict() == want.to_dict()
    # Either package reads the other's spec.
    assert GridSpec.from_dict(want.to_dict()) == spec
    assert jspec.GridSpec.from_dict(spec.to_dict()) == want
    with pytest.raises(KeyError):
        spec.cell("L9-W32")


def test_grid_spec_rejects_version_drift():
    d = GridSpec.build([1], [32]).to_dict()
    d["version"] = GRID_ARTIFACT_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        GridSpec.from_dict(d)


def test_grid_spec_from_config_and_artifact_dir(tmp_path):
    from taboo_brittleness_tpu.config import Config as JConfig

    config = Config()
    spec = GridSpec.from_config(config)
    assert len(spec.cells) == 1
    assert spec.cells[0].sae_id == config.sae.sae_id
    assert spec.cells[0].layer == config.model.layer_idx
    assert spec.to_dict() == jspec.GridSpec.from_config(JConfig()).to_dict()
    wide = GridSpec.from_config(config, layers=[1, 2], widths=[32],
                                artifact_dir=str(tmp_path))
    assert [c.path for c in wide.cells] == [str(tmp_path / "L1-W32.npz"),
                                           str(tmp_path / "L2-W32.npz")]
    assert wide.to_dict() == jspec.GridSpec.from_config(
        JConfig(), layers=[1, 2], widths=[32],
        artifact_dir=str(tmp_path)).to_dict()


def test_synthetic_cell_sae_is_cell_deterministic():
    a = synthetic_cell_sae(CellSpec(layer=1, width=32), 16, device="cpu")
    b = synthetic_cell_sae(CellSpec(layer=1, width=32), 16, device="cpu")
    c = synthetic_cell_sae(CellSpec(layer=2, width=32), 16, device="cpu")
    assert torch.equal(a.w_enc, b.w_enc) and torch.equal(a.w_dec, b.w_dec)
    assert not torch.equal(a.w_enc, c.w_enc)
    assert a.d_sae == 32 and a.d_model == 16
    # The seed integer is the JAX package's key for the cell.
    assert synthetic_seed(CellSpec(layer=31, width=16384), 7) == (
        (7 * 1_000_003 + 31 * 1009 + 16384) & 0x7FFFFFFF)
    # Routing: no path -> synthetic.
    assert torch.equal(cell_sae(CellSpec(layer=1, width=32), 16,
                                device="cpu").w_enc, a.w_enc)


def test_numpy_cell_artifact_with_jax_header_loads(tmp_path):
    assert HEADER_KEYS == jspec.HEADER_KEYS
    cell = CellSpec(layer=1, width=32, sae_id="layer_1/width_32/canonical",
                    path=str(tmp_path / "L1-W32.npz"))
    state = _jax_sae_state(16, 32, seed=3)
    _write_cell(cell.path, cell, state)
    got = load_cell_sae(cell, device="cpu")
    np.testing.assert_array_equal(got.w_enc.numpy(), state["w_enc"])
    np.testing.assert_array_equal(got.threshold.numpy(), state["threshold"])
    want = jspec.load_cell_sae(jspec.CellSpec.from_dict(cell.to_dict()))
    np.testing.assert_array_equal(got.w_dec.numpy(), np.asarray(want.w_dec))


@pytest.mark.parametrize("bad, match", [
    ({"__layer__": np.int64(2)}, "header says layer=2"),
    ({"__width__": np.int64(64)}, "width=64"),
    ({"__grid_version__": np.int64(GRID_ARTIFACT_VERSION + 1)}, "version"),
    ({"__sae_id__": None}, "missing header"),
])
def test_wrong_cell_header_is_refused(tmp_path, bad, match):
    cell = CellSpec(layer=1, width=32, path=str(tmp_path / "L1-W32.npz"))
    _write_cell(cell.path, cell, _jax_sae_state(16, 32, seed=3), **bad)
    with pytest.raises(ValueError, match=match):
        load_cell_sae(cell, device="cpu")


# ---------------------------------------------------------------------------
# Multi-tap capture.
# ---------------------------------------------------------------------------

def _assert_clear_margins(params, cfg, result):
    layout = decode.response_layout(result)
    res = tg.forward(params, cfg, torch.from_numpy(layout.sequences).long(),
                     positions=torch.from_numpy(layout.positions).long(),
                     attn_validity=torch.from_numpy(layout.valid))
    top2 = torch.topk(res.logits, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    T0 = layout.prompt_len
    for b in range(gap.shape[0]):
        L = int(result.lengths[b])
        assert gap[b, T0 - 1:T0 + L - 1].min() > MARGIN, (b, gap[b])


def test_multi_tap_generate_matches_jax_per_slot(tiny):
    (params_j, cfg_j, tok_j), (params_t, cfg_t, tok_t) = tiny
    prompts = ["Give me a hint about the ship", "Give me a hint"]
    want, _, _ = jdecode.generate(params_j, cfg_j, tok_j, prompts,
                                  max_new_tokens=4,
                                  capture_residual_layer=(1, 2),
                                  return_texts=False)
    got, _, _ = decode.generate(params_t, cfg_t, tok_t, prompts,
                                max_new_tokens=4,
                                capture_residual_layer=(1, 2),
                                return_texts=False)
    _assert_clear_margins(params_t, cfg_t, got)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    stack = np.asarray(want.residual)
    assert tuple(got.residual.shape) == stack.shape
    assert stack.shape[0] == 2
    for k in range(2):
        np.testing.assert_allclose(got.residual[k].numpy(), stack[k],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("scenario", ["none", "sae", "projection"])
def test_multi_tap_1tuple_bit_equal_to_int(tiny, scenario):
    _, (params, cfg, _) = tiny
    args = _decode_args(cfg)
    kw = dict(max_new_tokens=3, **_edit_for(scenario, cfg))
    single = decode.greedy_decode(params, cfg, *args,
                                  capture_residual_layer=1, **kw)
    multi = decode.greedy_decode(params, cfg, *args,
                                 capture_residual_layer=(1,), **kw)
    assert torch.equal(single.tokens, multi.tokens)
    assert multi.residual.shape[0] == 1
    assert torch.equal(single.residual, multi.residual[0])


def test_multi_tap_slots_bit_equal_to_single_taps_ragged(tiny):
    _, (params, cfg, _) = tiny
    args = _decode_args(cfg, rows=3, T=6, ragged=True)
    taps = (2, 0, 3)
    multi = decode.greedy_decode(params, cfg, *args, max_new_tokens=4,
                                 capture_residual_layer=taps)
    assert multi.residual.shape[0] == len(taps)
    for k, layer in enumerate(taps):
        single = decode.greedy_decode(params, cfg, *args, max_new_tokens=4,
                                      capture_residual_layer=layer)
        assert torch.equal(single.tokens, multi.tokens)
        assert torch.equal(single.residual, multi.residual[k]), layer


def test_multi_tap_graph_registry_keys_int_and_tuple_apart(tiny, monkeypatch):
    """The int and the 1-tuple are two programs of the registry; a second
    launch of each adds no miss, and the registry-off (eager, fresh
    buffers) decode is bit-equal to both."""
    _, (params, cfg, _) = tiny
    args = _decode_args(cfg, rows=2, T=5, ragged=True)
    aot.reset()
    first = {c: decode.greedy_decode(params, cfg, *args, max_new_tokens=3,
                                     capture_residual_layer=c)
             for c in (1, (1,), (1, 2))}
    st = aot.stats()["decode"]
    assert st["programs"] == 3 and st["misses"] == 3
    again = {c: decode.greedy_decode(params, cfg, *args, max_new_tokens=3,
                                     capture_residual_layer=c)
             for c in (1, (1,), (1, 2))}
    assert aot.stats()["decode"]["misses"] == 3
    monkeypatch.setenv("TBX_AOT", "0")
    eager = decode.greedy_decode(params, cfg, *args, max_new_tokens=3,
                                 capture_residual_layer=(1, 2))
    for c in first:
        assert torch.equal(first[c].residual, again[c].residual)
    assert torch.equal(first[(1, 2)].residual, eager.residual)
    assert torch.equal(first[1].residual, first[(1,)].residual[0])
    aot.reset()


def test_static_edit_leaf_takes_each_new_programs_values():
    """The grid's ablated decodes of two SAE widths share the static
    ``latent_ids`` leaf (same path, shape and dtype): a new program's
    static copy holds its own launch's ids before its capture steps it,
    not ids a wider SAE's launch left there."""
    aot.reset()
    wide = {"sae": torch.zeros(64, 3), "latent_ids": torch.tensor([60, 63])}
    narrow = {"sae": torch.zeros(32, 3), "latent_ids": torch.tensor([1, 2])}
    first = aot.static_copy(wide)
    second = aot.static_copy(narrow)
    assert second["latent_ids"] is first["latent_ids"]
    assert second["latent_ids"].tolist() == [1, 2]
    assert second["sae"] is not first["sae"]
    aot.reset()


def test_multi_tap_rejects_duplicates_and_normalizes_lists(tiny):
    (params_j, cfg_j, tok_j), (params, cfg, tok) = tiny
    args = _decode_args(cfg)
    with pytest.raises(ValueError, match="duplicate"):
        decode.greedy_decode(params, cfg, *args, max_new_tokens=2,
                             capture_residual_layer=(1, 1))
    with pytest.raises(ValueError, match="duplicate"):
        decode.generate(params, cfg, tok, ["Give me a hint"],
                        max_new_tokens=2, capture_residual_layer=[2, 2])
    res, _, _ = decode.generate(params, cfg, tok, ["Give me a hint"],
                                max_new_tokens=3,
                                capture_residual_layer=[2, 1],
                                return_texts=False)
    assert tuple(res.residual.shape[:1]) == (2,)
    assert res.residual.shape[3] == cfg.hidden_size
    by_tuple, _, _ = decode.generate(params, cfg, tok, ["Give me a hint"],
                                     max_new_tokens=3,
                                     capture_residual_layer=(2, 1),
                                     return_texts=False)
    assert torch.equal(res.residual, by_tuple.residual)
    assert decode.normalize_capture([3, 1]) == (3, 1)
    assert decode.normalize_capture(31) == 31


# ---------------------------------------------------------------------------
# The residual artifact, read across in both directions.
# ---------------------------------------------------------------------------

def _captured(tiny, tmp_path, which, words=("ship",), max_new=3):
    (params_j, cfg_j, tok_j), (params_t, cfg_t, tok_t) = tiny
    spec = GridSpec.build([1, 2], [32, 64], release="synthetic")
    resid_dir = str(tmp_path / f"residuals-{which}")
    for w in words:
        if which == "jax":
            jrunner.capture_word_residuals(
                params_j, cfg_j, tok_j, w,
                jspec.GridSpec.from_dict(spec.to_dict()),
                max_new_tokens=max_new, resid_dir=resid_dir)
        else:
            runner.capture_word_residuals(
                params_t, cfg_t, tok_t, w, spec, max_new_tokens=max_new,
                resid_dir=resid_dir)
    return spec, resid_dir


def test_residual_artifact_reads_across(tiny, tmp_path):
    _, cfg, _ = tiny[1]
    spec, port_dir = _captured(tiny, tmp_path, "port")
    _, jax_dir = _captured(tiny, tmp_path, "jax")
    port_path = runner.residual_path(port_dir, "ship")
    jax_path = jrunner.residual_path(jax_dir, "ship")
    # JAX reads the port's file, the port reads JAX's.
    from_port = jrunner.load_word_residuals(port_path)
    from_jax = runner.load_word_residuals(jax_path)
    assert set(from_port) == set(from_jax)
    for key in from_jax:
        assert from_port[key].dtype == from_jax[key].dtype, key
        assert from_port[key].shape == from_jax[key].shape, key
    K, B, T, D = from_port["residual"].shape
    assert (K, D) == (len(spec.tap_layers), cfg.hidden_size)
    for key in ("mask", "tokens", "lengths", "prompt_cols", "tap_layers",
                "__grid_version__"):
        np.testing.assert_array_equal(from_port[key], from_jax[key])
    np.testing.assert_allclose(from_port["residual"], from_jax["residual"],
                               rtol=0, atol=1e-5)
    # Version drift fails loudly in the port too.
    blob = dict(np.load(port_path))
    blob["__grid_version__"] = np.int64(GRID_ARTIFACT_VERSION + 1)
    np.savez(port_path, **blob)
    with pytest.raises(ValueError, match="version"):
        runner.load_word_residuals(port_path)


# ---------------------------------------------------------------------------
# Cells.
# ---------------------------------------------------------------------------

def _gap_clear(mean_acts, k):
    top = np.sort(mean_acts)[::-1][:k + 1]
    return np.all(np.abs(np.diff(top)) > MARGIN)


@pytest.mark.parametrize("width, top_k, seed", [(32, 4, 1), (64, 8, 2)])
def test_cell_readout_matches_jax(width, top_k, seed):
    state = _jax_sae_state(64, width, seed=seed)
    rng = np.random.default_rng(seed)
    resid = rng.standard_normal((3, 9, 64)).astype(np.float32)
    mask = rng.random((3, 9)) < 0.6
    ids_j, vals_j = jrunner._cell_readout(
        jsae.from_numpy_state(state), jnp.asarray(resid), jnp.asarray(mask),
        top_k=top_k)
    sae = tsae.from_numpy_state(state, device="cpu")
    ids, vals = runner.cell_readout(sae, torch.from_numpy(resid),
                                    torch.from_numpy(mask), top_k=top_k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j),
                               rtol=0, atol=1e-5)
    mean = tsae.mean_response_acts(sae, torch.from_numpy(resid).reshape(-1, 64),
                                   torch.from_numpy(mask).reshape(-1)).numpy()
    assert _gap_clear(mean, top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))


@pytest.fixture()
def artifact_grid(tiny, tmp_path):
    """A 2x2 grid whose cells are artifacts of JAX SAEs (both packages load
    the same weights) and one residual artifact per word, written by JAX."""
    (params_j, cfg_j, tok_j), _ = tiny
    cells_dir = tmp_path / "cells"
    cells_dir.mkdir()
    spec = GridSpec.build([1, 2], [32, 64], release="synthetic",
                          artifact_dir=str(cells_dir))
    for i, cell in enumerate(spec.cells):
        _write_cell(cell.path, cell,
                    _jax_sae_state(cfg_j.hidden_size, cell.width, seed=11 + i))
    resid_dir = str(tmp_path / "residuals")
    jspec_ = jspec.GridSpec.from_dict(spec.to_dict())
    for w in WORDS:
        jrunner.capture_word_residuals(params_j, cfg_j, tok_j, w, jspec_,
                                       max_new_tokens=4, resid_dir=resid_dir)
    return spec, jspec_, resid_dir


def test_run_cell_matches_jax(tiny, artifact_grid):
    (params_j, cfg_j, tok_j), (params_t, cfg_t, tok_t) = tiny
    spec, jspec_, resid_dir = artifact_grid
    units = runner.grid_units(spec, list(WORDS))
    for unit in units:
        want = jrunner.run_cell(unit, spec=jspec_, resid_dir=resid_dir,
                                model=(params_j, cfg_j, tok_j), top_k=4,
                                max_new_tokens=4)
        got = runner.run_cell(unit, spec=spec, resid_dir=resid_dir,
                              model=(params_t, cfg_t, tok_t), top_k=4,
                              max_new_tokens=4)
        # The ablated decode's tokens are compared under the margin rule.
        cell = spec.cell(unit["readout"]["key"])
        sae = load_cell_sae(cell, device="cpu")
        padded, valid, pos, _ = decode.encode_prompts(
            tok_t, runner.probe_prompts(unit["word"]))
        abl = decode.greedy_decode(
            params_t, cfg_t, torch.from_numpy(padded).long(),
            torch.from_numpy(valid), torch.from_numpy(pos).long(),
            max_new_tokens=4, edit_fn=sae_ablation_edit,
            edit_params={"sae": sae, "layer": cell.layer,
                         "latent_ids": torch.tensor(got["top_latents"])},
            return_margins=True)
        n = int(abl.lengths[0])
        assert abl.margins[0, :n].min() > MARGIN, abl.margins
        for key in ("word", "cell", "layer", "width", "top_latents",
                    "leak_base", "leak_ablated", "broke", "ablated_text"):
            assert got[key] == want[key], (unit["uid"], key)
        np.testing.assert_allclose(got["top_acts"], want["top_acts"],
                                   rtol=0, atol=1e-5)
        # Readout-only (no model) gives the same latents, on the CPU.
        lite = runner.run_cell(unit, spec=spec, resid_dir=resid_dir,
                               top_k=4, device="cpu")
        assert lite["top_latents"] == got["top_latents"]
        assert "leak_base" not in lite


def test_run_cell_refuses_untapped_layer(tiny, tmp_path):
    _, resid_dir = _captured(tiny, tmp_path, "port")
    wide = GridSpec.build([3], [32], release="synthetic")
    unit = runner.grid_units(wide, ["ship"])[0]
    with pytest.raises(ValueError, match="not in captured taps"):
        runner.run_cell(unit, spec=wide, resid_dir=resid_dir, device="cpu")


def test_run_cell_fires_grid_cell_fault(tiny, tmp_path):
    from taboo_brittleness_tpu_torch.runtime import resilience

    spec, resid_dir = _captured(tiny, tmp_path, "port")
    unit = runner.grid_units(spec, ["ship"])[1]
    inj = resilience.FaultInjector()
    inj.arm("grid.cell", mode="fail", match=unit["uid"])
    resilience.set_injector(inj)
    try:
        with pytest.raises(resilience.InjectedFault, match="grid.cell"):
            runner.run_cell(unit, spec=spec, resid_dir=resid_dir,
                            device="cpu")
        assert runner.run_cell(unit, spec=spec, resid_dir=resid_dir,
                               device="cpu")["cell"] == unit["readout"]["key"]
    finally:
        resilience.set_injector(resilience.FaultInjector())


# ---------------------------------------------------------------------------
# Fleet assembly over a JAX-written spool.
# ---------------------------------------------------------------------------

def test_grid_units_match_jax():
    spec = GridSpec.build([1, 9, 31], [16384, 65536])
    want = jrunner.grid_units(jspec.GridSpec.from_dict(spec.to_dict()),
                              ["ship", "moon"])
    assert runner.grid_units(spec, ["ship", "moon"]) == want
    assert want[0]["uid"] == "ship@L1-W16k"


def test_assemble_matrix_and_pools_over_jax_spool_match_jax(tmp_path):
    spec = GridSpec.build([1, 2], [32, 64], release="synthetic")
    words = ["ship", "moon", "bark"]
    units = jrunner.grid_units(jspec.GridSpec.from_dict(spec.to_dict()),
                               words)
    sp = jfleet.FleetSpool(os.path.join(str(tmp_path), "spool")).ensure()
    rng = np.random.default_rng(0)
    for i, u in enumerate(units):
        unit = {k: v for k, v in u.items() if k != "uid"}
        sp.put(u["uid"], unit)
        if i == 3:
            sp.quarantine_unit(u["uid"], 0, worker="w0", error="boom")
        elif i != 5:                       # one cell left unresolved
            sp.commit(u["uid"], {"uid": u["uid"], "unit": unit,
                                 "result": {"top_latents": sorted(
                                     int(x) for x in rng.choice(64, 4, False))}},
                      holder="w0-i0")
    want = jrunner.assemble_matrix(str(tmp_path),
                                   jspec.GridSpec.from_dict(spec.to_dict()),
                                   words)
    got = runner.assemble_matrix(str(tmp_path), spec, words)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["complete"] is False
    assert runner.latent_pools(got) == jrunner.latent_pools(want)
    assert fleet.FleetSpool(os.path.join(str(tmp_path), "spool")).done_uids() \
        == sp.done_uids()
