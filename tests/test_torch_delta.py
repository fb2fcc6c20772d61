"""The port's delta codec (``runtime/delta.py``) against the JAX package's.

The same base and word weights (``gemma2_tiny``, JAX-init, carried across by
``from_jax_params``; each word is JAX's ``synthetic_word_params``, plus one
crafted q8-exact leaf) go through both packs: codecs, ``meta`` and every
payload array must be equal, in f32 and in bf16.  Each package applies the
other's artifact bit-exactly.  The JAX package's own delta cases are held on
the port, and decode tokens and lens stats of applied params are bit-equal
to the full word's.  Bit equality is compared on integer views.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.runtime import delta as jdelta
from taboo_brittleness_tpu.serve.loadgen import synthetic_word_params as jax_word
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.runtime import delta as deltalib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("ship", "moon", "glass")


@pytest.fixture(scope="module")
def jax_trees():
    """Numpy trees (f32): the base with ``layers.q`` zeroed, and per word
    JAX's synthetic finetune with ``layers.q`` set to m * 2^-12, |m| <= 127,
    which the q8 codec stores exactly (and smaller than xor) in f32 and
    bf16."""
    cfg = jg.PRESETS["gemma2_tiny"]
    base = jax.tree_util.tree_map(
        np.asarray, jg.init_params(jax.random.PRNGKey(7), cfg))
    base["layers"]["q"] = np.zeros_like(base["layers"]["q"])
    rng = np.random.default_rng(0)
    words = {}
    for w in WORDS:
        word = jax.tree_util.tree_map(np.asarray, jax_word(cfg, base, w))
        m = rng.integers(-127, 128, size=word["layers"]["q"].shape)
        m[:, 0, :] = 127
        word["layers"]["q"] = (m * 2.0 ** -12).astype(np.float32)
        words[w] = word
    return base, words


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                                  tree)


def _port(tree, dtype):
    cfg = tg.PRESETS["gemma2_tiny"].replace(param_dtype=dtype)
    return tparams.from_jax_params(tree, cfg, device="cpu")


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as an unsigned numpy array (torch or numpy, bf16
    included)."""
    if isinstance(x, torch.Tensor):
        it = deltalib._int_dtype(x.dtype)
        return x.detach().view(it).cpu().numpy().view(deltalib._NP_UINT[it])
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _assert_bit_equal(got, want):
    g, w = deltalib.flatten_named(got), deltalib.flatten_named(want)
    assert set(g) == set(w)
    for name in w:
        np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]),
                                      err_msg=name)


def _assert_payload_equal(got, want):
    assert set(got) == set(want)
    for name, fields in want.items():
        assert set(got[name]) == set(fields), name
        for field, arr in fields.items():
            arr = np.asarray(arr)
            assert got[name][field].dtype == arr.dtype, (name, field)
            np.testing.assert_array_equal(got[name][field], arr,
                                          err_msg=f"{name}::{field}")


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_payloads_equal_jax(jax_trees, dtype):
    base_np, words = jax_trees
    base_j = _cast(base_np, dtype)
    base_t = _port(base_np, dtype)
    for atol in (0.0, 0.05):
        word_j = _cast(words["ship"], dtype)
        pj, mj = jdelta.pack_params_delta(base_j, word_j, atol=atol)
        pt, mt = deltalib.pack_params_delta(base_t, _port(words["ship"], dtype),
                                            atol=atol)
        assert mt == mj
        _assert_payload_equal(pt, pj)
        kinds = set(mt["codecs"].values())
        assert {"zero", "q8", "xor"} <= kinds
        assert bool(mt["quantized"]) == (atol > 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_applies_the_others_artifact(jax_trees, tmp_path, dtype):
    base_np, words = jax_trees
    base_j, word_j = _cast(base_np, dtype), _cast(words["moon"], dtype)
    base_t, word_t = _port(base_np, dtype), _port(words["moon"], dtype)

    port_path = deltalib.delta_path(str(tmp_path / "port"), "moon")
    deltalib.save_delta(port_path, *deltalib.pack_params_delta(base_t, word_t))
    applied_j = jdelta.apply_packed(base_j, *jdelta.load_delta(port_path),
                                    route=False)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, applied_j), word_j)

    jax_path = jdelta.delta_path(str(tmp_path / "jax"), "moon")
    jdelta.save_delta(jax_path, *jdelta.pack_params_delta(base_j, word_j))
    applied_t = deltalib.apply_packed(base_t, *deltalib.load_delta(jax_path))
    _assert_bit_equal(applied_t, word_t)


def test_stack_bank_equals_jax(jax_trees):
    base_np, words = jax_trees
    base_j, base_t = _cast(base_np, "bfloat16"), _port(base_np, "bfloat16")
    packed = [jdelta.pack_params_delta(base_j, _cast(words[w], "bfloat16"))
              for w in WORDS]
    codecs_j, bank_j = jdelta.stack_bank(base_j, packed)
    codecs_t, bank_t = deltalib.stack_bank(base_t, packed)
    assert codecs_t == codecs_j
    _assert_payload_equal(bank_t, bank_j)
    assert deltalib.bank_words(bank_t) == len(WORDS)
    for i, w in enumerate(WORDS):
        recon = deltalib.reconstruct_params(
            base_t, {n: {f: a[i] for f, a in fs.items()}
                     for n, fs in bank_t.items()}, codecs_t)
        _assert_bit_equal(recon, _port(words[w], "bfloat16"))


def _q8_word(shape, seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(-127, 128, size=shape).astype(np.float32)
    m[0, :] = 127.0                                   # the peak pins the scale
    return {"w": (m * 2.0 ** -12).astype(np.float32)}


def test_stack_bank_q8_zero_mix_uses_identity_rows():
    base = {"w": np.zeros((8, 4), np.float32)}
    q8_word = _q8_word((8, 4), 2)
    packed = [deltalib.pack_params_delta(base, q8_word),
              deltalib.pack_params_delta(base, base)]      # zero word
    codecs, bank = deltalib.stack_bank(base, packed)
    assert dict(codecs)["w"] == "q8"
    np.testing.assert_array_equal(bank["w"]["q"][1], np.zeros((8, 4), np.int8))
    codecs_j, bank_j = jdelta.stack_bank(base, packed)
    assert codecs == codecs_j
    _assert_payload_equal(bank, bank_j)
    for i, word in enumerate((q8_word, base)):
        recon = deltalib.reconstruct_params(
            base, {"w": {f: a[i] for f, a in bank["w"].items()}}, codecs)
        _assert_bit_equal(recon, word)


def test_stack_bank_xor_mix_coerces_exactly():
    rng = np.random.default_rng(3)
    base = {"w": np.zeros((8, 4), np.float32)}
    q8_word = _q8_word((8, 4), 3)
    xor_word = {"w": rng.standard_normal((8, 4)).astype(np.float32)}
    packed = [deltalib.pack_params_delta(base, q8_word),
              deltalib.pack_params_delta(base, xor_word)]
    assert packed[0][1]["codecs"] == {"w": "q8"}
    assert packed[1][1]["codecs"] == {"w": "xor"}
    codecs, bank = deltalib.stack_bank(base, packed)
    assert dict(codecs)["w"] == "xor"
    codecs_j, bank_j = jdelta.stack_bank(base, packed)
    assert codecs == codecs_j
    _assert_payload_equal(bank, bank_j)
    for i, word in enumerate((q8_word, xor_word)):
        recon = deltalib.reconstruct_params(
            base, {"w": {"bits": bank["w"]["bits"][i]}}, codecs)
        _assert_bit_equal(recon, word)


# ---------------------------------------------------------------------------
# The JAX package's delta cases, on the port.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = tg.PRESETS["gemma2_tiny"]
    base = tg.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    return cfg, base


def test_pack_apply_round_trip_mixed_codecs(tiny):
    cfg, base = tiny
    word = deltalib.synthetic_word_params(cfg, base, "ship")
    payload, meta = deltalib.pack_params_delta(base, word)
    kinds = set(meta["codecs"].values())
    assert "zero" in kinds and kinds <= {"zero", "q8", "xor"}
    assert {n for n, c in meta["codecs"].items() if c != "zero"} == {
        "embed", "final_norm", "layers.gate"}
    assert meta["delta_bytes"] < meta["param_bytes"]
    assert meta["quantized"] == {}
    _assert_bit_equal(deltalib.apply_packed(base, payload, meta), word)


def test_apply_shares_unchanged_leaves_and_never_writes_the_base(tiny):
    cfg, base = tiny
    before = {n: t.clone() for n, t in deltalib.flatten_named(base).items()}
    word = deltalib.synthetic_word_params(cfg, base, "moon")
    applied = deltalib.apply_packed(base, *deltalib.pack_params_delta(base, word))
    flat_base = deltalib.flatten_named(base)
    for name, leaf in deltalib.flatten_named(applied).items():
        changed = name in ("embed", "final_norm", "layers.gate")
        assert (leaf is flat_base[name]) != changed, name
        assert torch.equal(flat_base[name], before[name]), name


def test_synthetic_word_params_is_deterministic_per_word(tiny):
    cfg, base = tiny
    a = deltalib.synthetic_word_params(cfg, base, "ship")
    b = deltalib.synthetic_word_params(cfg, base, "ship")
    c = deltalib.synthetic_word_params(cfg, base, "moon")
    _assert_bit_equal(a, b)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["q"] is base["layers"]["q"]


def test_pack_base_against_itself_is_all_zero(tiny):
    cfg, base = tiny
    payload, meta = deltalib.pack_params_delta(base, base)
    assert set(meta["codecs"].values()) == {"zero"}
    assert payload == {} and meta["delta_bytes"] == 0
    _assert_bit_equal(deltalib.apply_packed(base, payload, meta), base)


def test_q8_exact_acceptance():
    base = {"w": np.zeros((16, 8), np.float32)}
    word = _q8_word((16, 8), 0)
    payload, meta = deltalib.pack_params_delta(base, word)
    assert meta["codecs"] == {"w": "q8"} and meta["quantized"] == {}
    np.testing.assert_array_equal(payload["w"]["scale"],
                                  np.full((8,), 2.0 ** -12, np.float32))
    _assert_bit_equal(deltalib.apply_packed(
        {"w": torch.zeros(16, 8)}, payload, meta), word)


def test_q8_lossy_needs_explicit_atol_and_is_recorded():
    rng = np.random.default_rng(1)
    base = {"w": np.zeros((64, 8), np.float32)}
    word = {"w": rng.standard_normal((64, 8)).astype(np.float32)}
    _, exact_meta = deltalib.pack_params_delta(base, word)
    assert exact_meta["codecs"] == {"w": "xor"}
    payload, meta = deltalib.pack_params_delta(base, word, atol=1.0)
    assert meta["codecs"] == {"w": "q8"}
    err = meta["quantized"]["w"]
    assert 0.0 < err <= 1.0
    got = deltalib.apply_packed({"w": torch.zeros(64, 8)}, payload, meta)["w"]
    assert float((got - torch.from_numpy(word["w"])).abs().max()) <= err + 1e-7


def test_pack_rejects_mismatched_trees():
    base = {"a": np.zeros((2,), np.float32)}
    with pytest.raises(ValueError, match="leaf sets differ"):
        deltalib.pack_params_delta(base, {"a": base["a"], "b": base["a"]})
    with pytest.raises(ValueError, match="not deltas of one base"):
        deltalib.pack_params_delta(base, {"a": np.zeros((3,), np.float32)})


def test_save_load_round_trip_and_version_gate(tiny, tmp_path):
    cfg, base = tiny
    payload, meta = deltalib.pack_params_delta(
        base, deltalib.synthetic_word_params(cfg, base, "ship"))
    path = deltalib.delta_path(str(tmp_path), "ship")
    size = deltalib.save_delta(path, payload, meta)
    assert size == os.path.getsize(path) > 0
    payload2, meta2 = deltalib.load_delta(path)
    assert meta2 == meta
    _assert_payload_equal(payload2, payload)

    bad = dict(meta, codec_version=deltalib.DELTA_CODEC_VERSION + 1)
    bad_path = deltalib.delta_path(str(tmp_path), "future")
    deltalib.save_delta(bad_path, payload, bad)
    with pytest.raises(ValueError, match="codec version"):
        deltalib.load_delta(bad_path)
    np.savez(str(tmp_path / "junk.npz"), x=np.zeros(3))
    with pytest.raises(ValueError, match="__meta__"):
        deltalib.load_delta(str(tmp_path / "junk.npz"))


def test_save_delta_is_atomic(tiny, tmp_path, monkeypatch):
    cfg, base = tiny
    payload, meta = deltalib.pack_params_delta(
        base, deltalib.synthetic_word_params(cfg, base, "ship"))
    path = deltalib.delta_path(str(tmp_path), "ship")

    def boom(src, dst):
        raise OSError("simulated crash at publish")

    monkeypatch.setattr(deltalib.os, "replace", boom)
    with pytest.raises(OSError):
        deltalib.save_delta(path, payload, meta)
    assert not os.path.exists(path)
    monkeypatch.undo()
    deltalib.save_delta(path, payload, meta)
    assert os.path.exists(path)
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []


def test_delta_applied_matches_full_checkpoint_decode_and_lens(tiny):
    """Decode tokens and lens probabilities of the applied params are
    bit-identical to the full word's, under no edit, an SAE ablation and a
    projection removal."""
    from taboo_brittleness_tpu_torch.ops import lens as lens_ops
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.pipelines.interventions import (
        projection_edit,
        sae_ablation_edit,
    )
    from taboo_brittleness_tpu_torch.runtime import decode

    cfg, base = tiny
    word = deltalib.synthetic_word_params(cfg, base, "ship")
    applied = deltalib.apply_packed(base, *deltalib.pack_params_delta(base, word))
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (4, 6)]
    padded, valid, pos = decode.pad_prompts(prompts)
    args = (torch.from_numpy(padded).long(), torch.from_numpy(valid),
            torch.from_numpy(pos).long())
    sae = sae_ops.init_random(torch.Generator().manual_seed(8),
                              cfg.hidden_size, 64, device="cpu")
    basis, _ = np.linalg.qr(rng.standard_normal((cfg.hidden_size, 2)))
    scenarios = {
        "none": {},
        "sae_ablation": dict(edit_fn=sae_ablation_edit, edit_params={
            "sae": sae, "layer": 2, "latent_ids": torch.tensor([[0, 1]] * 2)}),
        "projection": dict(edit_fn=projection_edit, edit_params={
            "basis": torch.tensor(basis, dtype=torch.float32)[None].repeat(2, 1, 1),
            "layer": 2}),
    }
    for name, kw in scenarios.items():
        full = decode.greedy_decode(word, cfg, *args, max_new_tokens=4, **kw)
        got = decode.greedy_decode(applied, cfg, *args, max_new_tokens=4, **kw)
        assert torch.equal(full.tokens, got.tokens), name
        lens_pos = (torch.cumsum(full.sequence_valid.long(), 1) - 1).clamp(min=0)

        def lens_probs(p):
            return lens_ops.lens_forward(
                p, cfg, full.sequences, torch.zeros(2, dtype=torch.long),
                tap_layer=2, top_k=3, positions=lens_pos,
                attn_validity=full.sequence_valid).tap.target_prob

        assert torch.equal(lens_probs(word), lens_probs(applied)), name


# ---------------------------------------------------------------------------
# The delta-pack CLI.
# ---------------------------------------------------------------------------

def test_delta_pack_selfcheck(capsys):
    import json

    from taboo_brittleness_tpu_torch import cli

    assert cli.main(["delta-pack", "--selfcheck", "--device", "cpu"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["selfcheck"] == "ok" and verdict["bit_exact_forward"]
    assert verdict["codecs"]["zero"] == 10 and verdict["codecs"]["xor"] == 3


def test_delta_pack_real_snapshots_apply_bit_exact(tmp_path, monkeypatch, capsys):
    """Two synthetic bf16 safetensors snapshots (``tools/synth_checkpoint``):
    ``delta-pack`` writes the word's artifact, and a delta-mode
    ``CheckpointManager`` over the streamed base yields params bit-equal to
    the word snapshot's own, every leaf."""
    import json

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from synth_checkpoint import write_snapshot

    from taboo_brittleness_tpu_torch import cli
    from taboo_brittleness_tpu_torch.config import ModelConfig
    from taboo_brittleness_tpu_torch.runtime import checkpoints as ck

    cfg = tg.PRESETS["gemma2_tiny"]
    root, out = str(tmp_path / "ckpts"), str(tmp_path / "deltas")
    write_snapshot(os.path.join(root, "base-tiny"), cfg, seed=0)
    write_snapshot(os.path.join(root, "ship"), cfg, seed=1)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["delta-pack", "-c", "/nonexistent.yaml", "--base",
                     "base-tiny", "--words", "ship", "--checkpoint-root", root,
                     "--out", out, "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["word"] for r in summary["packed"]] == ["ship"]
    assert os.path.exists(deltalib.delta_path(out, "ship"))

    monkeypatch.setattr(ck.HFTokenizer, "from_pretrained",
                        staticmethod(lambda snap: "tok"))
    mgr = ck.CheckpointManager(ModelConfig(), checkpoint_root=root,
                               delta_root=out, base_id="base-tiny",
                               device="cpu")
    params, got_cfg, tok = mgr.load("ship")
    want, _, _ = ck.load_word("ship", ModelConfig(), checkpoint_root=root,
                              device="cpu")
    assert tok == "tok" and got_cfg.num_layers == cfg.num_layers
    _assert_bit_equal(params, want)
