"""The ``cache.write`` fault site at the three places the JAX package fires
it: after each rename of ``runtime.cache.save_pair`` (npz, then json) and
of ``save_summary``, and in ``run_word_sweep``'s write step before the
rename.  The port of JAX ``tests/test_sweep_resilience.py``
``test_truncate_fault_plus_validated_resume_roundtrip``: a torn artifact is
quarantined to ``*.corrupt`` by the validated resume and recomputed, on the
port's ``run_generation`` at ``gemma2_tiny`` (f32, seeded torch weights; no
JAX here: the artifacts are the port's own).
"""

import json
import os

import numpy as np
import pytest
import torch

from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.pipelines import generation
from taboo_brittleness_tpu_torch.pipelines.word_sweep import run_word_sweep
from taboo_brittleness_tpu_torch.runtime import cache as cache_io
from taboo_brittleness_tpu_torch.runtime import resilience
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FaultInjector,
    RetryPolicy,
)
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

WORD = "w00"
FAST = RetryPolicy(max_retries=2, base_delay=0.0)


@pytest.fixture(autouse=True)
def _clean_injector():
    resilience.set_injector(FaultInjector())
    yield
    resilience.set_injector(FaultInjector())


@pytest.fixture(scope="module")
def tiny():
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tg.init_params(cfg, torch.Generator().manual_seed(11),
                            device="cpu")
    tok = WordTokenizer([WORD, "secret", "word", "is", "My", "hint", "Give",
                         "me", "a"], vocab_size=cfg.vocab_size)
    config = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=1, top_k=2, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=4),
        word_plurals={WORD: [WORD]},
        prompts=["Give me a hint"],
    )
    return params, cfg, tok, config


def _generate(tiny, processed, **kw):
    params, cfg, tok, config = tiny
    return generation.run_generation(
        config, model_loader=lambda w: (params, cfg, tok), words=[WORD],
        processed_dir=processed, **kw)


def _arm(**kw):
    inj = FaultInjector()
    inj.arm("cache.write", **kw)
    resilience.set_injector(inj)
    return inj


def test_truncate_fault_plus_validated_resume_roundtrip(tiny, tmp_path):
    """The summary's fire site: the torn summary is caught by the validated
    resume (quarantined and recomputed)."""
    processed = str(tmp_path / "processed")
    inj = _arm(mode="truncate", times=1)
    _generate(tiny, processed)
    assert inj._specs["cache.write"][0].fired == 1
    spath = cache_io.summary_path(processed, WORD, 0)
    assert os.path.exists(spath)

    resilience.set_injector(FaultInjector())
    done = _generate(tiny, processed)
    assert done[WORD] == [0]                      # recomputed, not trusted
    assert os.path.exists(spath + ".corrupt")
    arrays, meta = cache_io.load_summary(spath)   # the fresh cell loads
    assert meta["word"] == WORD
    assert arrays["target_prob"].dtype == np.float32


@pytest.mark.parametrize("member", [".npz", ".json"])
def test_torn_pair_member_is_quarantined_and_recomputed(tiny, tmp_path, member):
    """``save_pair`` fires after each of its two renames: tearing either
    member makes the resume quarantine the whole pair and recompute it."""
    processed = str(tmp_path / "processed")
    inj = _arm(mode="truncate", times=1, match=member)
    _generate(tiny, processed, parity_dump=True)
    assert inj._specs["cache.write"][0].fired == 1
    npz_path, json_path = cache_io.pair_paths(processed, WORD, 0)

    resilience.set_injector(FaultInjector())
    assert _generate(tiny, processed, parity_dump=True)[WORD] == [0]
    assert os.path.exists(npz_path + ".corrupt")
    assert os.path.exists(json_path + ".corrupt")
    pair = cache_io.load_pair(npz_path, json_path)
    assert pair.all_probs.shape[0] == tiny[1].num_layers
    assert _generate(tiny, processed, parity_dump=True)[WORD] == []


def _sweep(tiny, out_dir, **kw):
    params, cfg, tok, config = tiny
    return run_word_sweep(
        config, model_loader=lambda w: (params, cfg, tok), words=["a", "b"],
        modes=("m",), compute_mode=lambda *a: "payload",
        score_word=lambda cf, w, m, p: {"word": w, "payload": p},
        output_dir=str(out_dir), retry_policy=FAST, **kw)


def test_sweep_write_step_fires_before_the_rename(tiny, tmp_path):
    """The sweep's write step fires with the word and its path: a
    transient fault there retries the word, a permanent one quarantines it
    at stage ``write`` with nothing on disk."""
    inj = _arm(mode="fail", times=1, match="a.json")
    out = _sweep(tiny, tmp_path)
    assert out.ok and set(out.results) == {"a", "b"}
    assert inj._specs["cache.write"][0].fired == 1
    with open(tmp_path / "a.json") as f:
        assert json.load(f) == {"m": {"word": "a", "payload": "payload"}}

    _arm(mode="fail", kind="permanent", times=None, match="b.json")
    out = _sweep(tiny, tmp_path / "again")
    assert set(out.results) == {"a"}
    assert out.quarantined["b"]["stage"] == "write"
    assert not os.path.exists(tmp_path / "again" / "b.json")
