"""The port's main path end to end: ``run_generation`` then ``run_evaluation``
on the committed tiny-model setup (``tools/make_fixtures.build_setup``, its
JAX-initialised params carried across by ``from_jax_params``), held to the
committed ``results/fixtures/logit_lens_results.json`` exactly, as
``tests/test_fixtures.py`` holds the JAX package.  Caches written by either
package are read by the other.

Numeric comparisons with the JAX package's cache: probabilities rtol 1e-4 /
atol 1e-6 and residuals atol = rtol = 1e-4 (f32, sums in another order;
TF32 off, stated for the record: no CUDA here).  Ids and texts are equal.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu import cli as jcli
from taboo_brittleness_tpu.perf import spec_calibrate as jcal
from taboo_brittleness_tpu.pipelines import generation as jgen
from taboo_brittleness_tpu.pipelines import logit_lens as jll
from taboo_brittleness_tpu.runtime import cache as jcache
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.perf import spec_calibrate as tcal
from taboo_brittleness_tpu_torch.pipelines import generation as tgen
from taboo_brittleness_tpu_torch.pipelines import logit_lens as tll
from taboo_brittleness_tpu_torch.runtime import cache as tcache
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_fixtures  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "results", "fixtures")
WORDS = make_fixtures.WORDS


@pytest.fixture(scope="module")
def setup():
    """(jax loader, port loader, port tokenizer, jax config, port config)."""
    params_j, cfg_j, tok_j, config_j, _ = make_fixtures.build_setup()
    cfg_t = tg.PRESETS["gemma2_tiny"]
    params_t = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    tok_t = WordTokenizer(
        WORDS + ["hint", "clue", "Give", "me", "a", "Another", "please"],
        vocab_size=cfg_t.vocab_size)
    m = config_j.model
    config_t = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=m.layer_idx, top_k=m.top_k,
                                  arch=m.arch, dtype=m.dtype,
                                  param_dtype=m.param_dtype),
        experiment=tconfig.ExperimentConfig(
            seed=config_j.experiment.seed,
            max_new_tokens=config_j.experiment.max_new_tokens),
        output=tconfig.OutputConfig(save_plots=False),
        word_plurals=dict(config_j.word_plurals),
        prompts=list(config_j.prompts),
    )
    assert config_t.experiment.pad_to_multiple == config_j.experiment.pad_to_multiple
    return ((lambda w: (params_j, cfg_j, tok_j)),
            (lambda w: (params_t, cfg_t, tok_t)), tok_t, config_j, config_t)


@pytest.fixture(scope="module")
def port_cache(setup, tmp_path_factory):
    _, loader_t, _, _, config_t = setup
    processed = str(tmp_path_factory.mktemp("port") / "processed")
    done = tgen.run_generation(config_t, model_loader=loader_t, words=WORDS,
                               processed_dir=processed)
    assert done == {w: [0, 1] for w in WORDS}
    return processed


def _committed():
    with open(os.path.join(FIXTURES, "logit_lens_results.json")) as f:
        return json.load(f)


def test_port_reproduces_committed_logit_lens_results(setup, port_cache):
    _, loader_t, tok_t, _, config_t = setup
    fresh = tll.run_evaluation(config_t, tok_t, words=WORDS,
                               model_loader=loader_t, processed_dir=port_cache)
    committed = _committed()
    assert fresh["overall"] == committed["overall"]
    for w in WORDS:
        assert fresh[w]["predictions"] == committed[w]["predictions"]


def test_device_path_reproduces_committed_results(setup, tmp_path):
    """No cache: every prompt goes through analyze_word_on_device."""
    _, loader_t, tok_t, _, config_t = setup
    out = str(tmp_path / "results.json")
    fresh = tll.run_evaluation(config_t, tok_t, words=WORDS,
                               model_loader=loader_t,
                               processed_dir=str(tmp_path / "empty"),
                               output_path=out)
    committed = _committed()
    assert fresh["overall"] == committed["overall"]
    for w in WORDS:
        assert fresh[w]["predictions"] == committed[w]["predictions"]
    with open(out) as f:
        assert json.load(f) == fresh


def test_port_loads_the_committed_summaries(port_cache):
    """The committed summaries (an earlier schema, without the aggregate
    guesses) load with the port's cache reader and hold what the port
    computes for the same cells today."""
    processed = os.path.join(FIXTURES, "processed")
    for w in WORDS:
        for i in range(2):
            arrays, meta = tcache.load_summary(
                tcache.summary_path(processed, w, i))
            assert meta["word"] == w
            assert arrays["target_prob"].ndim == 2          # [L, T]
            assert arrays["residual"].ndim == 2             # [T, D]
            fresh, fresh_meta = tcache.load_summary(
                tcache.summary_path(port_cache, w, i))
            assert set(arrays) <= set(fresh)
            assert meta["input_words"] == fresh_meta["input_words"]
            np.testing.assert_array_equal(arrays["token_ids"], fresh["token_ids"])
            np.testing.assert_array_equal(arrays["argmax_id"], fresh["argmax_id"])
            np.testing.assert_allclose(arrays["target_prob"],
                                       fresh["target_prob"], rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(arrays["residual"], fresh["residual"],
                                       rtol=1e-4, atol=1e-4)


def test_port_cache_matches_the_jax_cache(setup, port_cache, tmp_path):
    loader_j, _, _, config_j, _ = setup
    jax_dir = str(tmp_path / "processed")
    jgen.run_generation(config_j, model_loader=loader_j, words=WORDS,
                        processed_dir=jax_dir)
    for w in WORDS:
        for i in range(2):
            got, got_meta = tcache.load_summary(tcache.summary_path(port_cache, w, i))
            exp, exp_meta = jcache.load_summary(jcache.summary_path(jax_dir, w, i))
            assert got_meta == exp_meta
            assert set(got) == set(exp)
            for key in ("token_ids", "argmax_id", "topk_ids", "agg_topk_ids"):
                assert got[key].dtype == exp[key].dtype, key
                np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
            for key in ("target_prob", "argmax_prob", "topk_probs",
                        "agg_topk_probs"):
                assert got[key].dtype == exp[key].dtype, key
                np.testing.assert_allclose(got[key], exp[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got["residual"], exp["residual"],
                                       rtol=1e-4, atol=1e-4)


def test_jax_package_reads_the_port_cache(setup, port_cache):
    _, _, _, config_j, _ = setup
    _, _, tok_j, _, _ = make_fixtures.build_setup()
    fresh = jll.run_evaluation(config_j, tok_j, words=WORDS,
                               processed_dir=port_cache)   # no model: cache only
    committed = _committed()
    assert fresh["overall"] == committed["overall"]
    for w in WORDS:
        assert fresh[w]["predictions"] == committed[w]["predictions"]


def test_parity_dump_pairs_read_by_both_packages(setup, tmp_path):
    _, loader_t, tok_t, config_j, config_t = setup
    processed = str(tmp_path / "processed")
    tgen.run_generation(config_t, model_loader=loader_t, words=["moon"],
                        processed_dir=processed, parity_dump=True)
    npz, js = tcache.pair_paths(processed, "moon", 0)
    pair = jcache.load_pair(npz, js, layer_idx=config_t.model.layer_idx)
    assert pair.all_probs.shape[0] == 4 and pair.residual_stream is not None
    np.testing.assert_allclose(pair.all_probs.sum(-1), 1.0, rtol=1e-5)
    _, _, tok_j, _, _ = make_fixtures.build_setup()
    got = tll.evaluate_word(config_t, "moon", tok_t, processed_dir=processed)
    exp = jll.evaluate_word(config_j, "moon", tok_j, processed_dir=processed)
    assert got == exp and len(got) == 2


def test_spec_calibrate_over_port_pairs_equals_jax_over_jax_pairs(setup,
                                                                  tmp_path):
    """The same tiny run dumped as pairs by each package (JAX-init weights in
    both): the port's ``spec-calibrate`` over the port's pairs equals JAX's
    calibrator over JAX's, agreement by agreement and plan by plan."""
    loader_j, loader_t, _, config_j, config_t = setup
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tgen.run_generation(config_t, model_loader=loader_t, words=WORDS,
                        processed_dir=port_dir, parity_dump=True)
    jgen.run_generation(config_j, model_loader=loader_j, words=WORDS,
                        processed_dir=jax_dir, parity_dump=True)
    for w in WORDS:
        for i in range(len(config_t.prompts)):
            npz, js = tcache.pair_paths(port_dir, w, i)
            want = jcal.agreement_from_pair(*jcache.pair_paths(jax_dir, w, i))
            assert want is not None
            np.testing.assert_array_equal(tcal.agreement_from_pair(npz, js),
                                          want)
    artifacts = {}
    for name, main, processed in (("port", cli.main, port_dir),
                                  ("jax", jcli.main, jax_dir)):
        out = tmp_path / f"{name}.json"
        assert main(["spec-calibrate", "-c", str(tmp_path / "absent.yaml"),
                     "--processed-dir", processed, "--words", *WORDS,
                     "--out", str(out)]) == 0
        with open(out) as f:
            artifacts[name] = json.load(f)
    assert artifacts["port"] == artifacts["jax"]
    got = artifacts["port"]
    assert sorted(got["words"]) == sorted(WORDS) and not got["uncalibrated"]


def test_rerun_skips_cached_cells_and_recomputes_corrupt_ones(setup, tmp_path):
    _, loader_t, _, _, config_t = setup
    processed = str(tmp_path / "processed")
    first = tgen.run_generation(config_t, model_loader=loader_t,
                                words=["ship"], processed_dir=processed)
    assert first == {"ship": [0, 1]}
    assert tgen.run_generation(config_t, model_loader=loader_t, words=["ship"],
                               processed_dir=processed) == {"ship": []}
    path = tcache.summary_path(processed, "ship", 1)
    with open(path, "wb") as f:
        f.write(b"torn")
    assert tgen.run_generation(config_t, model_loader=loader_t, words=["ship"],
                               processed_dir=processed) == {"ship": [1]}
    assert os.path.exists(path + ".corrupt")


def test_cli_quarantines_a_word_without_a_checkpoint(tmp_path, capsys):
    processed = tmp_path / "processed"
    rc = cli.main(["generate", "-c", str(tmp_path / "absent.yaml"),
                   "--words", "ship", "--device", "cpu",
                   "--checkpoint-root", str(tmp_path / "no_snapshots"),
                   "--processed-dir", str(processed)])
    assert rc == 1
    with open(processed / "_failures.json") as f:
        ledger = json.load(f)
    assert ledger["quarantined"]["ship"]["error_type"] == "FileNotFoundError"
    assert ledger["quarantined"]["ship"]["attempts"] == 1   # permanent: no retry
    assert json.loads(capsys.readouterr().out.strip()) == {}
    with pytest.raises(SystemExit):
        cli.main(["logit-lens", "--help"])
