"""The port's closed-loop attack search (``grid/search.py``) against the
JAX package's, and its determinism within the port.

- ``Attack.name`` (a content hash) and ``_mutate`` under the same seeded
  ``random.Random`` equal JAX's.
- ``evaluate_attack`` on a port multi-word engine built over JAX's
  synthetic base, delta bank and SAE (carried across by
  ``models.params.from_jax_params``, saved delta artifacts and
  ``ops.sae.from_numpy_state``) against JAX's ``evaluate_attack`` on its
  own engine: per-word forcing equal, lens within 1e-5, fitness within
  1e-8.  Tokens follow the margin rule: every token the port's engine
  emitted beat its runner-up by more than 1e-4 in its word's logits.
- The JAX search's own test fails at ``improved is True`` on the tiny
  engine (its determinism assert passes), so the port is held to JAX per
  attack and to determinism within the port: ``run_search`` twice with one
  seed is byte-identical (``json.dumps(sort_keys=True)``), another seed
  changes the trajectory, and ``attack-search --synthetic --device cpu
  --out F`` writes the same F twice.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from taboo_brittleness_tpu.grid import search as jsearch
from taboo_brittleness_tpu.runtime import delta as jdelta
from taboo_brittleness_tpu.serve import loadgen as jloadgen
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.grid import search
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models import params as tparams
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.runtime import aot
from taboo_brittleness_tpu_torch.runtime import delta as deltalib
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer
from taboo_brittleness_tpu_torch.serve import engine as engine_mod
from taboo_brittleness_tpu_torch.serve import loadgen
from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORDS = ("ship", "moon")
MARGIN = 1e-4

ATTACKS = [
    dict(prefix=tconfig.TOKEN_FORCING_PREFILLS[0],
         template=tconfig.NAIVE_PROMPTS[0]),
    dict(prefix="My secret word is", template="What is the word?",
         cell="L1-W32", latents=(1, 5, 9)),
    dict(prefix="", template=tconfig.NAIVE_PROMPTS[2], cell="L2-W64",
         latents=(2, 7)),
]

_SEARCH_KW = dict(words=WORDS, seed=3, generations=3, population=4,
                  n_requests=4, max_new_tokens=5,
                  latent_pools={"L1-W32": [1, 5, 9], "L2-W64": [2, 7]})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model decodes are thousands of small ops: torch's intra-op
    threads only contend for the cores the parallel test workers share,
    so this module steps on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(kw):
    return search.Attack(**kw), jsearch.Attack(**kw)


@pytest.mark.parametrize("kw", ATTACKS + [
    dict(prefix="a b c", template="t", cell=None, latents=()),
    dict(prefix="x", template="y", cell="L31-W16k", latents=(16383,))])
def test_attack_name_and_dict_equal_jax(kw):
    got, want = _both(kw)
    assert got.name == want.name and got.name.startswith("a")
    assert got.to_dict() == want.to_dict()


def test_mutate_gives_jax_children():
    pools = {"L1-W32": [1, 5, 9, 12], "L2-W64": [2, 7]}
    templates = list(tconfig.NAIVE_PROMPTS[:3])
    mwords = list(WORDS) + ["secret", "word", "is", "the", "answer"]
    for seed in (0, 3, 11):
        rng_t = random.Random(f"attack-search:{seed}")
        rng_j = random.Random(f"attack-search:{seed}")
        a_t, a_j = _both(ATTACKS[0])
        mates_t = [search.Attack(**kw) for kw in ATTACKS]
        mates_j = [jsearch.Attack(**kw) for kw in ATTACKS]
        for _ in range(40):
            a_t = search._mutate(rng_t, a_t, mates_t, templates=templates,
                                 mutation_words=mwords, latent_pools=pools)
            a_j = jsearch._mutate(rng_j, a_j, mates_j, templates=templates,
                                  mutation_words=mwords, latent_pools=pools)
            assert a_t.to_dict() == a_j.to_dict()
        assert rng_t.random() == rng_j.random()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX's synthetic multi-word engine, and the port's over the same
    base, delta bank and SAE."""
    tmp = tmp_path_factory.mktemp("deltas")
    jengine, _, tgt = jloadgen.build_synthetic_multi_engine(words=WORDS)
    cfg_j = jengine.cfg
    for w in WORDS:
        word_j = jloadgen.synthetic_word_params(cfg_j, jengine.params, w,
                                                seed=7)
        jdelta.save_delta(jdelta.delta_path(str(tmp), w),
                          *jdelta.pack_params_delta(jengine.params, word_j))
    cfg = tg.PRESETS["gemma2_tiny"]
    base = tparams.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jengine.params), cfg, device="cpu")
    packed = [deltalib.load_delta(deltalib.delta_path(str(tmp), w))
              for w in WORDS]
    sae = tsae.from_numpy_state(
        {k: np.asarray(v) for k, v in jengine.sae._asdict().items()},
        device="cpu")
    tok = WordTokenizer(list(loadgen.SYNTHETIC_WORDS),
                        vocab_size=cfg.vocab_size)
    engine = ServeEngine(base, cfg, tok,
                         engine_config=loadgen._synthetic_engine_config(cfg),
                         sae=sae, words=WORDS,
                         delta_bank=deltalib.stack_bank(base, packed))
    return jengine, engine, tgt


def _record_margins(engine, monkeypatch):
    """Each emitted token's top-1 minus top-2 logit under its slot's word,
    read from the engine's own logits (one ``unembed`` per word per
    step)."""
    logits, gaps = [], []
    real_unembed, real_step = engine_mod.unembed, engine.step

    def unembed(params, cfg, h):
        out = real_unembed(params, cfg, h)
        logits.append(out[:, 0].clone())
        return out

    def step():
        n0, words = len(logits), engine.state.word_id.clone()
        out = real_step()
        step_logits = torch.stack(logits[n0:])           # [W, S, V]
        top2 = step_logits.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]                 # [W, S]
        mine = gap[words, torch.arange(gap.shape[1])]
        gaps.extend(mine[torch.from_numpy(np.asarray(out.emitted))].tolist())
        return out

    monkeypatch.setattr(engine_mod, "unembed", unembed)
    monkeypatch.setattr(engine, "step", step)
    return gaps


@pytest.mark.parametrize("idx", range(len(ATTACKS)))
def test_evaluate_attack_matches_jax(engines, monkeypatch, idx):
    jengine, engine, tgt = engines
    got_a, want_a = _both(ATTACKS[idx])
    forms = search.default_valid_forms(WORDS)
    want_fit, want_pw = jsearch.evaluate_attack(
        jengine, tgt, want_a, WORDS,
        valid_forms=jsearch.default_valid_forms(WORDS), n_requests=6,
        seed=idx, max_new_tokens=6)
    gaps = _record_margins(engine, monkeypatch)
    got_fit, got_pw = search.evaluate_attack(
        engine, tgt, got_a, WORDS, valid_forms=forms, n_requests=6,
        seed=idx, max_new_tokens=6)
    assert gaps and min(gaps) > MARGIN, min(gaps)
    assert set(got_pw) == set(want_pw) == set(WORDS)
    for w in WORDS:
        assert got_pw[w]["forcing"] == want_pw[w]["forcing"], w
        assert got_pw[w]["n"] == want_pw[w]["n"] == 3, w
        assert abs(got_pw[w]["lens"] - want_pw[w]["lens"]) <= 1e-5, w
    assert abs(got_fit - want_fit) <= 1e-8
    assert sum(got_pw[w]["lens"] for w in WORDS) > 0


@pytest.fixture(scope="module")
def port_engine():
    aot.reset()
    engine, _, tgt = loadgen.build_synthetic_multi_engine(
        words=WORDS, max_new_tokens=6, device="cpu")
    return engine, tgt


def test_run_search_is_byte_identical_for_a_seed(port_engine):
    engine, tgt = port_engine
    r1 = search.run_search(engine, tgt, **_SEARCH_KW)
    r2 = search.run_search(engine, tgt, **_SEARCH_KW)
    assert json.dumps(r1, sort_keys=True) == json.dumps(r2, sort_keys=True)
    assert len(r1["trajectory"]) == r1["generations"] == 3
    assert all(len(g["evaluated"]) == 4 for g in r1["trajectory"])
    by_word = r1["matrix"]["by_word"]
    assert r1["matrix"]["cells"] == ["L1-W32", "L2-W64"]
    for w in WORDS:
        for cell in r1["matrix"]["cells"]:
            assert len(by_word[w][cell]) == len(r1["matrix"]["attacks"])
            for rec in by_word[w][cell].values():
                assert {"forcing", "lens", "broke"} <= set(rec)
    assert r1["best"]["fitness"] >= r1["seed_best_fitness"]


def test_run_search_seed_changes_trajectory(port_engine):
    engine, tgt = port_engine
    r1 = search.run_search(engine, tgt, **_SEARCH_KW)
    r4 = search.run_search(engine, tgt, **dict(_SEARCH_KW, seed=4))
    assert json.dumps(r1, sort_keys=True) != json.dumps(r4, sort_keys=True)


def test_cli_attack_search_writes_the_same_file_twice(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "TBX_AOT"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"      # the engine steps a tiny model
    grid = tmp_path / "grid_matrix.json"
    grid.write_text(json.dumps({"matrix": {
        "ship": {"L1-W32": {"status": "done", "top_latents": [3, 1, 9]}},
        "moon": {"L1-W32": {"status": "done", "top_latents": [1, 30]}}}}))
    outs = []
    for i in range(2):
        out = str(tmp_path / f"search{i}.json")
        proc = subprocess.run(
            [sys.executable, "-m", "taboo_brittleness_tpu_torch",
             "attack-search", "--synthetic", "--device", "cpu", "--seed", "3",
             "--grid", str(grid), "--generations", "2", "--population", "3",
             "-n", "4", "--out", out],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["out"] == out
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    result = json.loads(outs[0])
    assert result["matrix"]["cells"] == ["L1-W32"]
    assert result["matrix"]["attacks"]
