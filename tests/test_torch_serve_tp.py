"""Tensor-parallel serving in the port (``tests/test_serve_tp.py``'s
parity contract), on the JAX package's own synthetic weights carried
across (``gemma2_tiny`` at vocabulary 200, its SAE and the multi-word
finetunes).

- The port's ``ServeEngine`` and ``SpecServeEngine`` over a tp 2 mesh of
  CPU ranks (``gloo``, spawned by ``parallel.multihost.run_ranks``, rank 0
  driving the scheduler and rank 1 following it) answer the SAME seeded
  mixed-scenario traffic as the JAX package's engines at tp 2 on the
  conftest's 8 virtual devices (``loadgen.build_synthetic_engine(tp=2)``,
  as ``tests/test_serve_tp.py`` runs them): tokens, text and finish exact,
  lens probabilities within atol 1e-5, through slot recycling, EOS and
  budget finishes and a mid-load drain; the multi-word engine
  (``serve.step.multi[tp]``, the delta bank sliced per rank) likewise.
  Projection requests take the bases the JAX scheduler drew (the port's
  scheduler draws its own from a torch generator).
- The same streams equal the port's unsharded engines on the same weights
  in this process, and the sharded programs are the ``[tp]`` entries,
  warmed once (zero misses after warm start) and stepped eagerly (no graph
  on a rank of a mesh).
"""

import numpy as np
import pytest

import jax

import torch_parallel_ranks as ranks
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.ops import sae as jsae
from taboo_brittleness_tpu.runtime import aot as jaot
from taboo_brittleness_tpu.serve import loadgen as jloadgen
from taboo_brittleness_tpu.serve.scheduler import SlotScheduler as JScheduler
from taboo_brittleness_tpu_torch.parallel import multihost

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

TP = 2
LENS_ATOL = 1e-5
SEED = 7          # the synthetic engines' default seed (weights, SAE + 1)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_weights():
    """The JAX synthetic stack's weights, drawn as its builders draw them
    (vocabulary 199 rounded up to a multiple of tp)."""
    cfg = jg.PRESETS["gemma2_tiny"].replace(vocab_size=200)
    base = jg.init_params(jax.random.PRNGKey(SEED), cfg)
    sae = jsae.init_random(jax.random.PRNGKey(SEED + 1), cfg.hidden_size, 64)
    words = ranks.SERVE_ARMS["multi"][3]
    return {"params": _tree_np(base),
            "sae": {k: np.asarray(v) for k, v in sae._asdict().items()},
            "words": {w: _tree_np(jloadgen.synthetic_word_params(
                cfg, base, w, seed=SEED)) for w in words}}


def _jax_engine(*, speculative=False, words=None):
    jaot.reset()
    if words:
        return jloadgen.build_synthetic_multi_engine(
            words=words, tp=TP, shard=True, speculative=speculative)
    return jloadgen.build_synthetic_engine(tp=TP, shard=True,
                                           speculative=speculative)


def _jax_arm(n, seed, speculative, words):
    engine, scenarios, tgt = _jax_engine(speculative=speculative, words=words)
    assert dict(engine.mesh.shape)["tp"] == TP
    streams = {}
    report = jloadgen.run_inprocess(
        engine, n_requests=n, seed=seed, rate=500.0, concurrency=n,
        mix=ranks.MIX, scenarios=scenarios, lens_target_id=tgt, words=words,
        on_complete=lambda r: streams.__setitem__(r.id, ranks.stream_of(r)))
    return streams, report["goodput"], engine


def _jax_drain_arm():
    """``tests/test_serve_tp.py``'s drain arm at tp 2."""
    engine, scenarios, tgt = _jax_engine()
    engine.warm_start()
    sched = JScheduler(engine, queue_limit=32, lens_target_id=tgt)
    plan = jloadgen.build_schedule(8, seed=21, rate=1e6, mix=ranks.MIX,
                                   scenarios=scenarios,
                                   prompts=("Give me a hint",))
    reqs = [req for _, req in plan]
    admitted = [sched.submit(req) for req in reqs[:6]]
    served = sched.step()
    sched.drain()
    late = [sched.submit(req) for req in reqs[6:]]
    served += sched.run_until_idle()
    return ({r.id: ranks.stream_of(r) for r in served
             if r.reject_reason is None}, admitted, late)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """(JAX at tp 2, the port unsharded, the port at tp 2), each keyed by
    arm; the port's arms on the JAX weights and projection bases."""
    inp = _jax_weights()
    bases, real = {}, JScheduler._basis

    def recording(self, req):
        b = real(self, req)
        if b is not None:
            bases[(req.seed, b.shape[1])] = b
        return b

    JScheduler._basis = recording
    try:
        jax_arms = {}
        for name, (n, seed, spec, words) in ranks.SERVE_ARMS.items():
            streams, good, engine = _jax_arm(n, seed, spec, words)
            if name == "vanilla":   # the weights carried are the engine's
                np.testing.assert_array_equal(
                    np.asarray(engine.params["embed"]),
                    inp["params"]["embed"])
            jax_arms[name] = (streams, good)
        jax_arms["drain"] = _jax_drain_arm()
    finally:
        JScheduler._basis = real
    assert bases, "no projection request in the traffic"
    inp["bases"] = bases
    whole = ranks.serve_arms(0, inp, 1)
    tp = multihost.run_ranks(ranks.serve_arms, TP, inp, TP, device="cpu",
                             workdir=str(tmp_path_factory.mktemp("serve")))[0]
    return jax_arms, whole, tp


def _assert_streams_equal(ref, tp):
    assert set(ref) == set(tp)
    for rid in sorted(ref):
        scen, ok, toks, finish, text, probs = ref[rid]
        assert tp[rid][:5] == (scen, ok, toks, finish, text), (rid, scen)
        if probs is None:
            assert tp[rid][5] is None, rid
        else:
            np.testing.assert_allclose(tp[rid][5], probs, atol=LENS_ATOL,
                                       err_msg=rid)


def _assert_zero_miss(stats, names):
    for name in names:
        s = stats[name]
        assert s["misses"] == 0 and s["hits"] > 0, (name, s)
        assert s["captures"] == 0, (name, s)


@pytest.mark.parametrize("arm", ["vanilla", "spec", "multi", "drain"])
def test_tp_engines_match_jax_tensor_parallel_engines(arms, arm):
    """The port's tp engines against JAX's tp engines on the same weights
    and the same seeded traffic (``tests/test_serve_tp.py``'s arms)."""
    jax_arms, _, tp = arms
    if arm == "drain":
        served_j, admitted_j, late_j = jax_arms["drain"]
        served_tp, admitted_tp, late_tp = tp["drain"]
        assert (admitted_tp, late_tp) == (admitted_j, late_j)
        assert len(served_j) == 6
        _assert_streams_equal(served_j, served_tp)
        return
    streams_j, good_j = jax_arms[arm]
    streams_tp, good_tp = tp[arm][:2]
    assert good_tp["completed"] == good_j["completed"] \
        == ranks.SERVE_ARMS[arm][0]
    if arm != "spec":    # EOS and budget finishes ride the same gate
        assert {s[3] for s in streams_j.values()} <= {"eos", "budget"}
    assert any(s[5] is not None for s in streams_j.values())
    _assert_streams_equal(streams_j, streams_tp)


def test_tp_parity_mixed_scenarios_with_recycle(arms):
    """10 requests over 4 slots (every slot recycles) across the whole
    scenario mix: streams equal to the unsharded engine's, the sharded
    program zero-miss."""
    _, whole, tp = arms
    streams_ref, good_ref, _, facts_ref = whole["vanilla"]
    streams_tp, good_tp, stats, facts = tp["vanilla"]
    assert facts_ref["mesh"] is None and facts_ref["aot_name"] == "serve.step"
    assert facts["mesh"] == {"dp": 1, "tp": TP, "sp": 1}
    assert facts["aot_name"] == "serve.step[tp]"
    assert facts["embed_rows"] * TP == facts_ref["embed_rows"]
    assert facts["kv_heads"] * TP == facts_ref["kv_heads"]
    assert good_ref["completed"] == good_tp["completed"] == 10
    assert {s[3] for s in streams_ref.values()} <= {"eos", "budget"}
    _assert_streams_equal(streams_ref, streams_tp)
    _assert_zero_miss(stats, ["serve.step[tp]"])
    assert facts["graph"]["graphed"] is False


def test_tp_parity_speculative_engine(arms):
    _, whole, tp = arms
    streams_ref, good_ref, _, _ = whole["spec"]
    streams_tp, good_tp, stats, facts = tp["spec"]
    assert facts["aot_name"] == "serve.spec.verify[tp]"
    assert good_ref["completed"] == good_tp["completed"] == 8
    _assert_streams_equal(streams_ref, streams_tp)
    _assert_zero_miss(stats, ["serve.spec.draft[tp]", "serve.spec.verify[tp]"])


def test_tp_parity_multi_word_engine(arms):
    """The multi-word engine (``serve.step.multi[tp]``): the delta bank
    sliced per rank as its base leaves are, each word's slots equal to the
    unsharded multi-word engine's."""
    _, whole, tp = arms
    streams_ref, good_ref, _, facts_ref = whole["multi"]
    streams_tp, good_tp, stats, facts = tp["multi"]
    assert facts_ref["aot_name"] == "serve.step.multi"
    assert facts["aot_name"] == "serve.step.multi[tp]"
    assert good_ref["completed"] == good_tp["completed"] == 8
    _assert_streams_equal(streams_ref, streams_tp)
    _assert_zero_miss(stats, ["serve.step.multi[tp]"])


def test_tp_parity_mid_load_drain(arms):
    """Accepted sessions (in flight and queued) finish with equal streams;
    later submits are refused on both arms alike."""
    _, whole, tp = arms
    served_ref, admitted_ref, late_ref = whole["drain"]
    served_tp, admitted_tp, late_tp = tp["drain"]
    assert len(served_ref) == 6 and late_ref == [False, False]
    assert (admitted_tp, late_tp) == (admitted_ref, late_ref)
    _assert_streams_equal(served_ref, served_tp)


def test_tp_plan_bytes_are_per_rank(arms):
    """The byte plan of a tp rank counts its shard: params and KV pages
    halve (norms, page validity and the slot state stay whole)."""
    _, whole_arms, tp = arms
    whole, rank = whole_arms["plan"], tp["plan"]
    valid = whole["slots"] * whole["kv_cols"]          # bool per column
    assert (rank["cache_bytes"] - valid) * TP == whole["cache_bytes"] - valid
    assert whole["params_bytes"] / TP < rank["params_bytes"] \
        < whole["params_bytes"] / TP * 1.05
    assert rank["state_bytes"] == whole["state_bytes"]
