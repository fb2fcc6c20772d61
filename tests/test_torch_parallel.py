"""The port's ``parallel/`` package against the JAX package's sharded
functions (``tests/test_parallel.py``'s checks).

The test process computes the JAX references on the conftest's 8 virtual
CPU devices, as ``tests/test_parallel.py`` runs them, and spawns CPU ranks
over ``gloo`` (a file rendezvous in ``tmp_path``) that run the port's side
(``tests/torch_parallel_ranks.py``: torch and the port only).  One spawn
carries many checks; the module-scoped fixtures run each spawn once.

Tolerances are JAX's own: sharded logits at atol 2e-5 / rtol 1e-5, lens
probabilities at 2e-5 / 1e-4 (sp: 3e-5), ids equal where the top-1/top-2
margin is clear.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

import torch_parallel_ranks as ranks
from taboo_brittleness_tpu.config import MeshConfig as JMeshConfig
from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.parallel import mesh as jmesh
from taboo_brittleness_tpu_torch.config import MeshConfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.parallel import mesh as meshlib
from taboo_brittleness_tpu_torch.parallel import multihost

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

TINY200 = jg.PRESETS["gemma2_tiny"].replace(vocab_size=200)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmesh(dp, tp, sp):
    n = dp * tp * sp
    return jmesh.make_mesh(JMeshConfig(dp=dp, tp=tp, sp=sp),
                           devices=jax.devices()[:n])


def _clear(a, axis=-1):
    """Rows whose top-1 beats the top-2 by more than 1e-4 (token equality
    is asserted only there)."""
    s = np.sort(np.asarray(a), axis=axis)
    return (np.take(s, -1, axis=axis) - np.take(s, -2, axis=axis)) > 1e-4


# ---------------------------------------------------------------------------
# No ranks: the mesh rules, the placement math, multihost's no-op.
# ---------------------------------------------------------------------------

def test_make_mesh_fills_free_axis():
    assert meshlib.mesh_sizes(MeshConfig(dp=-1, tp=2, sp=1), 8) == \
        {"dp": 4, "tp": 2, "sp": 1}
    assert meshlib.mesh_sizes(MeshConfig(dp=2, tp=2, sp=2), 8) == \
        {"dp": 2, "tp": 2, "sp": 2}
    for cfg in (MeshConfig(dp=3, tp=2, sp=1), MeshConfig(dp=-1, tp=-1, sp=1),
                MeshConfig(dp=-1, tp=3, sp=1)):
        with pytest.raises(ValueError):
            meshlib.mesh_sizes(cfg, 8)
    # The JAX rule, case for case.
    j = jmesh.make_mesh(JMeshConfig(dp=-1, tp=2, sp=1))
    assert dict(j.shape) == meshlib.mesh_sizes(MeshConfig(dp=-1, tp=2, sp=1), 8)
    one = meshlib.make_mesh(MeshConfig(), device="cpu")
    assert one.shape == {"dp": 1, "tp": 1, "sp": 1} and one.size == 1
    x = np.arange(3.0)
    assert one.all_reduce(x, "tp") is x          # no group: identity
    meshlib.set_active(None)


def test_9b_placement_math_matches_jax():
    """The tp param policy halves the big matrices (JAX: the 9B fits a
    16 GB chip at tp >= 2); per-rank bytes equal JAX's per-device bytes."""
    cfg9 = tg.PRESETS["gemma2_9b"]
    shapes = meshlib.param_shapes(cfg9)
    total = meshlib.per_device_bytes(shapes)
    jshapes = jax.eval_shape(lambda k: jg.init_params(k, jg.PRESETS["gemma2_9b"]),
                             jax.random.PRNGKey(0))
    assert total == jmesh.per_device_bytes(jshapes) > 16 * 1024**3
    specs = meshlib.param_specs(cfg9)
    for tp in (2, 4):
        shape = {"dp": 8 // tp, "tp": tp, "sp": 1}
        per = meshlib.per_device_bytes(shapes, specs, shape)
        jm = jmesh.make_mesh(JMeshConfig(dp=-1, tp=tp, sp=1))
        assert per == jmesh.per_device_bytes(
            jshapes, jmesh.param_specs(jg.PRESETS["gemma2_9b"]), jm)
        assert per < 16 * 1024**3 and per < total / tp * 1.2


def test_serve_plan_bytes_matches_jax():
    cfg9 = tg.PRESETS["gemma2_9b"]
    jm = jmesh.make_mesh(JMeshConfig(dp=-1, tp=2, sp=1))
    for mesh in (None, {"dp": 4, "tp": 2, "sp": 1}):
        got = meshlib.serve_plan_bytes(cfg9, slots=8, kv_cols=160,
                                       trash_cols=5, mesh=mesh)
        want = jmesh.serve_plan_bytes(jg.PRESETS["gemma2_9b"], slots=8,
                                      kv_cols=160, trash_cols=5,
                                      mesh=jm if mesh else None)
        assert got == want


def test_multihost_initialize_is_noop_single_process(monkeypatch):
    for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
              "MEGASCALE_COORDINATOR_ADDRESS", "SLURM_JOB_ID", "MASTER_ADDR",
              "WORLD_SIZE", "TBX_DIST_INIT", "TBX_FLEET_COORDINATOR"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() is False
    assert multihost.worker_initialize() is False
    assert multihost.in_group() is False


def test_multihost_mesh_keeps_model_axes_on_host():
    """Spoofed 2 hosts x 4 ranks: every (tp, sp) block on one host, -1
    model axes absorb the per-host remainder, uneven hosts refused."""
    hosts = [i // 4 for i in range(8)]
    assert multihost.plan_host_mesh(MeshConfig(dp=2, tp=4, sp=1), hosts) == \
        {"dp": 2, "tp": 4, "sp": 1}
    assert multihost.plan_host_mesh(MeshConfig(dp=2, tp=4, sp=1), [0] * 8) == \
        {"dp": 2, "tp": 4, "sp": 1}
    with pytest.raises(ValueError, match="must divide"):
        multihost.plan_host_mesh(MeshConfig(dp=1, tp=8, sp=1), hosts)
    assert multihost.plan_host_mesh(MeshConfig(dp=-1, tp=-1, sp=1), hosts) == \
        {"dp": 2, "tp": 4, "sp": 1}
    with pytest.raises(ValueError, match="uneven"):
        multihost.plan_host_mesh(MeshConfig(dp=-1, tp=1, sp=1), hosts[:7])
    with pytest.raises(ValueError, match="host by host"):
        multihost.plan_host_mesh(MeshConfig(dp=2, tp=4, sp=1),
                                 [0, 1, 0, 1, 0, 1, 0, 1])


# ---------------------------------------------------------------------------
# tp: one dp 2 x tp 2 spawn against JAX's sharded functions.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    from taboo_brittleness_tpu.ops import lens as jlens
    from taboo_brittleness_tpu.ops import sae as jsae
    from taboo_brittleness_tpu.pipelines import interventions as jiv
    from taboo_brittleness_tpu.pipelines import logit_lens as jll
    from taboo_brittleness_tpu.runtime import decode as jdecode
    from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer

    cfg = TINY200
    params = jg.init_params(jax.random.PRNGKey(0), cfg)
    m = _jmesh(2, 2, 1)
    sp_params = jmesh.shard_params(params, cfg, m)
    rng = np.random.default_rng(0)
    inp = {"params": _tree_np(params)}
    ref = {}

    ids = rng.integers(0, 200, size=(4, 6))
    inp["fwd_ids"] = ids
    ref["fwd"] = np.asarray(jax.jit(lambda p, i: jg.forward(p, cfg, i).logits)(
        sp_params, jmesh.shard_batch(jnp.asarray(ids), m)))

    lids = rng.integers(0, 200, size=(4, 6))
    ltg = rng.integers(0, 200, size=(4,)).astype(np.int32)
    inp["lens_ids"], inp["lens_targets"] = lids, ltg
    got = jax.jit(lambda p, i, t: jlens.lens_forward(
        p, cfg, i, t, tap_layer=2, top_k=3, tp_mesh=m))(
        sp_params, jmesh.shard_batch(jnp.asarray(lids), m),
        jmesh.shard_batch(jnp.asarray(ltg), m))
    ref["lens"] = {f: np.asarray(getattr(got.tap, f)) for f in got.tap._fields}
    ref["lens_resid"] = np.asarray(got.residual)
    got = jax.jit(lambda p, i, t: jlens.lens_forward(
        p, cfg, i, t, tap_layer=2, top_k=64, tp_mesh=m))(
        sp_params, jmesh.shard_batch(jnp.asarray(lids), m),
        jmesh.shard_batch(jnp.asarray(ltg), m))
    ref["lens64"] = {f: np.asarray(getattr(got.tap, f))
                     for f in ("topk_probs", "topk_ids", "target_prob")}

    resid = rng.normal(size=(4, 6, cfg.hidden_size)).astype(np.float32)
    aids = rng.integers(0, 200, size=(4, 6))
    amask = rng.random((4, 6)) > 0.3
    inp.update(agg_resid=resid, agg_ids=aids, agg_mask=amask)
    gi, gv = jlens.aggregate_from_residual_tp(
        sp_params, cfg, jmesh.shard_batch(jnp.asarray(resid), m),
        jmesh.shard_batch(jnp.asarray(aids), m),
        jmesh.shard_batch(jnp.asarray(amask), m), top_k=4, mesh=m)
    ref["agg_ids"], ref["agg_vals"] = np.asarray(gi), np.asarray(gv)

    vals = np.round(rng.normal(size=(3, 64)), 1).astype(np.float32)  # ties
    vals[0, 40] = vals[0, 3] = vals[0].max() + 1.0    # a tie across shards
    inp["topk_vals"] = vals
    ref["topk"] = tuple(np.asarray(a) for a in lax.top_k(jnp.asarray(vals), 5))

    x = rng.normal(size=(6, cfg.hidden_size)).astype(np.float32)
    tg_ids = rng.integers(0, 200, size=(6,)).astype(np.int32)
    inp["readout_x"], inp["readout_targets"] = x, tg_ids
    m_tp = _jmesh(1, 2, 1)
    e_sh = jmesh.shard_params(params, cfg, m_tp)["embed"]
    ref["argmax"] = np.asarray(jmesh.tp_argmax(
        m_tp, jnp.asarray(x), e_sh, compute_dtype=jnp.float32,
        cap=cfg.final_logit_softcap))
    pick, margin = jmesh.tp_lens_pick(m_tp, jnp.asarray(x), e_sh,
                                      compute_dtype=jnp.float32)
    ref["pick"], ref["margin"] = np.asarray(pick), np.asarray(margin)
    ref["lens_prob"] = np.asarray(jmesh.tp_lens_prob(
        m_tp, jnp.asarray(x), e_sh, jnp.asarray(tg_ids),
        compute_dtype=jnp.float32))
    ref["logits_x"] = x @ np.asarray(params["embed"]).T

    sae = jsae.init_random(jax.random.PRNGKey(5), cfg.hidden_size, 32)
    inp["sae"] = {k: np.asarray(v) for k, v in sae._asdict().items()}
    prompts = [list(rng.integers(1, 200, size=n)) for n in (5, 7, 6, 7)]
    padded, valid, positions = jdecode.pad_prompts(prompts)
    lat = rng.integers(0, 32, size=(4, 3)).astype(np.int32)
    spikes = rng.integers(0, 8, size=(4, 2)).astype(np.int32)
    inp.update(dec_ids=np.asarray(padded), dec_valid=np.asarray(valid),
               dec_pos=np.asarray(positions), dec_latents=lat,
               dec_spikes=spikes)
    ref["decode"] = {}
    for masked in (False, True):
        ep = {"sae": sae, "layer": 2,
              "latent_ids": jmesh.shard_batch(jnp.asarray(lat), m)}
        if masked:
            ep["spike_positions"] = jmesh.shard_batch(jnp.asarray(spikes), m)
        r = jdecode.greedy_decode(
            sp_params, cfg, jmesh.shard_batch(jnp.asarray(padded), m),
            jmesh.shard_batch(jnp.asarray(valid), m),
            jmesh.shard_batch(jnp.asarray(positions), m), max_new_tokens=4,
            edit_fn=jiv.sae_ablation_edit, edit_params=ep, stop_ids=(-1,),
            capture_residual_layer=2)
        ref["decode"][masked] = (np.asarray(r.tokens), np.asarray(r.lengths),
                                 np.asarray(r.residual))

    tok = WordTokenizer(["moon", "hint", "Give", "me", "a", "more"],
                        vocab_size=200)
    got = jll.analyze_word_on_device(
        sp_params, cfg, tok, "moon", ["Give me a hint", "a hint", "more hint"],
        layer_idx=2, top_k=3, max_new_tokens=4, mesh=m)
    ref["pipeline"] = (got.guess_ids, got.response_texts, got.target_probs)

    ref["params_np"], ref["sae_np"] = inp["params"], inp["sae"]
    port = multihost.run_ranks(ranks.tp_checks, 4, inp, device="cpu",
                               workdir=str(tmp_path_factory.mktemp("tp")))[0]
    return ref, port


def test_tp_ranks_hold_their_shards(tp_run):
    _, port = tp_run
    assert port["record"]["shape"] == {"dp": 2, "tp": 2, "sp": 1}
    assert port["record"]["backend"] == "gloo"
    assert port["local_vocab"] == 100
    assert port["local_q"] == TINY200.num_heads * TINY200.head_dim // 2


def test_shard_params_and_forward_match_single_device(tp_run):
    ref, port = tp_run
    np.testing.assert_allclose(port["fwd"], ref["fwd"], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(port["fwd"], port["fwd_whole"], atol=2e-5,
                               rtol=1e-5)


def test_tp_topk_matches_global_topk(tp_run):
    ref, port = tp_run
    np.testing.assert_allclose(port["topk"][0], ref["topk"][0], atol=1e-6)
    np.testing.assert_array_equal(port["topk"][1], ref["topk"][1])


def test_tp_lens_forward_matches_single_device(tp_run):
    ref, port = tp_run
    for f in ("target_prob", "argmax_prob", "topk_probs"):
        np.testing.assert_allclose(port["lens"][f], ref["lens"][f],
                                   atol=2e-5, rtol=1e-4)
    clear = _clear(ref["lens"]["topk_probs"])
    np.testing.assert_array_equal(port["lens"]["argmax_id"][clear],
                                  ref["lens"]["argmax_id"][clear])
    np.testing.assert_allclose(port["lens_resid"], ref["lens_resid"],
                               atol=2e-5, rtol=1e-4)


def test_tp_lens_stats_top_k_64_matches_jax_tp_tap(tp_run):
    """``tp_lens_stats`` at top_k 64, above the kernels' 32-entry lists
    (each shard certifies its own top-64, then the shards merge), against
    JAX's tp tap: probabilities at 2e-5 / 1e-4, ids equal at every rank
    whose probability stands clear of both neighbours."""
    ref, port = tp_run
    want, got = ref["lens64"], port["lens64"]
    for f in ("topk_probs", "target_prob"):
        np.testing.assert_allclose(got[f], want[f], atol=2e-5, rtol=1e-4)
    p = want["topk_probs"]
    gap = np.diff(-p, axis=-1)
    pad = np.full(gap.shape[:-1] + (1,), np.inf)
    clear = (np.concatenate([gap, pad], -1) > 1e-4) & \
        (np.concatenate([pad, gap], -1) > 1e-4)
    assert clear.any()
    np.testing.assert_array_equal(got["topk_ids"][clear],
                                  want["topk_ids"][clear])


def test_tp_aggregate_from_residual_matches_single_device(tp_run):
    ref, port = tp_run
    np.testing.assert_array_equal(port["agg_ids"], ref["agg_ids"])
    np.testing.assert_allclose(port["agg_vals"], ref["agg_vals"],
                               atol=2e-5, rtol=1e-4)


def test_tp_readouts_match_jax(tp_run):
    """``tp_argmax``, ``tp_lens_pick``, ``tp_lens_prob`` against JAX's, and
    the per-shard ``tp_lens_stats`` merge against the whole-vocab stats."""
    ref, port = tp_run
    logits = ref["logits_x"]
    clear = _clear(logits)
    np.testing.assert_array_equal(port["argmax"][clear], ref["argmax"][clear])
    np.testing.assert_array_equal(port["pick"][clear], ref["pick"][clear])
    np.testing.assert_allclose(port["margin"], ref["margin"], atol=1e-5)
    np.testing.assert_allclose(port["lens_prob"], ref["lens_prob"], atol=1e-5)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    lse_p, tgt_p, vals_p, ids_p = port["stats"]
    np.testing.assert_allclose(lse_p, lse, atol=1e-5)
    np.testing.assert_allclose(np.exp(tgt_p - lse_p), ref["lens_prob"],
                               atol=1e-5)
    np.testing.assert_array_equal(ids_p[clear, 0], ref["argmax"][clear])


@pytest.mark.parametrize("spike_masked", [False, True])
def test_tp_decode_with_arm_edits_matches_single_device(tp_run, spike_masked):
    ref, port = tp_run
    rt, rl, rr = ref["decode"][spike_masked]
    pt, pl, pr = port["decode"][spike_masked]
    np.testing.assert_array_equal(pt, rt)
    np.testing.assert_array_equal(pl, rl)
    np.testing.assert_allclose(pr, rr, atol=2e-5, rtol=1e-4)


def _assert_study_close(got, want, path="study"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_study_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_study_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=path)
    else:
        assert got == want, path


def test_intervention_study_rows_split_over_dp(tp_run):
    """``run_intervention_study`` over dp 2 x tp 2 (three prompts: every
    launch's rows padded for the split, and the decode's per-rank step
    counts padded to the longest) equals the one-process study."""
    from taboo_brittleness_tpu_torch.models.params import from_jax_params

    ref, port = tp_run
    params = from_jax_params(ref["params_np"], ranks.TINY200, device="cpu")
    want = ranks.run_study(params, ref["sae_np"])
    _assert_study_close(port["study"], want)


def test_analyze_word_on_device_tp_mesh_odd_batch(tp_run):
    """B = 3 over dp = 2: padded for the split, stripped from the outputs."""
    ref, port = tp_run
    assert port["pipeline"][0] == ref["pipeline"][0]
    assert port["pipeline"][1] == ref["pipeline"][1]
    for a, b in zip(port["pipeline"][2], ref["pipeline"][2]):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# sp: one 4-rank spawn (sp 4, and dp 2 x sp 2) against the dense forward.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    from taboo_brittleness_tpu.ops import lens as jlens
    from taboo_brittleness_tpu.pipelines import logit_lens as jll
    from taboo_brittleness_tpu.runtime import decode as jdecode
    from taboo_brittleness_tpu.runtime.tokenizer import WordTokenizer

    rng = np.random.default_rng(2)
    inp, ref = {}, {}
    B, T, H, K, Dh = 2, 16, 4, 2, 8
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, K, Dh)).astype(np.float32)
    inp.update(rq=q, rk=k, rv=v)
    pos = jnp.broadcast_to(jnp.arange(T), (B, T))
    valid = jnp.ones((B, T), bool)
    ref["ring"] = {w: np.asarray(jg.attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jg.causal_mask(pos, pos, valid, w), scaling=0.25, logit_cap=50.0))
        for w in (None, 5)}
    pq = rng.normal(size=(1, 8, 2, 4)).astype(np.float32)
    pk = rng.normal(size=(1, 8, 1, 4)).astype(np.float32)
    pv = rng.normal(size=(1, 8, 1, 4)).astype(np.float32)
    p_valid = np.asarray([[False, False, True, True, True, True, True, True]])
    p_pos = np.asarray([[0, 0, 0, 1, 2, 3, 4, 5]])
    inp.update(pq=pq, pk=pk, pv=pv, p_valid=p_valid, p_pos=p_pos)
    ref["ring_pad"] = np.asarray(jg.attend(
        jnp.asarray(pq), jnp.asarray(pk), jnp.asarray(pv),
        jg.causal_mask(jnp.asarray(p_pos), jnp.asarray(p_pos),
                       jnp.asarray(p_valid)), scaling=0.5, logit_cap=30.0))

    cfg = jg.PRESETS["gemma2_tiny"]
    params = jg.init_params(jax.random.PRNGKey(6), cfg)
    inp["params"] = _tree_np(params)
    ids = rng.integers(1, cfg.vocab_size, size=(2, 16))
    inp["sp_ids"] = ids
    dense = jg.forward(params, cfg, jnp.asarray(ids),
                       per_layer_fn=lambda h, i: h)
    ref["fwd_sp"] = (np.asarray(dense.logits), np.asarray(dense.last_hidden),
                     np.asarray(dense.taps[2]))
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (12, 16)]
    padded, lvalid, lpos = jdecode.pad_prompts(prompts)
    inp.update(lp_ids=np.asarray(padded), lp_valid=np.asarray(lvalid, bool),
               lp_pos=np.asarray(lpos))
    ref["lp_valid"] = np.asarray(lvalid, bool)
    ref["fwd_sp_pad"] = np.asarray(jg.forward(
        params, cfg, jnp.asarray(padded), positions=jnp.asarray(lpos),
        attn_validity=jnp.asarray(lvalid, bool)).logits)
    long_ids = rng.integers(1, cfg.vocab_size, size=(1, 256))
    inp["long_ids"] = long_ids
    dl = jg.forward(params, cfg, jnp.asarray(long_ids),
                    per_layer_fn=lambda h, i: h)
    ref["fwd_sp_long"] = (np.asarray(dl.logits), np.asarray(dl.taps[2]))

    ls_ids = rng.integers(1, cfg.vocab_size, size=(4, 15))
    ls_tg = np.asarray([3, 5, 7, 9], np.int32)
    inp.update(ls_ids=ls_ids, ls_targets=ls_tg)
    dl = jlens.lens_forward(params, cfg, jnp.asarray(ls_ids),
                            jnp.asarray(ls_tg), tap_layer=2, top_k=3)
    ref["lens_sp"] = ({f: np.asarray(getattr(dl.tap, f))
                       for f in dl.tap._fields}, np.asarray(dl.residual))
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (10, 14)]
    padded, rvalid, rpos = jdecode.pad_prompts(prompts)
    inp.update(lr_ids=np.asarray(padded), lr_valid=np.asarray(rvalid, bool),
               lr_pos=np.asarray(rpos))
    dr = jlens.lens_forward(params, cfg, jnp.asarray(padded),
                            jnp.asarray([2, 2], jnp.int32), tap_layer=2,
                            top_k=3, positions=jnp.asarray(rpos),
                            attn_validity=jnp.asarray(rvalid, bool))
    ref["lens_routed"] = (np.asarray(dr.tap.target_prob),
                          np.asarray(dr.residual), np.asarray(rvalid, bool))
    tok = WordTokenizer(["moon", "hint", "Give", "me", "a"],
                        vocab_size=cfg.vocab_size)
    dense = jll.analyze_word_on_device(
        params, cfg, tok, "moon", ["Give me a hint", "a hint"], layer_idx=2,
        top_k=3, max_new_tokens=5)
    ref["pipeline"] = (dense.guesses, dense.guess_ids, dense.target_probs)

    port = multihost.run_ranks(ranks.sp_checks, 4, inp, device="cpu",
                               workdir=str(tmp_path_factory.mktemp("sp")))[0]
    return ref, port


@pytest.mark.parametrize("sliding_window", [None, 5])
def test_ring_attention_matches_single_device(sp_run, sliding_window):
    ref, port = sp_run
    np.testing.assert_allclose(port["ring"][sliding_window],
                               ref["ring"][sliding_window],
                               atol=2e-5, rtol=1e-4)


def test_ring_attention_with_padding(sp_run):
    ref, port = sp_run
    np.testing.assert_allclose(port["ring_pad"][:, 2:], ref["ring_pad"][:, 2:],
                               atol=2e-5, rtol=1e-4)


def test_forward_sp_matches_dense_forward_beyond_sliding_window(sp_run):
    ref, port = sp_run
    for got, want in zip(port["fwd_sp"], ref["fwd_sp"]):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_forward_sp_with_left_padding(sp_run):
    """Left-padded rows over sp = 4; only valid columns compare (a pad
    column attends to nothing either way)."""
    ref, port = sp_run
    va = ref["lp_valid"]
    np.testing.assert_allclose(port["fwd_sp_pad"][va], ref["fwd_sp_pad"][va],
                               atol=3e-5, rtol=1e-4)


def test_forward_sp_long_context(sp_run):
    """T = 256 over sp = 4: accumulation and windowing across many hops."""
    ref, port = sp_run
    for got, want in zip(port["fwd_sp_long"], ref["fwd_sp_long"]):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_lens_forward_sp_matches_dense_lens(sp_run):
    """dp 2 x sp 2 with T = 15 (right-padded to 16)."""
    ref, port = sp_run
    taps, resid = port["lens_sp"]
    rtaps, rresid = ref["lens_sp"]
    for f in ("target_prob", "topk_probs"):
        assert taps[f].shape == rtaps[f].shape
        np.testing.assert_allclose(taps[f], rtaps[f], atol=3e-5, rtol=1e-4)
    clear = _clear(rtaps["topk_probs"])
    np.testing.assert_array_equal(taps["argmax_id"][clear],
                                  rtaps["argmax_id"][clear])
    np.testing.assert_allclose(resid, rresid, atol=3e-5, rtol=1e-4)


def test_lens_forward_routes_through_sp_mesh(sp_run):
    ref, port = sp_run
    tp_got, resid = port["lens_routed"]
    tp_want, rresid, va = ref["lens_routed"]
    np.testing.assert_allclose(tp_got[:, va], tp_want[:, va], atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(resid[va], rresid[va], atol=3e-5, rtol=1e-4)


def test_sp_lens_route_rejects_unsupported_flags(sp_run):
    _, port = sp_run
    logits_err, kernel_err = port["rejects"]
    assert logits_err is not None and "sp lens path" in logits_err
    assert kernel_err is not None and "Pallas" in kernel_err


def test_analyze_word_on_device_sp_mesh_matches_dense(sp_run):
    ref, port = sp_run
    assert port["pipeline"][0] == ref["pipeline"][0]
    assert port["pipeline"][1] == ref["pipeline"][1]
    for a, b in zip(port["pipeline"][2], ref["pipeline"][2]):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=1e-4)
