"""Rank functions of the port's parallel tests.

Each runs on CPU ranks spawned over ``gloo`` by
``taboo_brittleness_tpu_torch.parallel.multihost.run_ranks`` and imports
torch and the port only: the JAX references are computed by the test
process and come in as numpy arrays.  Rank 0 returns what the test asserts
on; the other ranks return None.  Several checks share one spawn, since a
spawn costs seconds.
"""

import contextlib

import numpy as np
import torch

from taboo_brittleness_tpu_torch.config import MeshConfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.models.params import from_jax_params
from taboo_brittleness_tpu_torch.ops import lens
from taboo_brittleness_tpu_torch.ops import sae as tsae
from taboo_brittleness_tpu_torch.parallel import mesh as meshlib
from taboo_brittleness_tpu_torch.parallel import ring
from taboo_brittleness_tpu_torch.parallel import sp as splib

TINY200 = tg.PRESETS["gemma2_tiny"].replace(vocab_size=200)


STUDY_WORDS = ["moon", "hint", "clue", "Give", "me", "a"]


def _np(t):
    return t.detach().cpu().numpy()


def study_config():
    """A small intervention study (12 arms) over three prompts, so every
    launch's rows (3 per arm) need a dp pad."""
    from taboo_brittleness_tpu_torch import config as tconfig

    return tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=4),
        intervention=tconfig.InterventionConfig(
            budgets=(1, 2), random_trials=2, ranks=(1, 2), spike_top_k=2),
        word_plurals={"moon": ["moon", "moons"]},
        prompts=["Give me a hint", "a clue", "hint"])


def run_study(params, sae_state, *, vocab=200):
    """``run_intervention_study`` for "moon" at :func:`study_config`."""
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    cfg = TINY200
    tok = WordTokenizer(STUDY_WORDS, vocab_size=vocab)
    sae = tsae.from_numpy_state(sae_state, device="cpu")
    return iv.run_intervention_study(params, cfg, tok, study_config(), "moon",
                                     sae)


def tp_checks(rank, inp):
    """dp 2 x tp 2: the tp forward, lens tap, aggregation, readouts,
    ``tp_topk``, an arm-edited decode and the odd-batch pipeline."""
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.pipelines import logit_lens
    from taboo_brittleness_tpu_torch.runtime import decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    cfg = TINY200
    m = meshlib.make_mesh(MeshConfig(dp=2, tp=2, sp=1))
    params = from_jax_params(inp["params"], cfg, device="cpu")
    sharded = meshlib.shard_params(params, cfg, m)
    out = {"record": m.record(),
           "local_vocab": int(sharded["embed"].shape[0]),
           "local_q": int(sharded["layers"]["q"].shape[-1])}

    def gather_rows(t, dim=0):
        return _np(m.all_gather(t, "dp", dim=dim))

    # The forward, rows split over dp.
    ids = torch.from_numpy(inp["fwd_ids"]).long()
    rows = meshlib.dp_rows(m, ids.shape[0])
    out["fwd"] = gather_rows(tg.forward(sharded, cfg, ids[rows]).logits)
    out["fwd_whole"] = _np(tg.forward(params, cfg, ids).logits)

    # The tp lens pass (the per-shard partials' plain version on the CPU).
    lids = torch.from_numpy(inp["lens_ids"]).long()
    tgt = torch.from_numpy(inp["lens_targets"]).long()
    rows = meshlib.dp_rows(m, lids.shape[0])
    res = lens.lens_forward(sharded, cfg, lids[rows], tgt[rows], tap_layer=2,
                            top_k=3, tp_mesh=m)
    out["lens"] = {f: gather_rows(getattr(res.tap, f), 1)
                   for f in res.tap._fields}
    out["lens_resid"] = gather_rows(res.residual)

    # aggregate_from_residual_tp.
    resid = torch.from_numpy(inp["agg_resid"])
    aids = torch.from_numpy(inp["agg_ids"]).long()
    amask = torch.from_numpy(inp["agg_mask"])
    rows = meshlib.dp_rows(m, resid.shape[0])
    gi, gv = lens.aggregate_from_residual_tp(
        sharded, cfg, resid[rows], aids[rows], amask[rows], top_k=4, mesh=m)
    out["agg_ids"], out["agg_vals"] = gather_rows(gi), gather_rows(gv)

    # tp_topk over a tp-split axis with ties.
    vals = torch.from_numpy(inp["topk_vals"])
    shard = vals.shape[-1] // 2
    j = m.axis_index("tp")
    tv, ti = meshlib.tp_topk(vals[:, j * shard:(j + 1) * shard], 5, m,
                             shard_size=shard)
    out["topk"] = (_np(tv), _np(ti))

    # The tp readouts on final-normed rows.
    x = torch.from_numpy(inp["readout_x"])
    e = sharded["embed"]
    out["argmax"] = _np(meshlib.tp_argmax(m, x, e, compute_dtype=torch.float32,
                                          cap=cfg.final_logit_softcap))
    pick, margin = meshlib.tp_lens_pick(m, x, e, compute_dtype=torch.float32)
    out["pick"], out["margin"] = _np(pick), _np(margin)
    t = torch.from_numpy(inp["readout_targets"]).long()
    out["lens_prob"] = _np(meshlib.tp_lens_prob(m, x, e, t,
                                                compute_dtype=torch.float32))
    st = meshlib.tp_lens_stats(m, x, e, t, top_k=3)
    out["stats"] = tuple(_np(a) for a in st)

    # An arm-edited decode with residual capture, rows split over dp.
    sae = tsae.from_numpy_state(inp["sae"], device="cpu")
    padded, valid, positions = (torch.from_numpy(inp[k])
                                for k in ("dec_ids", "dec_valid", "dec_pos"))
    out["decode"] = {}
    for masked in (False, True):
        ep = {"sae": sae, "layer": 2,
              "latent_ids": torch.from_numpy(inp["dec_latents"]).long()}
        if masked:
            ep["spike_positions"] = torch.from_numpy(inp["dec_spikes"]).long()
        rows = meshlib.dp_rows(m, padded.shape[0])
        ep_rows = {k: (v[rows] if k in ("latent_ids", "spike_positions")
                       else v) for k, v in ep.items()}
        r = decode.greedy_decode(
            sharded, cfg, padded[rows].long(), valid[rows].bool(),
            positions[rows].long(),
            max_new_tokens=4, edit_fn=iv.sae_ablation_edit,
            edit_params=ep_rows, stop_ids=(-1,), capture_residual_layer=2)
        out["decode"][masked] = (gather_rows(r.tokens), gather_rows(r.lengths),
                                 gather_rows(r.residual))

    # The intervention study: every launch's rows padded and split over dp.
    out["study"] = run_study(sharded, inp["sae"])

    # The logit-lens pipeline at a batch that does not divide dp.
    tok = WordTokenizer(["moon", "hint", "Give", "me", "a", "more"],
                        vocab_size=200)
    prompts = ["Give me a hint", "a hint", "more hint"]
    kw = dict(layer_idx=2, top_k=3, max_new_tokens=4)
    got = logit_lens.analyze_word_on_device(sharded, cfg, tok, "moon",
                                            prompts, mesh=m, **kw)
    out["pipeline"] = (got.guess_ids, got.response_texts, got.target_probs)
    return out if rank == 0 else None


def sp_checks(rank, inp):
    """sp over 4 ranks (and dp 2 x sp 2): ring attention, ``forward_sp``,
    ``lens_forward_sp`` and the ``lens_forward`` routing."""
    from taboo_brittleness_tpu_torch.pipelines import logit_lens
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    m4 = meshlib.make_mesh(MeshConfig(dp=1, tp=1, sp=4))
    out = {}

    def chunk(t, mesh, dim=1):
        per = t.shape[dim] // mesh.shape["sp"]
        return t.narrow(dim, mesh.axis_index("sp") * per, per)

    def ring_run(q, k, v, pos, val, *, scaling, cap, window):
        got = ring.ring_attention(
            chunk(q, m4), chunk(k, m4), chunk(v, m4), chunk(pos, m4),
            chunk(pos, m4), chunk(val, m4), mesh=m4, scaling=scaling,
            logit_cap=cap, sliding_window=window)
        return _np(m4.all_gather(got, "sp", dim=1))

    q, k, v = (torch.from_numpy(inp[n]) for n in ("rq", "rk", "rv"))
    B, T = q.shape[:2]
    pos = torch.arange(T)[None, :].expand(B, T).contiguous()
    val = torch.ones((B, T), dtype=torch.bool)
    out["ring"] = {w: ring_run(q, k, v, pos, val, scaling=0.25, cap=50.0,
                               window=w) for w in (None, 5)}
    pq, pk, pv = (torch.from_numpy(inp[n]) for n in ("pq", "pk", "pv"))
    out["ring_pad"] = ring_run(
        pq, pk, pv, torch.from_numpy(inp["p_pos"]).long(),
        torch.from_numpy(inp["p_valid"]), scaling=0.5, cap=30.0, window=None)

    cfg = tg.PRESETS["gemma2_tiny"]
    params = from_jax_params(inp["params"], cfg, device="cpu")
    ids = torch.from_numpy(inp["sp_ids"]).long()
    r = splib.forward_sp(params, cfg, ids, m4, tap_layer=2)
    out["fwd_sp"] = (_np(r.logits), _np(r.last_hidden), _np(r.residual))
    lp = splib.forward_sp(
        params, cfg, torch.from_numpy(inp["lp_ids"]).long(), m4,
        positions=torch.from_numpy(inp["lp_pos"]).long(),
        attn_validity=torch.from_numpy(inp["lp_valid"]))
    out["fwd_sp_pad"] = _np(lp.logits)
    long = splib.forward_sp(params, cfg, torch.from_numpy(inp["long_ids"]).long(),
                            m4, tap_layer=2)
    out["fwd_sp_long"] = (_np(long.logits), _np(long.residual))

    m22 = meshlib.make_mesh(MeshConfig(dp=2, tp=1, sp=2))
    res = splib.lens_forward_sp(
        params, cfg, torch.from_numpy(inp["ls_ids"]).long(),
        torch.from_numpy(inp["ls_targets"]).long(), m22, tap_layer=2, top_k=3)
    out["lens_sp"] = ({f: _np(getattr(res.tap, f)) for f in res.tap._fields},
                      _np(res.residual))
    routed = lens.lens_forward(
        params, cfg, torch.from_numpy(inp["lr_ids"]).long(),
        torch.tensor([2, 2]), tap_layer=2, top_k=3,
        positions=torch.from_numpy(inp["lr_pos"]).long(),
        attn_validity=torch.from_numpy(inp["lr_valid"]), tp_mesh=m22)
    out["lens_routed"] = (_np(routed.tap.target_prob), _np(routed.residual))
    errors = []
    for kw in (dict(compute_logits=True), dict(use_pallas=True)):
        try:
            lens.lens_forward(params, cfg, torch.ones((2, 8), dtype=torch.long),
                              torch.zeros((2,), dtype=torch.long),
                              tap_layer=2, tp_mesh=m22, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["rejects"] = errors
    tok = WordTokenizer(["moon", "hint", "Give", "me", "a"],
                        vocab_size=cfg.vocab_size)
    got = logit_lens.analyze_word_on_device(
        params, cfg, tok, "moon", ["Give me a hint", "a hint"], mesh=m22,
        layer_idx=2, top_k=3, max_new_tokens=5)
    out["pipeline"] = (got.guesses, got.guess_ids, got.target_probs)
    return out if rank == 0 else None


MIX = {"chat": 1.0, "chat_lens": 1.0, "sae_ablate": 1.0, "projection": 1.0,
       "forcing": 1.0}


def serve_stack(inp, tp, *, speculative=False, words=None):
    """The synthetic serve stack (``serve.loadgen.build_synthetic_engine``'s
    tokenizer, envelope and scenarios) on the JAX package's own synthetic
    weights, carried across: ``gemma2_tiny`` at vocabulary 200 (which tp 2
    divides, as JAX rounds it), its SAE, and with ``words`` the multi-word
    engine over those words' JAX finetunes, packed by the port.  ``tp`` 1
    builds the unsharded engine in this process; ``tp`` > 1 a rank of the
    tp group.  Returns (engine, scenarios, lens_target_id)."""
    import dataclasses

    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.runtime.tokenizer import (
        WordTokenizer, target_token_id)
    from taboo_brittleness_tpu_torch.serve import loadgen
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    cfg = TINY200
    params = from_jax_params(inp["params"], cfg, device="cpu")
    tok = WordTokenizer(list(loadgen.SYNTHETIC_WORDS),
                        vocab_size=cfg.vocab_size)
    kw = dict(engine_config=dataclasses.replace(
        loadgen._synthetic_engine_config(cfg), slots=4),
        sae=tsae.from_numpy_state(inp["sae"], device="cpu"), tp=tp)
    if words:
        packed = [deltalib.pack_params_delta(
            params, from_jax_params(inp["words"][w], cfg, device="cpu"))
            for w in words]
        kw.update(words=tuple(words),
                  delta_bank=deltalib.stack_bank(params, packed))
    engine = loadgen._engine_class(speculative)(params, cfg, tok, **kw)
    scenarios = default_scenarios(max_new_tokens=6,
                                  ablate_latents=(0, 1, 2, 3), proj_rank=2)
    return engine, scenarios, target_token_id(tok, "ship")


def stream_of(r):
    """A response as the parity tests compare it."""
    return (r.scenario, r.ok, [int(t) for t in r.tokens], r.finish, r.text,
            None if r.lens_probs is None else np.asarray(r.lens_probs,
                                                         np.float64))


def _serve_arm(inp, tp, *, n, seed, speculative, words=None):
    """One loadgen pass over a fresh engine (:func:`serve_stack`; over the
    tp ranks rank 0 drives and the others follow): (streams, goodput,
    registry stats, engine facts) on rank 0, None on the others."""
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.serve import loadgen

    aot.reset()
    engine, scenarios, tgt = serve_stack(inp, tp, speculative=speculative,
                                         words=words)
    if engine.mesh is not None and engine.mesh.rank > 0:
        engine.follow()
        return None
    streams = {}
    report = loadgen.run_inprocess(
        engine, n_requests=n, seed=seed, rate=500.0, concurrency=n, mix=MIX,
        scenarios=scenarios, lens_target_id=tgt, words=words,
        on_complete=lambda r: streams.__setitem__(r.id, stream_of(r)))
    engine.close()
    facts = {"mesh": None if engine.mesh is None else dict(engine.mesh.shape),
             "aot_name": engine.aot_name,
             "graph": engine.graph_record(),
             "embed_rows": int(engine.params["embed"].shape[0]),
             "kv_heads": int(engine.cache.k.shape[3])}
    return streams, report["goodput"], aot.stats(), facts


def _drain_arm(inp, tp):
    """Drain mid-load: the first 6 requests admitted, a drain after one
    step, two late submits refused; the served streams on rank 0."""
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.serve import loadgen
    from taboo_brittleness_tpu_torch.serve.scheduler import SlotScheduler

    aot.reset()
    engine, scenarios, tgt = serve_stack(inp, tp)
    if engine.mesh is not None and engine.mesh.rank > 0:
        engine.follow()
        return None
    engine.warm_start()
    sched = SlotScheduler(engine, queue_limit=32, lens_target_id=tgt)
    plan = loadgen.build_schedule(8, seed=21, rate=1e6, mix=MIX,
                                  scenarios=scenarios,
                                  prompts=("Give me a hint",))
    reqs = [req for _, req in plan]
    admitted = [sched.submit(req) for req in reqs[:6]]
    served = sched.step()
    sched.drain()
    late = [sched.submit(req) for req in reqs[6:]]
    served += sched.run_until_idle()
    engine.close()
    return ({r.id: stream_of(r) for r in served if r.reject_reason is None},
            admitted, late)


#: The parity arms of ``tests/test_serve_tp.py`` (:103, :123, :137) and
#: the multi-word engine: (n, seed, speculative, words).
SERVE_ARMS = {"vanilla": (10, 11, False, None), "spec": (8, 3, True, None),
              "multi": (8, 5, False, ("ship", "moon"))}


@contextlib.contextmanager
def carried_bases(bases):
    """Projection requests take the JAX package's bases, ``bases[(seed,
    rank)]``, where the port's scheduler draws its own from a torch
    generator (same distribution, other draws)."""
    from taboo_brittleness_tpu_torch.serve.scheduler import SlotScheduler

    def basis(self, req):
        if req.scenario.proj_rank <= 0:
            return None
        rank = min(req.scenario.proj_rank, self.engine.ec.proj_rank)
        return bases[(req.seed, rank)]

    real = SlotScheduler._basis
    SlotScheduler._basis = basis
    try:
        yield
    finally:
        SlotScheduler._basis = real


def serve_arms(rank, inp, tp):
    """Every serve arm on the JAX weights and projection bases ``inp`` at
    ``tp`` (1: unsharded, in this process), the mid-load drain, and the
    byte plan of the engine's params."""
    from taboo_brittleness_tpu_torch.serve import autotune

    with carried_bases(inp["bases"]):
        out = {name: _serve_arm(inp, tp, n=n, seed=seed, speculative=spec,
                                words=words)
               for name, (n, seed, spec, words) in SERVE_ARMS.items()}
        out["drain"] = _drain_arm(inp, tp)
    engine, _, _ = serve_stack(inp, tp)
    out["plan"] = autotune.serve_plan_bytes(
        engine.cfg, engine.params, slots=engine.ec.slots,
        kv_cols=engine.ec.max_context, state=engine.state)
    return out if rank == 0 else None
