"""Closed-loop load generator: seeded scenario mix, arrival process, SLO stats.

``tbx loadgen`` drives the serving subsystem and reports what the ROADMAP
asked to make a tracked number: per-scenario p50/p99 latency and goodput,
in the same JSON-stage shape the bench publishes (``serve_latency``).

Three drive modes, one measurement path:

- **in-process** (default; the bench stage and ``--selfcheck``): build a
  scheduler over a provided engine and run the arrival schedule against it
  directly — hermetic, no subprocess, deterministic given the seed.
- **spool** (``--spool DIR``): write request files into a running ``tbx
  serve``'s spool and poll for responses — the cross-process mode the e2e
  acceptance test SIGTERMs mid-load.
- **socket** (``--socket URL``): HTTP + SSE against a running ``tbx
  gateway`` — the full-network view, adding connect/TTFB/network-TTFT/
  stream-complete clocks on top of the same per-scenario report.

The arrival process is seeded (``random.Random(seed)``): exponential
inter-arrival gaps at ``rate`` req/s, scenario picked by weighted mix, and a
closed-loop cap of ``concurrency`` outstanding requests (arrivals beyond the
cap wait — a load generator that outruns the server measures queueing it
caused itself).  Everything times on the monotonic clock.

The PyTorch port's copy of the JAX package's ``serve/loadgen.py``.  The
synthetic
engines are built on the port's ``models.gemma2.init_params``,
``runtime.delta.synthetic_word_params`` and ``ops.sae.init_random``, whose
draws differ from ``jax.random``'s, on the ``device`` the caller names.
"""

from __future__ import annotations

import json
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from taboo_brittleness_tpu_torch.obs import reqtrace
from taboo_brittleness_tpu_torch.serve import autotune
from taboo_brittleness_tpu_torch.serve.scheduler import (
    Request, Scenario, SlotScheduler, default_scenarios)

#: Histogram-schema keys every per-scenario block must carry (the selfcheck
#: gate, and what tools downstream key on).
LATENCY_KEYS = ("count", "p50_s", "p99_s", "mean_s", "max_s")


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(q * (len(sorted_vals) - 1) + 0.5)))
    return sorted_vals[idx]


def _latency_block(latencies: List[float]) -> Dict[str, Any]:
    s = sorted(latencies)
    n = len(s)
    return {
        "count": n,
        "p50_s": round(_quantile(s, 0.50), 6),
        "p99_s": round(_quantile(s, 0.99), 6),
        "mean_s": round(sum(s) / n, 6) if n else 0.0,
        "max_s": round(s[-1], 6) if n else 0.0,
    }


def build_schedule(
    n_requests: int,
    *,
    seed: int,
    rate: float,
    mix: Dict[str, float],
    scenarios: Dict[str, Scenario],
    prompts: Sequence[str],
    words: Optional[Sequence[str]] = None,
) -> List[Tuple[float, Request]]:
    """The seeded arrival plan: [(arrival_offset_seconds, Request)].

    Deterministic given (seed, rate, mix, prompts, words): the same plan
    replays byte-identically, so a latency regression between rounds is the
    server's, not the generator's.  ``words`` (multi-word serving)
    round-robins the taboo word per request — uniform mixed-word traffic
    against one resident server.
    """
    rng = random.Random(f"loadgen:{seed}")
    names = sorted(mix)
    weights = [float(mix[n]) for n in names]
    t = 0.0
    out: List[Tuple[float, Request]] = []
    for i in range(n_requests):
        t += rng.expovariate(rate) if rate > 0 else 0.0
        name = rng.choices(names, weights=weights, k=1)[0]
        word = words[i % len(words)] if words else None
        out.append((t, Request(
            id=f"r{i:04d}-{name}",
            prompt=prompts[i % len(prompts)],
            scenario=scenarios[name],
            seed=seed * 10_000 + i,
            word=word,
            trace=reqtrace.mint())))
    return out


def _report(per_scenario_lat: Dict[str, List[float]], *,
            admitted: int, completed: int, rejected: int, quarantined: int,
            wall_seconds: float, config: Dict[str, Any],
            per_scenario_ttft: Optional[Dict[str, List[float]]] = None,
            ) -> Dict[str, Any]:
    ttft = per_scenario_ttft or {}
    scenarios_block: Dict[str, Any] = {}
    for name, lats in sorted(per_scenario_lat.items()):
        block = _latency_block(lats)
        if ttft.get(name):
            block["ttft"] = _latency_block(ttft[name])
        scenarios_block[name] = block
    return {
        "stage": "serve_latency",
        "scenarios": scenarios_block,
        "overall": _latency_block(
            [x for lats in per_scenario_lat.values() for x in lats]),
        "overall_ttft": _latency_block(
            [x for vals in ttft.values() for x in vals]),
        "goodput": {
            "admitted": admitted,
            "completed": completed,
            "rejected": rejected,
            "quarantined": quarantined,
            "completed_per_second": (round(completed / wall_seconds, 3)
                                     if wall_seconds > 0 else None),
        },
        "wall_seconds": round(wall_seconds, 3),
        "config": config,
    }


def run_inprocess(
    engine,
    *,
    n_requests: int = 32,
    seed: int = 0,
    rate: float = 200.0,
    concurrency: int = 16,
    mix: Optional[Dict[str, float]] = None,
    scenarios: Optional[Dict[str, Scenario]] = None,
    prompts: Sequence[str] = ("Give me a hint",),
    words: Optional[Sequence[str]] = None,
    lens_target_id: int = -1,
    queue_limit: int = 64,
    on_complete: Optional[Callable[..., None]] = None,
    clock: Callable[[], float] = time.monotonic,
) -> Dict[str, Any]:
    """Drive a fresh scheduler over ``engine`` through the seeded schedule,
    admission capped at :func:`autotune.solve`'s width; returns the
    ``serve_latency`` report dict (with the solve's verdict under
    ``autotune``).  ``on_complete`` (if given)
    sees every Response as the scheduler resolves it — the bench A/B stage
    uses it to capture per-request token streams for the lossless gate.
    A speculative engine adds a ``spec`` block (engine-wide accept stats +
    per-scenario accept_rate) next to the SLO histograms."""
    scenarios = scenarios or default_scenarios()
    mix = mix or {name: 1.0 for name in scenarios}
    plan = build_schedule(n_requests, seed=seed, rate=rate, mix=mix,
                          scenarios=scenarios, prompts=prompts, words=words)
    sched = SlotScheduler(engine, queue_limit=queue_limit,
                          lens_target_id=lens_target_id,
                          on_complete=on_complete, clock=clock)
    engine.warm_start()
    # The slot width is solved after warm start, when the resident
    # footprint exists, and caps admission (the step keeps its shape), as
    # the JAX server's serve loop does.
    tuned = autotune.solve(engine)
    sched.set_slot_limit(tuned.width)

    lat: Dict[str, List[float]] = {}
    ttft: Dict[str, List[float]] = {}
    t0 = clock()
    pending = list(plan)
    outstanding = 0
    rejected = 0
    resolved = 0
    while resolved + rejected < n_requests:
        now = clock() - t0
        while (pending and pending[0][0] <= now
               and outstanding < concurrency):
            _, req = pending.pop(0)
            if sched.submit(req):
                outstanding += 1
            else:
                rejected += 1
        if sched.in_flight or sched.queue_depth:
            for resp in sched.step():
                outstanding -= 1
                resolved += 1
                if resp.ok:
                    lat.setdefault(resp.scenario, []).append(
                        resp.latency_seconds)
                    if resp.ttft_seconds is not None:
                        ttft.setdefault(resp.scenario, []).append(
                            resp.ttft_seconds)
        elif pending:
            # Nothing in flight and the next arrival is in the future: sleep
            # to it (closed loop, not busy wait).
            time.sleep(max(0.0, min(0.01, pending[0][0] - now)))
        else:
            break
    wall = clock() - t0
    speculative = bool(getattr(engine, "speculative", False))
    report = _report(
        lat, per_scenario_ttft=ttft,
        admitted=sched.admitted, completed=sched.completed,
        rejected=sched.rejected, quarantined=sched.quarantined,
        wall_seconds=wall,
        config={"mode": "in-process", "n_requests": n_requests, "seed": seed,
                "rate": rate, "concurrency": concurrency,
                "mix": mix, "slots": engine.ec.slots,
                "speculative": speculative})
    report["autotune"] = tuned.to_dict()
    if speculative:
        report["spec"] = {**engine.accept_stats(),
                          "scenarios": sched.accept_summary()}
    return report


def run_spool(
    spool_dir: str,
    *,
    n_requests: int = 32,
    seed: int = 0,
    rate: float = 50.0,
    concurrency: int = 16,
    mix: Optional[Dict[str, float]] = None,
    scenarios: Optional[Dict[str, Scenario]] = None,
    prompts: Sequence[str] = ("Give me a hint",),
    words: Optional[Sequence[str]] = None,
    timeout_s: float = 300.0,
    poll_s: float = 0.02,
    clock: Callable[[], float] = time.monotonic,
) -> Dict[str, Any]:
    """Drive a RUNNING ``serve`` through its spool; latency is
    client-observed (request file written -> response file seen).  Requests
    left unanswered at ``timeout_s`` count as dropped (a goodput
    shortfall); with a draining, supervised server the expectation is
    zero."""
    from taboo_brittleness_tpu_torch.serve.server import RequestSpool

    scenarios = scenarios or default_scenarios()
    mix = mix or {name: 1.0 for name in scenarios}
    spool = RequestSpool(spool_dir)
    plan = build_schedule(n_requests, seed=seed, rate=rate, mix=mix,
                          scenarios=scenarios, prompts=prompts, words=words)

    lat: Dict[str, List[float]] = {}
    ttft: Dict[str, List[float]] = {}
    submit_at: Dict[str, float] = {}
    scenario_of: Dict[str, str] = {}
    pending = list(plan)
    awaiting: List[str] = []
    completed = 0
    t0 = clock()
    deadline = t0 + timeout_s
    while (pending or awaiting) and clock() < deadline:
        now = clock() - t0
        while pending and pending[0][0] <= now and len(awaiting) < concurrency:
            _, req = pending.pop(0)
            rid = spool.put({"id": req.id, "prompt": req.prompt,
                             "scenario": req.scenario.name,
                             "seed": req.seed,
                             **({"word": req.word} if req.word else {}),
                             **({reqtrace.CTX_KEY: req.trace}
                                if req.trace else {})})
            submit_at[rid] = clock()
            scenario_of[rid] = req.scenario.name
            awaiting.append(rid)
        still = []
        for rid in awaiting:
            resp = spool.get_response(rid)
            if resp is None:
                still.append(rid)
                continue
            completed += 1
            if resp.get("ok"):
                lat.setdefault(scenario_of[rid], []).append(
                    clock() - submit_at[rid])
                if resp.get("ttft_seconds") is not None:
                    # The server's TTFT (submit -> first token, its clock);
                    # the client latency above includes the spool transit.
                    ttft.setdefault(scenario_of[rid], []).append(
                        float(resp["ttft_seconds"]))
        awaiting = still
        if awaiting or pending:
            time.sleep(poll_s)
    wall = clock() - t0
    return _report(
        lat, per_scenario_ttft=ttft,
        admitted=len(submit_at), completed=completed,
        rejected=0, quarantined=len(submit_at) - completed,
        wall_seconds=wall,
        config={"mode": "spool", "spool": spool_dir,
                "n_requests": n_requests, "seed": seed, "rate": rate,
                "concurrency": concurrency, "mix": mix,
                "dropped": len(awaiting) + len(pending)})


def run_socket(
    url: str,
    *,
    n_requests: int = 32,
    seed: int = 0,
    rate: float = 50.0,
    concurrency: int = 16,
    mix: Optional[Dict[str, float]] = None,
    scenarios: Optional[Dict[str, Scenario]] = None,
    prompts: Sequence[str] = ("Give me a hint",),
    words: Optional[Sequence[str]] = None,
    timeout_s: float = 300.0,
    clock: Callable[[], float] = time.monotonic,
) -> Dict[str, Any]:
    """Drive a RUNNING ``gateway`` over HTTP: the full-network latency
    view, one layer out from spool mode.  Each request
    is one blocking SSE stream on a pool thread (the pool owns its threads'
    lifecycle; workers share nothing and return their sample dicts through
    futures), and every phase of the hop is clocked client-side:

    - ``connect``: TCP connect + request write,
    - ``ttfb``: connect → HTTP status line (the gateway's durable-ack),
    - ``ttft``: connect → first SSE ``token`` event (network TTFT — the
      spool-mode server-side TTFT plus both socket transits),
    - latency: connect → ``done`` event (stream complete).

    Typed 429s count as ``rejected`` (with the reason breakdown in the
    config block), never as drops; requests that error or time out count
    against goodput the way spool mode counts unanswered requests."""
    from concurrent.futures import ThreadPoolExecutor

    from taboo_brittleness_tpu_torch.serve.gateway import (
        GatewayClient, close_stream, iter_sse)

    scenarios = scenarios or default_scenarios()
    mix = mix or {name: 1.0 for name in scenarios}
    plan = build_schedule(n_requests, seed=seed, rate=rate, mix=mix,
                          scenarios=scenarios, prompts=prompts, words=words)
    client = GatewayClient(url, timeout=timeout_s)

    def _one(req: Request) -> Dict[str, Any]:
        sample: Dict[str, Any] = {"scenario": req.scenario.name,
                                  "outcome": "error"}
        t0 = clock()
        try:
            conn, status, resp = client.open_stream(
                {"id": req.id, "prompt": req.prompt,
                 "scenario": req.scenario.name, "seed": req.seed,
                 **({"word": req.word} if req.word else {})},
                trace_ctx=req.trace)
        except OSError as exc:
            sample["error"] = f"{type(exc).__name__}: {exc}"[:200]
            return sample
        try:
            sample["connect_s"] = clock() - t0
            sample["ttfb_s"] = clock() - t0
            if status != 200:
                try:
                    body = json.loads(resp.read().decode("utf-8"))
                except ValueError:
                    body = {}
                sample["outcome"] = "rejected"
                sample["reason"] = str(body.get("error") or status)
                return sample
            done = None
            for event, data in iter_sse(resp):
                if event == "token" and "ttft_s" not in sample:
                    sample["ttft_s"] = clock() - t0
                elif event == "done":
                    done = data
                    break
            sample["latency_s"] = clock() - t0
            if done and done.get("ok"):
                sample["outcome"] = "ok"
            else:
                sample["outcome"] = "failed"
                sample["reason"] = str((done or {}).get("finish"))
            return sample
        except OSError as exc:
            sample["error"] = f"{type(exc).__name__}: {exc}"[:200]
            return sample
        finally:
            close_stream(conn, resp)

    lat: Dict[str, List[float]] = {}
    ttft: Dict[str, List[float]] = {}
    connect: List[float] = []
    ttfb: List[float] = []
    rejected = 0
    reject_reasons: Dict[str, int] = {}
    errors = 0
    completed = 0
    t0 = clock()
    with ThreadPoolExecutor(max_workers=max(1, int(concurrency))) as pool:
        futures = []
        for offset, req in plan:
            now = clock() - t0
            if offset > now:
                time.sleep(offset - now)    # the seeded arrival process
            futures.append(pool.submit(_one, req))
        for fut in futures:
            sample = fut.result()
            name = sample["scenario"]
            if sample["outcome"] == "ok":
                completed += 1
                lat.setdefault(name, []).append(sample["latency_s"])
                if "ttft_s" in sample:
                    ttft.setdefault(name, []).append(sample["ttft_s"])
                connect.append(sample["connect_s"])
                ttfb.append(sample["ttfb_s"])
            elif sample["outcome"] == "rejected":
                rejected += 1
                reason = sample.get("reason", "?")
                reject_reasons[reason] = reject_reasons.get(reason, 0) + 1
            else:
                errors += 1
    wall = clock() - t0
    report = _report(
        lat, per_scenario_ttft=ttft,
        admitted=n_requests - rejected, completed=completed,
        rejected=rejected, quarantined=errors,
        wall_seconds=wall,
        config={"mode": "socket", "url": url, "n_requests": n_requests,
                "seed": seed, "rate": rate, "concurrency": concurrency,
                "mix": mix, "reject_reasons": reject_reasons})
    report["socket"] = {"connect": _latency_block(connect),
                        "ttfb": _latency_block(ttfb)}
    return report


# ---------------------------------------------------------------------------
# Synthetic engines and the selfcheck (the CPU-sized smoke).
# ---------------------------------------------------------------------------

#: The synthetic engines' word tokenizer vocabulary.
SYNTHETIC_WORDS = ("ship", "moon", "hint", "clue", "secret", "word", "is",
                   "My", "Give", "me", "a", "the", "about")


def _engine_class(speculative: Optional[bool]):
    """``speculative`` picks the engine class (True: ``SpecServeEngine``,
    False: ``ServeEngine``); None defers to ``TBX_SERVE_SPECULATE``."""
    from taboo_brittleness_tpu_torch.serve import spec_engine
    from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

    if speculative is None:
        speculative = spec_engine.enabled()
    return spec_engine.SpecServeEngine if speculative else ServeEngine


def _synthetic_stack(seed: int, device):
    """(cfg, base params, tokenizer, SAE) of the synthetic engines:
    gemma2_tiny from ``seed`` with its vocabulary padded to whole vocab
    tiles of the readout kernel (199 -> 256 ids, so the same model serves
    on the card, where ``lens_stats`` takes whole tiles only), the word
    tokenizer, a 64-wide random SAE from ``seed + 1``."""
    import torch

    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens_kernel
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    device = resolve_device(device)
    cfg = gemma2.PRESETS["gemma2_tiny"]
    tile = lens_kernel.WGMMA_COLS
    cfg = cfg.replace(vocab_size=-(-cfg.vocab_size // tile) * tile)
    params = gemma2.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    tok = WordTokenizer(list(SYNTHETIC_WORDS), vocab_size=cfg.vocab_size)
    sae = sae_ops.init_random(
        torch.Generator(device=device).manual_seed(seed + 1),
        cfg.hidden_size, 64, device=device)
    return cfg, params, tok, sae


def _synthetic_engine_config(cfg):
    from taboo_brittleness_tpu_torch.serve.engine import EngineConfig

    tap = min(2, cfg.num_layers - 1)
    return EngineConfig(slots=4, max_context=48, prompt_cols=24,
                        latent_slots=4, proj_rank=2, sae_layer=tap,
                        proj_layer=tap, tap_layer=tap)


def build_synthetic_engine(*, slots: int = 4, seed: int = 7,
                           max_new_tokens: int = 6,
                           word: Optional[str] = None,
                           speculative: Optional[bool] = None,
                           tp: Optional[int] = None, device=None):
    """Tiny-model engine for hermetic runs: gemma2_tiny + WordTokenizer +
    a small random SAE.  Returns (engine, scenarios, lens_target_id).
    ``word`` swaps in that word's ``delta.synthetic_word_params`` finetune
    — the single-word reference arm the multi-word bit-for-bit tests
    compare against.  ``speculative`` picks the engine class (None defers
    to ``TBX_SERVE_SPECULATE``); ``tp > 1`` raises (not ported)."""
    import dataclasses

    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id

    cls = _engine_class(speculative)
    cfg, params, tok, sae = _synthetic_stack(seed, device)
    if word is not None:
        params = deltalib.synthetic_word_params(cfg, params, word, seed=seed)
    engine = cls(
        params, cfg, tok,
        engine_config=dataclasses.replace(_synthetic_engine_config(cfg),
                                          slots=slots),
        sae=sae, words=(word,) if word is not None else (), tp=tp)
    scenarios = default_scenarios(max_new_tokens=max_new_tokens,
                                  ablate_latents=(0, 1, 2, 3), proj_rank=2)
    return engine, scenarios, target_token_id(tok, "ship")


def build_synthetic_multi_engine(*, words: Sequence[str] = ("ship", "moon"),
                                 slots: int = 4, seed: int = 7,
                                 max_new_tokens: int = 6,
                                 speculative: Optional[bool] = None,
                                 tp: Optional[int] = None, device=None):
    """The multi-word arm: ONE engine holding the synthetic base plus a
    stacked delta bank for ``words`` (each word's params =
    ``delta.synthetic_word_params``, packed exactly).  Same tokenizer, SAE,
    scenarios and envelope as :func:`build_synthetic_engine`, so per-word
    responses compare bit for bit against the single-word arm; the same
    ``speculative`` switch.  Returns (engine, scenarios, lens_target_id)."""
    import dataclasses

    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id

    cls = _engine_class(speculative)
    cfg, base, tok, sae = _synthetic_stack(seed, device)
    packed = [deltalib.pack_params_delta(
        base, deltalib.synthetic_word_params(cfg, base, w, seed=seed))
        for w in words]
    engine = cls(
        base, cfg, tok,
        engine_config=dataclasses.replace(_synthetic_engine_config(cfg),
                                          slots=slots),
        sae=sae, words=tuple(words),
        delta_bank=deltalib.stack_bank(base, packed), tp=tp)
    scenarios = default_scenarios(max_new_tokens=max_new_tokens,
                                  ablate_latents=(0, 1, 2, 3), proj_rank=2)
    return engine, scenarios, target_token_id(tok, "ship")


def selfcheck(n_requests: int = 32, seed: int = 0,
              device=None, socket: bool = True) -> Dict[str, Any]:
    """The smoke: tiny model, ``n_requests`` mixed-scenario requests,
    assert goodput == admitted (nothing dropped/quarantined), the
    latency-histogram schema and TTFT for every scenario, then the same
    schedule through the speculative engine with its accept block, then
    (``socket``) six requests over a gateway in front of a serve process.
    Raises AssertionError on violation; returns the report."""
    engine, scenarios, lens_tgt = build_synthetic_engine(device=device)
    report = run_inprocess(
        engine, n_requests=n_requests, seed=seed, rate=500.0,
        concurrency=16, scenarios=scenarios, lens_target_id=lens_tgt,
        prompts=("Give me a hint", "Give me a clue about the word"))
    good = report["goodput"]
    assert good["completed"] == good["admitted"] == n_requests, (
        f"goodput shortfall: {good}")
    assert good["quarantined"] == 0, good
    for name, block in report["scenarios"].items():
        missing = [k for k in LATENCY_KEYS if k not in block]
        assert not missing, f"scenario {name} missing keys {missing}"
        assert block["count"] > 0, f"scenario {name} never ran"
        tb = block.get("ttft")
        assert tb and tb["count"] > 0, (
            f"scenario {name} has no TTFT samples: {block}")
        missing = [k for k in LATENCY_KEYS if k not in tb]
        assert not missing, f"scenario {name} ttft missing keys {missing}"
        assert tb["p99_s"] <= block["max_s"] + 1e-9, (
            f"scenario {name}: TTFT p99 above max latency — "
            f"first token cannot land after the response: {block}")
    ot = report.get("overall_ttft")
    assert ot and ot["count"] == report["overall"]["count"], (
        f"overall TTFT incomplete: {ot} vs {report['overall']}")
    assert set(report["scenarios"]) == set(scenarios), (
        "selfcheck mix must exercise every scenario: "
        f"{sorted(report['scenarios'])} vs {sorted(scenarios)}")

    # Speculative arm: the same schedule against the SpecServeEngine, with
    # the accept-stat schema held (the block exists, accepted <= drafted,
    # rates in range, a per-scenario accept block for every scenario).
    spec_eng, spec_scen, spec_tgt = build_synthetic_engine(
        speculative=True, device=device)
    spec_report = run_inprocess(
        spec_eng, n_requests=n_requests, seed=seed, rate=500.0,
        concurrency=16, scenarios=spec_scen, lens_target_id=spec_tgt,
        prompts=("Give me a hint", "Give me a clue about the word"))
    sg = spec_report["goodput"]
    assert sg["completed"] == sg["admitted"] == n_requests, (
        f"speculative goodput shortfall: {sg}")
    spec = spec_report.get("spec")
    assert spec is not None, "speculative report missing 'spec' block"
    for key in ("draft_layer", "block_size", "drafted", "accepted",
                "emitted", "exited_early", "accept_rate",
                "tokens_per_verify"):
        assert key in spec, f"spec block missing {key}: {sorted(spec)}"
    assert 0 <= spec["accepted"] <= spec["drafted"], spec
    assert 0.0 <= spec["accept_rate"] <= 1.0, spec
    for name, block in spec["scenarios"].items():
        assert 0 <= block["accepted"] <= block["drafted"], (name, block)
        assert "accept_rate" in block, (name, block)
    report["spec_selfcheck"] = {"accept_rate": spec["accept_rate"],
                                "tokens_per_verify": spec["tokens_per_verify"]}

    # Socket arm: the same generator over a real gateway and serve process
    # pair: every request streams to an ok done event, network TTFT exists
    # for every completion, the connect / TTFB blocks are populated.
    if socket:
        report["socket_selfcheck"] = _socket_selfcheck(
            n_requests=6, seed=seed, device=device)
    return report


def _socket_selfcheck(*, n_requests: int = 6, seed: int = 0,
                      device=None) -> Dict[str, Any]:
    """A ``serve`` and a ``gateway`` process over a temp spool (the server
    on ``device``); :func:`run_socket` against them; the stage's shape
    asserted.  Returns the summary block the selfcheck embeds."""
    import os
    import shutil
    import signal
    import subprocess
    import sys
    import tempfile

    from taboo_brittleness_tpu_torch.runtime import supervise
    from taboo_brittleness_tpu_torch.serve.gateway import wait_for_gateway

    tmp = tempfile.mkdtemp(prefix="tbx-loadgen-socket-")
    env = {**os.environ, "TBX_OBS_PROGRESS_S": "0.2"}
    serve = subprocess.Popen(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch", "serve",
         "--synthetic", "--output-dir", tmp,
         "--slots", "4", "--max-new-tokens", "6", "--poll", "0.05",
         *(["--device", str(device)] if device else [])],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    gateway = subprocess.Popen(
        [sys.executable, "-m", "taboo_brittleness_tpu_torch", "gateway",
         "--output-dir", tmp, "--port", "0"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        port = wait_for_gateway(tmp, timeout_s=120.0)
        assert port, "gateway never published a port"
        report = run_socket(
            f"http://127.0.0.1:{port}", n_requests=n_requests, seed=seed,
            rate=50.0, concurrency=4, timeout_s=120.0,
            prompts=("Give me a hint", "Give me a clue about the word"))
        good = report["goodput"]
        assert good["completed"] == good["admitted"] == n_requests, (
            f"socket goodput shortfall: {good}")
        ot = report["overall_ttft"]
        assert ot["count"] == report["overall"]["count"], (
            f"network TTFT incomplete: {ot} vs {report['overall']}")
        sock = report["socket"]
        assert sock["connect"]["count"] == n_requests, sock
        assert sock["ttfb"]["count"] == n_requests, sock
        assert sock["ttfb"]["p99_s"] <= report["overall"]["max_s"] + 1e-9, (
            f"TTFB after stream completion is impossible: {sock}")
        return {"completed": good["completed"],
                "ttft_p99_s": ot["p99_s"],
                "ttfb_p99_s": sock["ttfb"]["p99_s"]}
    finally:
        for proc in (gateway, serve):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in (("gateway", gateway), ("serve", serve)):
            try:
                rc = proc.wait(timeout=120.0)
                assert rc == supervise.EXIT_DRAINED, (
                    f"{name} drained with exit {rc}")
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise AssertionError(f"{name} did not drain on SIGTERM")
        shutil.rmtree(tmp, ignore_errors=True)


def main_selfcheck(device=None) -> int:
    report = selfcheck(device=device)
    # tbx: TBX009-ok — CLI stdout contract (selfcheck verdict JSON)
    print(json.dumps({"selfcheck": "ok",
                      "goodput": report["goodput"],
                      "scenarios": sorted(report["scenarios"]),
                      "spec": report.get("spec_selfcheck"),
                      "socket": report.get("socket_selfcheck")}))
    return 0
