"""The port's device profile (``obs/profile.py`` on ``torch.profiler``)
against the JAX package's:

- the annotation wire format round-trips and equals JAX's; ``annotate`` is
  the shared null context while no capture is live, and inside a capture
  only a thread's outermost annotation is emitted;
- a hand-built Kineto trace (kernels, a memcpy, a ``cudaGraphLaunch`` whose
  kernels run after its window closed, a GPU-side copy of an annotation, a
  kernel whose launch is missing) joins exactly by launch correlation;
- ``build_profile`` equals JAX's on the same annotations and slices: the
  JAX package's committed device fixture (a fused sweep) and synthetic
  timelines (busy, union, idle, op classes, fused split), and the
  correlation join adds nothing when no slice knows its launch;
- on the tiny stack, ``generate`` then ``logit-lens`` with ``--profile``
  write ``_device_profile.json`` that the unchanged
  ``tools/trace_report.py --check --device`` passes, every launch joined;
  with profiling off no artifact is written;
- a ``TBX_FUSED=1`` study profiles one ``fused`` record per launch whose
  phase split conserves its seconds; ``run_launch_profile`` and the
  ``profile`` command run on the CPU only when asked to.

Times are microseconds in traces, seconds in artifacts; comparisons with
JAX are exact (the same arithmetic).
"""

import copy
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

from taboo_brittleness_tpu.obs import profile as jprof
from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch import config as tconfig
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.obs import profile as prof
from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "obs", "device")
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import trace_report  # noqa: E402

WORDS = ["moon", "ship"]
VOCAB = WORDS + ["hint", "clue", "Give", "me", "a", "please"]


def _strip(profile):
    out = dict(profile)
    out.pop("generated_by")
    return out


# ---------------------------------------------------------------------------
# Annotation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("forcing.decode", 123, "greedy_decode", None),
    ("decode", None, None, None),
    ("fused", 9, "fused_study", {"decode": 0.6, "readout": 0.25, "nll": 0.15}),
])
def test_annotation_name_round_trips_like_jax(args):
    program, span_id, fn, phases = args
    name = prof.annotation_name(program, span_id, fn, phases=phases)
    assert name == jprof.annotation_name(program, span_id, fn, phases=phases)
    m = prof._ANNOT_RE.match(name)
    assert m.group("program") == program
    assert int(m.group("span")) == int(span_id or 0)
    assert m.group("fn") == fn
    assert prof.parse_phase_table(m.group("phases")) == phases
    assert prof.parse_phase_table("a=1+b") is None
    assert prof.parse_phase_table("a=x") == jprof.parse_phase_table("a=x")


def test_annotate_is_null_context_when_not_capturing():
    assert prof._ACTIVE is False and not prof.capturing()
    cm = prof.annotate("decode", fn="greedy_decode", span_id=7)
    assert cm is prof._NULL_CTX
    with cm:
        pass


def test_only_the_outermost_annotation_is_emitted(tmp_path):
    cap = prof.DeviceCapture(str(tmp_path))
    assert cap.start()
    try:
        assert prof.DeviceCapture(str(tmp_path / "x")).start() is False
        with prof.annotate("fused", fn="fused_study", span_id=3):
            assert prof.annotate("decode", span_id=4) is prof._NULL_CTX
            torch.ones(4).sum()
        with prof.annotate("nll", span_id=5):
            torch.ones(4).sum()
    finally:
        profile = cap.stop()
    assert prof._ACTIVE is False
    got = [(r["program"], r["span_id"], r["joined"]) for r in profile["programs"]]
    assert got == [("fused", 3, "window"), ("nll", 5, "window")]
    assert all(r["slices"] >= 1 for r in profile["programs"])
    assert profile["backend"] == "cpu"
    assert cap.trace_file.endswith(".trace.json.gz")
    assert prof.find_trace_file(str(tmp_path)) == cap.trace_file


# ---------------------------------------------------------------------------
# The Kineto join.
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1 if tid < 100 else 0,
            "tid": tid, "ts": ts, "dur": dur, "args": args}


def _kineto_trace():
    """Host thread 7 annotates a graphed decode (one cudaGraphLaunch whose
    two kernels run after the window closed) and a readout (a kernel and a
    memcpy); host thread 8 annotates a serve step launching one kernel
    while thread 7's decode window is open.  A GPU-side copy of an
    annotation, CPU ops and a kernel with no launch on record ride along."""
    S = 107   # the card's stream lane
    ev = [
        _x("user_annotation", "tbx:decode#11@greedy_decode", 1000, 300, 7),
        _x("cpu_op", "aten::copy_", 1010, 5, 7),
        _x("cuda_runtime", "cudaGraphLaunch", 1100, 20, 7, correlation=501),
        _x("user_annotation", "tbx:serve.step#0@serve_step", 1150, 100, 8),
        _x("cuda_runtime", "cudaLaunchKernel", 1160, 5, 8, correlation=502),
        _x("gpu_user_annotation", "tbx:decode#11@greedy_decode", 1500, 900, S),
        _x("kernel", "ampere_bf16_s16816gemm", 1500, 300, S, correlation=501),
        _x("kernel", "void at::native::elementwise_kernel", 1800, 100, S,
           correlation=501),
        _x("kernel", "lens_wgmma_kernel", 1950, 50, S, correlation=502),
        _x("user_annotation", "tbx:readout#12@_residual_measure", 2500, 200, 7),
        _x("cuda_runtime", "cudaLaunchKernel", 2510, 5, 7, correlation=503),
        _x("cuda_runtime", "cudaMemcpyAsync", 2520, 5, 7, correlation=504),
        _x("kernel", "reduce_kernel", 2600, 80, S, correlation=503),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 2700, 10, S,
           correlation=504),
        _x("kernel", "orphan_kernel", 4000, 20, S, correlation=999),
    ]
    return {"schemaVersion": 1, "traceEvents": ev}


def test_kineto_trace_joins_by_launch_correlation(tmp_path):
    path = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(_kineto_trace(), f)
    anns, slices = prof.parse_trace_file(str(path))
    assert [(a["program"], a["span_id"], a["tid"]) for a in anns] == [
        ("decode", 11, 7), ("serve.step", 0, 8), ("readout", 12, 7)]
    assert [s["name"] for s in slices] == [
        "ampere_bf16_s16816gemm", "void at::native::elementwise_kernel",
        "lens_wgmma_kernel", "reduce_kernel",
        "Memcpy DtoH (Device -> Pinned)", "orphan_kernel"]
    assert "launch_ts" not in slices[-1]          # its launch is missing
    p = prof.build_profile(anns, slices)
    recs = {r["program"]: r for r in p["programs"]}
    # The graph replay's kernels ran after the decode's window closed.
    assert recs["decode"]["slices"] == 2
    assert recs["decode"]["joined"] == "correlation"
    assert recs["decode"]["device_seconds"] == pytest.approx(400e-6)
    assert recs["decode"]["device_seconds"] > recs["decode"]["window_seconds"]
    # Launched by thread 8 inside thread 7's decode window: thread 8's.
    assert recs["serve.step"]["slices"] == 1
    assert recs["serve.step"]["device_seconds"] == pytest.approx(50e-6)
    assert recs["readout"]["slices"] == 2
    assert recs["readout"]["device_seconds"] == pytest.approx(90e-6)
    assert p["unattributed"] == {"seconds": pytest.approx(20e-6), "groups": 1}
    dev = p["device"]
    assert dev["busy_seconds"] == pytest.approx(560e-6)
    assert dev["busy_union_seconds"] == pytest.approx(560e-6)
    assert dev["capture_seconds"] == pytest.approx(3020e-6)
    assert dev["idle_share"] == pytest.approx(round(2460 / 3020, 4))
    assert {c["op"] for c in p["top_ops"]} == {s["name"] for s in slices}
    # The gemm and the lens kernel.
    assert p["op_classes"]["matmul"]["seconds"] == pytest.approx(350e-6)
    # The join invariants hold (span ids are checked against a stream).
    errors = trace_report.check_device(_dump(tmp_path, p), [])
    assert {e.split(": ", 2)[-1] for e in errors} == {
        "span_id 11 not in the event stream",
        "span_id 12 not in the event stream"}


def _dump(tmp_path, profile):
    path = str(tmp_path / prof.DEVICE_PROFILE_FILENAME)
    with open(path, "w") as f:
        json.dump(profile, f)
    return path


def test_cpu_trace_takes_the_outermost_ops_of_each_thread(tmp_path):
    ev = [
        _x("user_annotation", "tbx:nll#3", 100, 1000, 1),
        _x("cpu_op", "aten::linear", 150, 300, 1),
        _x("cpu_op", "aten::matmul", 160, 200, 1),   # nested: not counted
        _x("cpu_op", "aten::add", 500, 700, 1),      # pokes past the window
        _x("cpu_op", "aten::mul", 2000, 10, 1),      # outside any annotation
        _x("cpu_op", "aten::sum", 300, 50, 2),       # another thread
    ]
    path = tmp_path / "cpu.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    anns, slices = prof.parse_trace_file(str(path))
    assert sorted(s["name"] for s in slices) == [
        "aten::add", "aten::linear", "aten::mul", "aten::sum"]
    p = prof.build_profile(anns, slices)
    rec = p["programs"][0]
    assert rec["joined"] == "window"
    assert rec["slices"] == 3          # linear, add (clipped) and thread 2's sum
    assert rec["device_seconds"] == pytest.approx((300 + 600 + 50) / 1e6)
    assert rec["device_union_seconds"] <= rec["window_seconds"]
    assert p["unattributed"]["groups"] == 1


# ---------------------------------------------------------------------------
# build_profile against JAX's.
# ---------------------------------------------------------------------------

def test_build_profile_equals_jax_on_the_jax_fixture():
    anns, slices = jprof.parse_trace_file(
        os.path.join(JAX_FIXTURE, "trace.json.gz"))
    want = jprof.build_profile(copy.deepcopy(anns), copy.deepcopy(slices),
                               meta={"words": 2}, trace_file="t")
    got = prof.build_profile(anns, slices, meta={"words": 2}, trace_file="t")
    assert _strip(got) == _strip(want)
    assert got["fused_phase_split"]["phases"].keys() == {
        "decode", "readout", "nll"}


def _synthetic(seed):
    """Random annotations over three programs (one fused with a phase table)
    and slices of matching, foreign and unmatched modules, on two threads."""
    rng = np.random.default_rng(seed)
    anns, slices = [], []
    t = 0.0
    for i in range(12):
        prog, fn = [("decode", "greedy_decode"), ("readout", "_residual_measure"),
                    ("fused", "fused_study")][i % 3]
        t0 = t + rng.uniform(10, 200)
        t1 = t0 + rng.uniform(50, 500)
        a = {"program": prog, "span_id": i + 1, "fn": fn, "t0": t0, "t1": t1}
        if prog == "fused":
            a["phases"] = {"decode": 0.6, "readout": 0.3, "nll": 0.1}
        anns.append(a)
        start = t0 + rng.uniform(-20, 300)
        for k in range(int(rng.integers(1, 5))):
            name = ["dot.1", "copy.2", "my_fusion.3", "reduce.4", "all-reduce.5"][k]
            slices.append({"name": name, "module": f"jit_{fn}",
                           "t0": start + 40 * k, "dur": float(rng.uniform(5, 60)),
                           "tid": int(rng.integers(1, 3))})
        if i % 4 == 0:
            slices.append({"name": "mul.9", "module": "jit_other",
                           "t0": t1 + 5, "dur": 3.0, "tid": 1})
        t = t1
    slices.sort(key=lambda s: s["t0"])
    return anns, slices


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_profile_equals_jax_on_synthetic_timelines(seed):
    anns, slices = _synthetic(seed)
    want = jprof.build_profile(copy.deepcopy(anns), copy.deepcopy(slices))
    got = prof.build_profile(anns, slices)
    assert _strip(got) == _strip(want)
    for key in ("device", "op_classes", "top_ops", "phases", "unattributed",
                "fused_phase_split"):
        assert got[key] == want[key]


def test_classify_op_equals_jax_and_knows_the_cards_matmuls():
    for name in ("dot.1", "all-reduce", "copy-start", "transpose.3",
                 "sm90_xmma_gemm_bf16bf16", "void at::native::reduce_kernel",
                 "Memcpy HtoD", "fusion.2", "topk", "elementwise"):
        assert prof.classify_op(name) == jprof.classify_op(name)
    # cuBLAS's JIT gemms and the lens kernel read as "other" to JAX's
    # patterns, which name XLA's ops.
    for name in ("nvjet_tst_192x16_64x8_4x1_v_bz_NNT",
                 "void (anonymous namespace)::lens_wgmma_kernel<false>",
                 "gemv2T_kernel_val"):
        assert prof.classify_op(name) == "matmul"
        assert jprof.classify_op(name) == "other"


# ---------------------------------------------------------------------------
# The main path on the tiny stack.
# ---------------------------------------------------------------------------

def _yaml(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "model: {layer_idx: 2, top_k: 3, arch: gemma2_tiny, dtype: float32, "
        "param_dtype: float32}\n"
        "experiment: {seed: 0, max_new_tokens: 4}\n"
        "output: {save_plots: false, base_dir: res}\n"
        "word_plurals: {moon: [moon, moons], ship: [ship, ships]}\n"
        "prompts: [\"Give me a hint\", \"a clue please\"]\n")
    return str(path)


@pytest.fixture(scope="module")
def tiny():
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tg.init_params(cfg, torch.Generator().manual_seed(5),
                            device="cpu")
    return params, cfg, WordTokenizer(VOCAB, vocab_size=cfg.vocab_size)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch, tiny):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "_loader", lambda config, args: (lambda w: tiny))
    monkeypatch.setattr(cli, "_tokenizer", lambda config, args, w: tiny[2])
    monkeypatch.delenv("TBX_PROFILE", raising=False)
    monkeypatch.setenv("TBX_PROFILE_WORDS", "2")
    return tmp_path


def _run(argv):
    assert cli.main(argv) == 0


def test_profiled_main_path_passes_the_device_check(in_tmp):
    cfg = _yaml(in_tmp)
    _run(["generate", "-c", cfg, "--device", "cpu", "--words", "moon",
          "--processed-dir", "proc", "--profile"])
    assert os.environ["TBX_PROFILE"] == "1"
    _run(["logit-lens", "-c", cfg, "--device", "cpu", "--words", "moon",
          "ship", "--processed-dir", "proc", "--profile"])
    lens_dir = os.path.join("res", "seed_0", "top5_real")
    for d, programs in (("proc", {"decode", "lens", "lens.aggregate"}),
                        (lens_dir, {"decode", "lens", "lens.aggregate"})):
        path = os.path.join(d, prof.DEVICE_PROFILE_FILENAME)
        profile = prof.load_device_profile(path)
        assert {r["program"] for r in profile["programs"]} == programs
        assert all(r["slices"] >= 1 for r in profile["programs"])
        assert profile["device"]["busy_union_seconds"] <= \
            profile["device"]["capture_seconds"]
        events = os.path.join(d, "_events.jsonl")
        assert trace_report.check(events) == []
        assert trace_report.check_device(
            path, list(trace_report.iter_events(events))) == []
        assert trace_report.main([events, "--check", "--device"]) == 0
        names = {e["name"] for e in trace_report.iter_events(events)}
        assert "profile.captured" in names
    # logit-lens profiled two words: ship's from the model, moon's cached.
    assert prof.load_device_profile(os.path.join(
        lens_dir, prof.DEVICE_PROFILE_FILENAME))["capture"]["words"] == 2


def test_no_artifact_with_profiling_off(in_tmp):
    cfg = _yaml(in_tmp)
    _run(["generate", "-c", cfg, "--device", "cpu", "--words", "moon",
          "--processed-dir", "proc"])
    assert os.path.exists(os.path.join("proc", "_events.jsonl"))
    assert not os.path.exists(os.path.join("proc", prof.DEVICE_PROFILE_FILENAME))
    assert not os.path.exists(os.path.join("proc", prof.PROFILE_DIRNAME))


def test_trace_dir_keeps_a_raw_trace(in_tmp):
    cfg = _yaml(in_tmp)
    _run(["generate", "-c", cfg, "--device", "cpu", "--words", "moon",
          "--processed-dir", "proc", "--trace-dir", "raw"])
    path = prof.find_trace_file("raw")
    assert path is not None
    anns, slices = prof.parse_trace_file(path)
    # A raw trace of the whole command: its ops, and no tbx annotation
    # (those ride --profile's windows).
    assert slices and anns == []
    assert not os.path.exists(os.path.join("proc", prof.DEVICE_PROFILE_FILENAME))


def test_fused_study_profile_splits_each_launch(tmp_path, monkeypatch, tiny):
    from taboo_brittleness_tpu_torch.ops import sae as tsae
    from taboo_brittleness_tpu_torch.pipelines import interventions as tiv

    params, cfg, tok = tiny
    config = tconfig.Config(
        model=tconfig.ModelConfig(layer_idx=2, top_k=3, arch="gemma2_tiny",
                                  dtype="float32", param_dtype="float32"),
        experiment=tconfig.ExperimentConfig(seed=0, max_new_tokens=3),
        intervention=tconfig.InterventionConfig(
            budgets=(1,), random_trials=1, ranks=(1,), spike_top_k=2),
        output=tconfig.OutputConfig(save_plots=False),
        word_plurals={"moon": ["moon"]}, prompts=["Give me a hint"])
    sae = tsae.init_random(torch.Generator().manual_seed(1), cfg.hidden_size,
                           16, device="cpu")
    monkeypatch.setenv("TBX_FUSED", "1")
    monkeypatch.setenv("TBX_PROFILE", "1")
    out = str(tmp_path / "iv")
    tiv.run_intervention_studies(config, model_loader=lambda w: tiny,
                                 sae=sae, words=["moon"], output_dir=out)
    path = os.path.join(out, prof.DEVICE_PROFILE_FILENAME)
    profile = prof.load_device_profile(path)
    # The baseline and two arm launches, and the latent scoring between.
    assert {r["program"] for r in profile["programs"]} == {
        "fused", "score_latents"}
    recs = [r for r in profile["programs"] if r["program"] == "fused"]
    assert len(recs) == 3
    assert all(r["phases_in_launch"] == ["decode", "readout", "nll"]
               and r["slices"] >= 1 for r in recs)
    split = profile["fused_phase_split"]
    total = sum(c["device_seconds"] for c in split["phases"].values())
    assert total == pytest.approx(split["source_device_seconds"], rel=1e-3)
    assert split["source_device_seconds"] == pytest.approx(
        sum(r["device_seconds"] for r in recs), rel=1e-4)
    events = os.path.join(out, "_events.jsonl")
    assert trace_report.check_device(
        path, list(trace_report.iter_events(events))) == []


# ---------------------------------------------------------------------------
# The `profile` command.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["decode", "readout", "nll"])
def test_run_launch_profile_on_the_cpu(tmp_path, phase):
    res = prof.run_launch_profile(phase=phase, rows=3, prompt_len=6,
                                  new_tokens=3, trace_dir=str(tmp_path),
                                  device="cpu")
    recs = res["profile"]["programs"]
    assert [r["program"] for r in recs] == [phase]
    assert recs[0]["slices"] >= 1 and recs[0]["joined"] == "window"
    assert res["rows"] == 3 and res["aot_misses"] == 0
    assert res["lines"][0].startswith(f"top 20 ops for ONE {phase} launch")


def test_profile_command(tmp_path, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            cli.main(["profile", "--phase", "readout"])
        assert "cuda" in str(e.value)
    out = tmp_path / "p.json"
    assert cli.main(["profile", "--device", "cpu", "--phase", "readout",
                     "--rows", "2", "--prompt-len", "5", "--new-tokens", "2",
                     "--trace-dir", str(tmp_path / "raw"),
                     "--out", str(out)]) == 0
    assert prof.load_device_profile(str(out))["programs"][0]["program"] == \
        "readout"
    assert f"device profile -> {out}" in capsys.readouterr().out


def test_study_host_profile_times_the_study_stages(capsys):
    report = prof.run_study_host_profile(words=1, prompt_len=12,
                                         new_tokens=2, device="cpu")
    assert report["preset"] == "gemma2_tiny"
    (word,) = report["words"]
    assert word["calls"]["word:profword0"] == 1
    assert {"collect.device_wait", "collect.host",
            "measure_arm_sets"} <= set(word["calls"])
    assert word["lines"][0].startswith("== word 0 (capture)")
    from taboo_brittleness_tpu_torch.pipelines import interventions as tiv

    assert not hasattr(tiv.measure_arm_sets, "__wrapped__")   # unwrapped


def test_stage_timers_attribute_self_time():
    t = prof.StageTimers()
    t.enter("outer")
    t.enter("inner")
    t.exit()
    t.exit()
    assert t.count == {"outer": 1, "inner": 1}
    assert t.self_time["outer"] <= t.total["outer"]
    assert t.total["outer"] >= t.total["inner"]
