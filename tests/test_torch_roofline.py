"""The port's ``perf/roofline.py`` against the JAX package's on the same
configurations (``gemma2_9b``, ``gemma2_bench``, ``gemma2_tiny``): every
ported function returns the same numbers (exactly: the same float
arithmetic in the same order); the H100 spec gives the lens-kernel bounds
PERF.md states (2.115 ms at the main path's N 1140, 0.548 ms at the serve
readout's N 8), and ``runtime.fused.phase_table`` equals JAX's on the CPU.
"""

import pytest
import torch

from taboo_brittleness_tpu.models import gemma2 as jg
from taboo_brittleness_tpu.perf import roofline as jroof
from taboo_brittleness_tpu.runtime import fused as jfused
from taboo_brittleness_tpu_torch.models import gemma2 as tg
from taboo_brittleness_tpu_torch.perf import roofline as troof
from taboo_brittleness_tpu_torch.runtime import fused as tfused

PRESETS = ("gemma2_9b", "gemma2_bench", "gemma2_tiny")
H100 = "NVIDIA H100 80GB HBM3"
# (rows, prompt_len, new_tokens, sae_width): the study's launches, a main
# path word, and a tiny one.
SHAPES = ((330, 64, 50, 16384), (10, 64, 50, 0), (4, 8, 4, 32))


def _cfgs(preset):
    return tg.PRESETS[preset], jg.PRESETS[preset]


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_HBM_GBPS", raising=False)


def test_presets_carry_the_same_dims():
    for preset in PRESETS:
        t, j = _cfgs(preset)
        for f in ("hidden_size", "intermediate_size", "num_heads",
                  "num_kv_heads", "head_dim", "num_layers", "vocab_size",
                  "dtype", "param_dtype"):
            assert getattr(t, f) == getattr(j, f), (preset, f)


@pytest.mark.parametrize("preset", PRESETS)
def test_accounts_equal_jax(preset):
    t, j = _cfgs(preset)
    assert troof.param_count(t) == jroof.param_count(j)
    for shape in SHAPES:
        assert troof.phase_flops(t, *shape) == jroof.phase_flops(j, *shape)
        assert troof.arm_flops(t, *shape) == jroof.arm_flops(j, *shape)
        assert (troof.sweep_phase_bytes(t, *shape)
                == jroof.sweep_phase_bytes(j, *shape))
        for chunk in (1, 7):
            assert (troof.sweep_phase_bytes(t, *shape, readout_chunk=chunk)
                    == jroof.sweep_phase_bytes(j, *shape, readout_chunk=chunk))


def test_param_count_matches_the_ports_params():
    cfg = tg.PRESETS["gemma2_tiny"]
    params = tg.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert tg.num_params(params) == troof.param_count(cfg)


def test_default_readout_chunk_equals_jax_and_the_ports_pipeline():
    from taboo_brittleness_tpu_torch.pipelines.interventions import _row_chunk

    for t_cols, vocab in [(5, 199), (51, 256000), (82, 256000), (1, 7)]:
        got = troof.default_readout_chunk(t_cols, vocab)
        assert got == jroof.default_readout_chunk(t_cols, vocab)
        assert got == _row_chunk(t_cols, vocab)


def _both(spec):
    return spec, jroof.RooflineSpec(spec.kind, spec.peak_tflops, spec.hbm_gbps)


@pytest.mark.parametrize("measured", [None, 0.0, 0.0123, 4.0])
def test_phase_report_equals_jax(measured):
    t, j = _both(troof.device_spec(H100))
    for flops, bytes_ in ((2e12, 1e9), (1.5e10, 1.8e9), (0.0, 1.0)):
        assert (troof.phase_report(flops, bytes_, t, measured)
                == jroof.phase_report(flops, bytes_, j, measured))


@pytest.mark.parametrize("preset", PRESETS)
def test_sweep_roofline_equals_jax(preset):
    tc, jc = _cfgs(preset)
    t, j = _both(troof.device_spec(H100))
    measured = {"decode": 1.6, "readout": 0.49, "nll": 0.8}
    for shape in SHAPES:
        assert (troof.sweep_roofline(tc, *shape, measured, t)
                == jroof.sweep_roofline(jc, *shape, measured, j))
    assert troof.sweep_roofline(tc, *SHAPES[0], measured, None) is None


def test_h100_spec_and_overrides(monkeypatch):
    spec = troof.device_spec(H100)
    assert (spec.peak_tflops, spec.hbm_gbps) == (989.0, 3350.0)
    assert spec.peak_flops == 989e12 and spec.hbm_bytes_per_s == 3350e9
    # No TPU row, and no spec without a card (this machine has none).
    assert set(troof.DEVICE_SPECS) == {H100}
    assert troof.device_spec("TPU v5e") is None
    assert troof.device_spec(troof.device_name()) is None
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    assert troof.device_spec(H100).peak_tflops == 500.0
    assert troof.device_spec(None) is None        # half an override is no spec
    monkeypatch.setenv("BENCH_HBM_GBPS", "2000")
    for kind in (H100, None, "other"):
        got = troof.device_spec(kind)
        want = jroof.device_spec(kind)
        assert (got.peak_tflops, got.hbm_gbps) == (500.0, 2000.0)
        assert want is not None and (want.peak_tflops, want.hbm_gbps) == (
            500.0, 2000.0)


@pytest.mark.parametrize("n,k,bound_ms,bound_by", [
    (1140, 5, 2.115, "compute"),   # the main path's lens_stats call
    (8, 1, 0.548, "memory"),       # the serve step's readout
])
def test_h100_bounds_of_the_lens_kernel(n, k, bound_ms, bound_by):
    """PERF.md's bounds of one ``lens_stats`` call (D 3584, V 256000):
    2 N D V multiply-adds at the bf16 peak against bf16 x and E read once,
    int32 targets and f32/int32 results written once."""
    d, v = 3584, 256000
    flops = 2 * n * d * v
    moved = 2 * n * d + 2 * v * d + 4 * n + 4 * n * (2 + 2 * k)
    rep = troof.phase_report(flops, moved, troof.device_spec(H100))
    assert rep["bound"] == bound_by
    assert round(rep["ceiling_seconds"] * 1e3, 3) == bound_ms


def test_phase_table_equals_jax_on_the_cpu():
    """Without a card neither package has a spec, so both weight the fused
    phases by their FLOPs share."""
    for preset in ("gemma2_tiny", "gemma2_bench"):
        tc, jc = _cfgs(preset)
        for shape in SHAPES:
            got = tfused.phase_table(tc, *shape)
            assert got == jfused.phase_table(jc, *shape)
            assert list(got) == list(tfused.FUSED_PHASES)
            assert sum(got.values()) == pytest.approx(1.0, abs=1e-3)


def test_phase_table_weighs_by_the_h100_ceilings(monkeypatch):
    """On an H100 (its name stood in here) the weights are each phase's
    ceiling share from the H100 spec."""
    monkeypatch.setattr(troof, "device_name", lambda: H100)
    cfg = tg.PRESETS["gemma2_bench"]
    shape = SHAPES[0]
    spec = troof.device_spec(H100)
    f = troof.phase_flops(cfg, *shape)
    b = troof.sweep_phase_bytes(cfg, *shape)
    pred = {p: max(f[p] / spec.peak_flops, b[p] / spec.hbm_bytes_per_s)
            for p in tfused.FUSED_PHASES}
    total = sum(pred.values())
    assert tfused.phase_table(cfg, *shape) == {
        p: round(pred[p] / total, 4) for p in tfused.FUSED_PHASES}
