"""The port's deep pass (TBX100/TBX101): the 19 registered entry points run
eagerly at the tiny bf16 config with no TBX100, each entry's widening f32
conversions on vocab-carrying tensors equal to what the JAX package's pass
recorded (``tools/tbx_baseline.json``) unless the difference is logged in
ROADMAP.md Queue 3, the committed port baseline covering every current
finding, and the recorder neither quiet nor blind inside the wrong
functions."""

import os
import re

import pytest

from taboo_brittleness_tpu_torch.analysis import baseline as baseline_mod
from taboo_brittleness_tpu_torch.analysis import deep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BASELINE = os.path.join(REPO, "tools", "tbx_baseline.json")
PORT_BASELINE = os.path.join(REPO, "taboo_brittleness_tpu_torch", "analysis",
                             "tbx_baseline.json")
_RECORD_RE = re.compile(r"materializes (\w+)->float32 on a vocab-carrying "
                        r"operand (\([0-9, ]*\))")


@pytest.fixture(scope="module")
def results():
    """One audit of every registered entry on the CPU (the ``[tp]`` entries
    on two ``gloo`` ranks)."""
    before = os.environ.get("TBX_AOT")
    out = deep.run_entries(deep.ENTRY_POINTS)[0]
    assert os.environ.get("TBX_AOT") == before   # the pass restores it
    return out


def _sets_by_entry(findings):
    out = {}
    for f in findings:
        if f.code == "TBX101":
            src, shape = _RECORD_RE.search(f.message).groups()
            out.setdefault(f.path[len("<deep:"):-1], set()).add((src, shape))
    return out


def _jax_record():
    """Each entry's (src, shape) set as the JAX package's deep pass recorded
    it in its committed baseline."""
    import json

    with open(JAX_BASELINE) as f:
        doc = json.load(f)
    out = {}
    for entry in doc["findings"].values():
        if entry["rule"] == "TBX101":
            src, shape = _RECORD_RE.search(entry["summary"]).groups()
            out.setdefault(entry["path"][len("<deep:"):-1], set()).add(
                (src, shape))
    return out


def _queue3_bullets():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("### Queue 3")
    end = min(i for i in (text.find("\n### ", start + 1),
                          text.find("\n## ", start + 1)) if i > 0)
    return text[start:end].split("\n- ")


def test_every_entry_runs(results):
    assert list(results) == list(deep.ENTRY_NAMES)
    assert len(deep.ENTRY_NAMES) == 19
    errors = {n: r["error"] for n, r in results.items() if "error" in r}
    assert errors == {}
    assert [f for f in deep.findings_of(results) if f.code == "TBX100"] == []


def test_conversions_match_the_jax_record_or_are_logged(results):
    port = _sets_by_entry(deep.findings_of(results))
    jax = _jax_record()
    bullets = _queue3_bullets()
    assert port, "the pass records the decode's per-step unembed"
    for name in deep.ENTRY_NAMES:
        theirs = jax.get(deep.JAX_NAMES.get(name, name), set())
        ours = port.get(name, set())
        if ours == theirs:
            continue
        shapes = {shape for _, shape in ours ^ theirs}
        logged = [b for b in bullets if f"`{name}`" in b
                  and all(s in b for s in shapes)]
        assert logged, (f"{name}: port {sorted(ours)} vs JAX {sorted(theirs)} "
                        "is not logged in ROADMAP.md Queue 3")
    # The decode's [B, 1, V] f32 unembed: the same conversion, the same
    # fingerprint as the JAX baseline's.
    assert port["runtime.decode.greedy_decode"] == jax[
        "runtime.decode.greedy_decode"]


def test_committed_baseline_covers_current_findings(results):
    known = baseline_mod.load(PORT_BASELINE)
    new, old = baseline_mod.split(deep.findings_of(results), known)
    assert new == [], [f.message for f in new]
    assert old


def _injected(env):
    import torch

    logits = torch.zeros((2, 3, env.marker), dtype=torch.bfloat16,
                         device=env.device)
    return lambda: logits.float()  # tbx: f32-ok — the seeded conversion


def _broken(env):
    raise RuntimeError("registry drift")


def test_injected_conversion_is_flagged_and_a_failure_is_a_finding():
    res = deep.run_entries([("toy.injected", _injected),
                            ("toy.broken", _broken)])[0]
    findings = deep.findings_of(res)
    assert [(f.path, f.code, f.snippet) for f in findings] == [
        ("<deep:toy.injected>", "TBX101", "bfloat16->f32 (2, 3, 641)"),
        ("<deep:toy.broken>", "TBX100", "run-failure RuntimeError")]


def _kernel_twin(env):
    """A CPU call of the lens kernel's wrapper: its plain version stands in
    for the kernel (a vocab of whole 128-row tiles)."""
    import torch

    from taboo_brittleness_tpu_torch.ops import lens_kernel

    x = torch.ones((4, 8), dtype=torch.bfloat16)
    embed = torch.ones((env.marker, 8), dtype=torch.bfloat16)
    return lambda: lens_kernel.lens_stats(x, embed, 0, top_k=2)


def _kernel_twin_on(device):
    """A maker calling the kernel's plain version itself on ``device``."""
    def make(env):
        import torch

        from taboo_brittleness_tpu_torch.ops import lens_kernel

        x = torch.ones((4, 8), dtype=torch.bfloat16, device=device)
        embed = torch.ones((env.marker, 8), dtype=torch.bfloat16,
                           device=device)
        return lambda: lens_kernel.lens_stats_reference(x, embed, 0, top_k=2)
    return make


def _plain_product(env):
    """``plain_logits`` called where no kernel is launched: a real f32
    materialization on the card too."""
    import torch

    from taboo_brittleness_tpu_torch.ops import lens_kernel

    x = torch.ones((4, 8), dtype=torch.bfloat16)
    embed = torch.ones((env.marker, 8), dtype=torch.bfloat16)
    return lambda: lens_kernel.plain_logits(x, embed, dtype=torch.bfloat16)


def test_kernel_twins_are_opaque_and_only_they():
    marker = 5 * 128
    res = deep.run_entries([("toy.twin", _kernel_twin),
                            ("toy.plain", _plain_product)],
                           runs=[("cpu", marker)])[0]
    assert res["toy.twin"]["conversions"] == []
    assert res["toy.twin"]["launches"] == 0 and res["toy.twin"]["opaque"] > 0
    assert res["toy.plain"] == {"conversions": [("bfloat16", (4, marker))],
                                "launches": 0, "opaque": 0}


def test_twins_are_recorded_on_card_tensors():
    """A twin running on a device other than the CPU is no stand-in: what it
    converts is recorded, so a plain fallback on the card shows as a
    difference from the CPU run.  The meta device plays the card here."""
    marker = 5 * 128
    res = deep.run_entries([("toy.twin", _kernel_twin_on("meta"))],
                           runs=[("cpu", marker)])[0]
    assert res["toy.twin"]["opaque"] == 0
    assert ("bfloat16", (marker, 8)) in res["toy.twin"]["conversions"]


def test_card_shapes_map_back_to_the_cpu_marker():
    m = deep.CARD_MARKER
    assert m % 128 == 0 and m // 128 == deep.VOCAB_MARKER
    assert deep.map_marker((2, 1, m), m) == (2, 1, 641)
    assert deep.map_marker((m, 32), m) == (641, 32)
    assert deep.map_marker((2, 3, 32), m) == (2, 3, 32)


def test_entry_names_cover_the_jax_registry():
    """The 19 counterparts of the JAX checker's ``ENTRY_POINTS``, in its
    order, under the JAX names where the port's function is named alike."""
    from taboo_brittleness_tpu.analysis.deep import ENTRY_POINTS as JAX_ENTRIES

    assert [deep.JAX_NAMES.get(n, n) for n in deep.ENTRY_NAMES] == [
        n for n, _ in JAX_ENTRIES]
    assert "greedy_decode" in deep.entry_point_names()
    assert "_teacher_forced_nll_cached" in deep.entry_point_names()
