"""Deep mode: dispatch-level vocab-dtype audit of the registered entry points.

The AST rules see *source*; this pass sees what torch actually dispatches.
It runs a registry of the port's entry points (:data:`ENTRY_POINTS`, the
counterparts of the JAX checker's 19) eagerly (``TBX_AOT=0``) at a tiny
Gemma-2 config in bf16 whose vocabulary is a distinctive marker dim, under
a ``TorchDispatchMode`` that records every widening conversion to f32
(``<4``-byte source) whose operand shape carries the marker: ``aten._to_copy``
and the ``aten.to`` family, ``aten.copy_`` into an f32 tensor, and any op
given ``dtype=torch.float32``.  That is exactly the [L, S, V] f32
materialization hazard (~1.16 GB/prompt at the real 256k vocab) surfacing
where an AST rule cannot follow it.

- The ``[tp]`` entries run the serve programs on two ``gloo`` ranks
  (``parallel.multihost.run_ranks``) at vocab ``2 x marker``, so each rank's
  shard keeps the marker dim (the JAX checker's ``_mesh_dims``).
- The lens kernels' plain twins are opaque for CPU tensors: nothing on a
  CPU operand is recorded inside ``ops.lens_kernel.lens_stats_reference`` /
  ``lens_stats_partials_reference``, nor inside ``plain_logits`` when a
  function that launches the kernel (its code names ``lens_stats`` or
  ``lens_stats_partials``) calls it.  On the card that work happens inside
  one launch and no ``[N, V]`` tensor exists; a twin that runs there on
  card tensors is recorded like any other code, so a plain fallback shows.
- An entry that fails to run is a TBX100 finding, never a skip.

On the card (``chip_smoke.py --deep``) the same registry runs at marker
``641 x 128`` (the kernels take whole ``BLOCK_V`` tiles only), and each
entry's conversions, the marker mapped back, must equal the CPU's, and
each entry whose CPU run went through a twin must launch the kernel there:
the check that the CPU model with opaque twins is what the card does.

Known-intentional conversions (the lens softmax must be f32; the tensor is
transient inside one step) are kept out of the gate via the committed
baseline (``analysis/tbx_baseline.json``), not pragmas — dispatch findings
have no source line to pragma.  Paths and snippets are the JAX checker's
(``<deep:runtime.decode.greedy_decode>``, ``bfloat16->f32 (2, 1, 641)``), so
a conversion both packages make has the same fingerprint in both baselines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

from taboo_brittleness_tpu_torch.analysis.core import Finding

# Distinctive vocab size: prime, and far from every other tiny-config dim,
# so "the marker appears in an operand shape" identifies vocab-carrying
# tensors with no false hits.
VOCAB_MARKER = 641
#: The marker on the card: the lens kernels take vocabularies of whole
#: 128-row tiles (``ops/lens_kernel.py`` ``BLOCK_V``).
CARD_MARKER = VOCAB_MARKER * 128

#: Registry names, in the JAX checker's order: ``module.function`` (after
#: the package), with a ``[variant]``.  ``core`` reads them as roots, and
#: TBX010 reads their bare function names; both without importing torch.
ENTRY_NAMES: Tuple[str, ...] = (
    "ops.lens.aggregate_from_residual",
    "ops.sae.latent_secret_correlation_stream",
    "runtime.decode.greedy_decode",
    "runtime.decode.greedy_decode[multi_tap]",
    "grid.runner._cell_readout",
    "pipelines.interventions._residual_measure",
    "pipelines.interventions._teacher_forced_nll_cached",
    "serve.engine.serve_step",
    "serve.engine.serve_step[tp]",
    "serve.engine.serve_step_multi",
    "serve.engine.serve_step_multi[tp]",
    "serve.spec_engine.serve_spec_draft",
    "serve.spec_engine.serve_spec_draft[tp]",
    "serve.spec_engine.serve_spec_verify",
    "serve.spec_engine.serve_spec_verify[tp]",
    "runtime.delta.apply_delta",
    "runtime.fused.fused_study",
    "runtime.speculate.draft_step",
    "runtime.speculate.verify_block",
)

#: The JAX checker's name of an entry where the port's function is named
#: otherwise (the JAX package jits ``_teacher_forced_nll_cached`` as
#: ``_nll_cached_jit``).
JAX_NAMES = {"pipelines.interventions._teacher_forced_nll_cached":
             "pipelines.interventions._nll_cached_jit"}

#: Tensor-parallel width of the ``[tp]`` entries.
TP = 2


def entry_point_names() -> frozenset:
    """Bare function names of the registered entry points — the call-site
    vocabulary rule TBX010 (``analysis/rules.py``) holds to the
    ``obs.profile.annotate`` contract.  Derived from the registry so a new
    entry point is covered the day it is registered."""
    return frozenset(n.split("[")[0].rsplit(".", 1)[1] for n in ENTRY_NAMES)


def is_tp(name: str) -> bool:
    return name.endswith("[tp]")


# ---------------------------------------------------------------------------
# The entries' inputs: a tiny bf16 model, made from a seed on a device.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Env:
    """Where an entry runs: ``device``, the vocab ``marker``, and for a
    ``[tp]`` entry the rank's mesh width (``tp``)."""

    device: Any
    marker: int = VOCAB_MARKER
    tp: int = 1

    def generator(self, seed: int = 0):
        import torch

        return torch.Generator(device=self.device).manual_seed(seed)

    def cfg(self):
        from taboo_brittleness_tpu_torch.models import gemma2

        # bf16 compute so widening conversions actually appear (the
        # f32-compute test config would make .float() a no-op).
        return gemma2.PRESETS["gemma2_tiny"].replace(
            vocab_size=self.marker * self.tp, dtype="bfloat16",
            param_dtype="bfloat16")

    def params(self, cfg):
        from taboo_brittleness_tpu_torch.models import gemma2

        return gemma2.init_params(cfg, self.generator(0), device=self.device)

    def sae(self, width: int, d_sae: int = 16):
        from taboo_brittleness_tpu_torch.ops import sae as sae_ops

        return sae_ops.init_random(self.generator(1), width, d_sae,
                                   device=self.device)

    def ints(self, shape, high: int, seed: int = 2):
        import torch

        return torch.randint(0, high, shape, generator=self.generator(seed),
                             device=self.device)

    def normal(self, shape, seed: int = 3, dtype=None):
        import torch

        return torch.randn(shape, generator=self.generator(seed),
                           device=self.device,
                           dtype=dtype or torch.float32)

    def mask(self, shape):
        import torch

        return torch.ones(shape, dtype=torch.bool, device=self.device)


def _prompt(env: Env, B: int, T: int, vocab: int):
    import torch

    ids = env.ints((B, T), vocab)
    valid = env.mask((B, T))
    pos = torch.arange(T, device=env.device).expand(B, T).contiguous()
    return ids, valid, pos


def _entry_lens_aggregate(env: Env) -> Callable[[], Any]:
    from taboo_brittleness_tpu_torch.ops import lens

    cfg = env.cfg()
    params = env.params(cfg)
    B, T = 2, 5
    residual = env.normal((B, T, cfg.hidden_size))
    token_ids = env.ints((B, T), cfg.vocab_size)
    mask = env.mask((B, T))
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: lens.aggregate_from_residual(
        params, cfg, residual, token_ids, mask, top_k=3)


def _entry_sae_correlation_stream(env: Env) -> Callable[[], Any]:
    import torch

    from taboo_brittleness_tpu_torch.ops import sae as sae_ops

    D, N = 16, 8
    sae = env.sae(D, 37)
    x = env.normal((N, D), dtype=torch.bfloat16)
    y = env.normal((N,), seed=4)
    w = env.normal((N,), seed=5).abs()
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: sae_ops.latent_secret_correlation_stream(sae, x, y, w,
                                                            chunk=4)


def _entry_greedy_decode(env: Env, capture=None) -> Callable[[], Any]:
    from taboo_brittleness_tpu_torch.runtime import decode

    cfg = env.cfg()
    params = env.params(cfg)
    ids, valid, pos = _prompt(env, 2, 5, cfg.vocab_size)
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: decode.greedy_decode(
        params, cfg, ids, valid, pos, max_new_tokens=3,
        capture_residual_layer=capture)


def _entry_greedy_decode_multi_tap(env: Env) -> Callable[[], Any]:
    # The grid capture program (grid/runner.py capture_word_residuals): ONE
    # decode tapping a static TUPLE of residual layers.
    return _entry_greedy_decode(env, capture=(1, 2))


def _entry_grid_cell_readout(env: Env) -> Callable[[], Any]:
    from taboo_brittleness_tpu_torch.grid import runner as grid_runner

    D, B, T = 16, 2, 6
    sae = env.sae(D, 37)
    resid = env.normal((B, T, D))
    mask = env.mask((B, T))
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: grid_runner._cell_readout(sae, resid, mask, top_k=3)


def _entry_residual_measure(env: Env) -> Callable[[], Any]:
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv

    cfg = env.cfg()
    params = env.params(cfg)
    B, T = 2, 6
    residual = env.normal((B, T, cfg.hidden_size))
    seqs = env.ints((B, T), cfg.vocab_size)
    mask = env.mask((B, T))
    tgt = env.ints((B,), cfg.vocab_size, seed=6)
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: iv._residual_measure(params, cfg, residual, seqs, mask,
                                        tgt, top_k=3, resp_start=1)


def _entry_nll_cached(env: Env) -> Callable[[], Any]:
    import torch

    from taboo_brittleness_tpu_torch.pipelines import interventions as iv

    cfg = env.cfg()
    params = env.params(cfg)
    B, T, s = 2, 6, 2
    kv_shape = (cfg.num_layers, B, s, cfg.num_kv_heads, cfg.head_dim)
    ck = env.normal(kv_shape, seed=7, dtype=torch.bfloat16)
    cv = env.normal(kv_shape, seed=8, dtype=torch.bfloat16)
    cache_valid = env.mask((B, s))
    seqs, valid, pos = _prompt(env, B, T, cfg.vocab_size)
    nmask = env.mask((B, T))
    return lambda: iv._teacher_forced_nll_cached(
        params, cfg, ck, cv, cache_valid, seqs, valid, pos, nmask,
        resp_start=s)


def _serve_engine(env: Env, *, speculative: bool = False,
                  multi: bool = False):
    """A tiny engine (``S`` 2, context 8, prompt 4, 2 latent slots, rank-2
    projection, SAE and projection at layer 1, tap at layer 2) with both
    slots admitted, lens on: its step's buffers are the entries' inputs.
    On a ``[tp]`` env the engine is this rank's of the tp group."""
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer
    from taboo_brittleness_tpu_torch.serve import engine as serve_engine
    from taboo_brittleness_tpu_torch.serve import spec_engine

    cfg = env.cfg()
    params = env.params(cfg)
    ec = serve_engine.EngineConfig(
        slots=2, max_context=8, prompt_cols=4, latent_slots=2, proj_rank=2,
        sae_layer=1, proj_layer=1, tap_layer=2)
    kw: Dict[str, Any] = dict(engine_config=ec, sae=env.sae(cfg.hidden_size),
                              tp=env.tp)
    words = ("ship", "moon")
    if multi:
        packed = [deltalib.pack_params_delta(
            params, deltalib.synthetic_word_params(cfg, params, w))
            for w in words]
        kw.update(words=words, delta_bank=deltalib.stack_bank(params, packed))
    tok = WordTokenizer(list(words), vocab_size=cfg.vocab_size)
    if speculative:
        engine = spec_engine.SpecServeEngine(params, cfg, tok, draft_layer=1,
                                             block_size=2, **kw)
    else:
        engine = serve_engine.ServeEngine(params, cfg, tok, **kw)
    for slot in range(ec.slots):
        # Admitted on every rank in place (no controller broadcast).
        engine._admit(slot, [2 + slot, 5, 7], max_new=3, latent_ids=[1, 3],
                      lens_target=4, word_id=slot % len(engine.words or (0,)))
    return engine


def _engine_call(args: Tuple[Any, ...]) -> Callable[[], Any]:
    fn, pos_args, kw = args
    return lambda: fn(*pos_args, **kw)


def _entry_serve_step(env: Env) -> Callable[[], Any]:
    # The serving subsystem's resident step program (serve/engine.py): its
    # per-step greedy readout and lens readout over the slot batch.
    return _engine_call(_serve_engine(env)._step_args())


def _entry_serve_step_multi(env: Env) -> Callable[[], Any]:
    # The multi-word serving step: a host loop over the W-word delta bank,
    # each word's params rebuilt and the same forward core run.
    return _engine_call(_serve_engine(env, multi=True)._step_args())


def _entry_serve_spec_draft(env: Env) -> Callable[[], Any]:
    # The speculative serving draft program (serve/spec_engine.py): G
    # lens-head steps over layers 0..k for the whole slot batch.
    return _engine_call(_serve_engine(env, speculative=True)._draft_args())


def _entry_serve_spec_verify(env: Env) -> Callable[[], Any]:
    # The speculative serving verify program: one full-depth forward over
    # the [S, G+1] chunk, the lens readout, the accept/emit/advance.
    return _engine_call(_serve_engine(env, speculative=True)._step_args())


def _entry_apply_delta(env: Env) -> Callable[[], Any]:
    # The base-resident word switch (runtime/delta.py): base + packed delta
    # -> the word's params, every codec the packer chose for the leaves.
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    cfg = env.cfg()
    params = env.params(cfg)
    payload, meta = deltalib.pack_params_delta(
        params, deltalib.synthetic_word_params(cfg, params, "ship"))
    payload = {name: {f: deltalib._on(a, params["embed"].device)
                      for f, a in fields.items()}
               for name, fields in payload.items()}
    codecs = deltalib.codecs_tuple(meta)
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: deltalib.apply_delta(params, payload, codecs=codecs)


def _entry_fused_study(env: Env) -> Callable[[], Any]:
    # The fused study program (runtime/fused.py): decode + tap readout +
    # cached NLL as one launch, in arms mode (edit + baseline-layout NLL).
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import fused

    cfg = env.cfg()
    params = env.params(cfg)
    B, Tp, N = 2, 4, 2
    T = Tp + N
    ep = {"sae": env.sae(cfg.hidden_size), "layer": 2,
          "latent_ids": env.ints((B, 2), 16, seed=9)}
    ids, valid, pos = _prompt(env, B, Tp, cfg.vocab_size)
    tgt = env.ints((B,), cfg.vocab_size, seed=6)
    ns, nv, np_ = _prompt(env, B, T, cfg.vocab_size)
    nm = env.mask((B, T))
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: fused.fused_study(
        params, cfg, ids, valid, pos, ep, tgt, ns, nv, np_, nm,
        max_new_tokens=N, edit_fn=iv.sae_ablation_edit, tap_layer=2,
        top_k=3, nll_edit=True)


def _spec_state(env: Env):
    """The speculative decoder's buffers after its prefill (B 2, Tp 4, N 3,
    G 2, k 1, the residual captured at layer 2)."""
    from taboo_brittleness_tpu_torch.runtime import speculate
    from taboo_brittleness_tpu_torch.runtime.decode import STOP_IDS

    cfg = env.cfg()
    params = env.params(cfg)
    B, Tp, N, G, k = 2, 4, 3, 2, 1
    st = speculate._spec_buffers(cfg, B, Tp, N, G, k, STOP_IDS, True,
                                 params["embed"].device, False,
                                 cfg.num_kv_heads)
    ids, valid, pos = _prompt(env, B, Tp, cfg.vocab_size)
    speculate.spec_prefill(params, cfg, st, ids, valid, pos, draft_layer=k,
                           capture_residual_layer=2)
    return params, cfg, st, k


def _entry_spec_draft_step(env: Env) -> Callable[[], Any]:
    # The speculative decoder's draft program (runtime/speculate.py): G
    # single-token forwards over layers 0..k, each a lens argmax.
    from taboo_brittleness_tpu_torch.runtime import speculate

    params, cfg, st, k = _spec_state(env)
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: speculate.draft_step(params, cfg, st, draft_layer=k)


def _entry_spec_verify_block(env: Env) -> Callable[[], Any]:
    # The speculative decoder's verify program: one full-depth forward over
    # the G+1 chunk, the argmax readout and the in-place acceptance.
    from taboo_brittleness_tpu_torch.runtime import speculate

    params, cfg, st, _ = _spec_state(env)
    # tbx: annotate-ok — the registry calls its entries by construction
    return lambda: speculate.verify_block(params, cfg, st,
                                          capture_residual_layer=2)


_MAKERS: Dict[str, Callable[[Env], Callable[[], Any]]] = {
    "ops.lens.aggregate_from_residual": _entry_lens_aggregate,
    "ops.sae.latent_secret_correlation_stream": _entry_sae_correlation_stream,
    "runtime.decode.greedy_decode": _entry_greedy_decode,
    "runtime.decode.greedy_decode[multi_tap]": _entry_greedy_decode_multi_tap,
    "grid.runner._cell_readout": _entry_grid_cell_readout,
    "pipelines.interventions._residual_measure": _entry_residual_measure,
    "pipelines.interventions._teacher_forced_nll_cached": _entry_nll_cached,
    "serve.engine.serve_step": _entry_serve_step,
    "serve.engine.serve_step_multi": _entry_serve_step_multi,
    "serve.spec_engine.serve_spec_draft": _entry_serve_spec_draft,
    "serve.spec_engine.serve_spec_verify": _entry_serve_spec_verify,
    "runtime.delta.apply_delta": _entry_apply_delta,
    "runtime.fused.fused_study": _entry_fused_study,
    "runtime.speculate.draft_step": _entry_spec_draft_step,
    "runtime.speculate.verify_block": _entry_spec_verify_block,
}

#: Entry registry: (name, make).  ``make`` builds the entry's inputs on
#: ``env`` (outside the recorder) and returns the call to audit; a ``[tp]``
#: entry is its base entry on a rank of the tp group.
ENTRY_POINTS: List[Tuple[str, Callable[[Env], Callable[[], Any]]]] = [
    (name, _MAKERS[name[:-len("[tp]")] if is_tp(name) else name])
    for name in ENTRY_NAMES]


# ---------------------------------------------------------------------------
# The recorder.
# ---------------------------------------------------------------------------

_TWIN_NAMES = ("lens_stats_reference", "lens_stats_partials_reference")
_KERNEL_WRAPPERS = {"lens_stats", "lens_stats_partials"}


def _twin_codes() -> Tuple[Set[Any], Any]:
    from taboo_brittleness_tpu_torch.ops import lens_kernel

    return ({getattr(lens_kernel, n).__code__ for n in _TWIN_NAMES},
            lens_kernel.plain_logits.__code__)


def _inside_twin(frame, twins: Set[Any], plain: Any) -> bool:
    """Whether the Python stack at ``frame`` is inside a plain twin standing
    in for a lens kernel."""
    while frame is not None:
        code = frame.f_code
        if code in twins:
            return True
        if code is plain:
            caller = frame.f_back
            if caller is not None and _KERNEL_WRAPPERS & set(
                    caller.f_code.co_names):
                return True
        frame = frame.f_back
    return False


def _widening(func, args, kwargs) -> Optional[Tuple[Any, Any]]:
    """(operand, source dtype) when this dispatched op converts a ``<4``-byte
    tensor to f32, else None."""
    import torch

    f32 = torch.float32
    name = func.overloadpacket.__name__
    src = None
    if name in ("_to_copy", "to", "_to_copy_", "type"):
        dtype = kwargs.get("dtype")
        if dtype is None:
            dtype = next((a for a in args[1:] if isinstance(a, torch.dtype)),
                         None)
        if dtype == f32 and args and isinstance(args[0], torch.Tensor):
            src = args[0]
    elif name == "copy_" and len(args) >= 2:
        dst, other = args[0], args[1]
        if (isinstance(dst, torch.Tensor) and isinstance(other, torch.Tensor)
                and dst.dtype == f32):
            src = other
    elif kwargs.get("dtype") == f32:
        src = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if src is None or src.dtype == f32 or src.element_size() >= 4:
        return None
    return src, src.dtype


def _recorder(marker: int, seen: List[Tuple[str, Tuple[int, ...]]]):
    """A ``TorchDispatchMode`` appending ``(src dtype name, operand shape)``
    of each widening f32 conversion on a marker-shaped operand to ``seen``,
    deduplicated; one on a CPU operand inside a twin is counted in its
    ``opaque`` instead."""
    from torch.utils._python_dispatch import TorchDispatchMode

    twins, plain = _twin_codes()

    class _Recorder(TorchDispatchMode):
        opaque = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            hit = _widening(func, args, kwargs)
            if hit is not None:
                operand, dtype = hit
                shape = tuple(int(d) for d in operand.shape)
                twin = (marker in shape and operand.device.type == "cpu"
                        and _inside_twin(sys._getframe(), twins, plain))
                key = (str(dtype).replace("torch.", ""), shape)
                if twin:
                    self.opaque += 1
                elif marker in shape and key not in seen:
                    seen.append(key)
            return func(*args, **kwargs)

    return _Recorder()


@contextlib.contextmanager
def _eager():
    """``TBX_AOT=0`` for the pass: every entry steps eagerly, nothing is
    captured or keyed (the registry's pools are left as they were)."""
    prev = os.environ.get("TBX_AOT")
    os.environ["TBX_AOT"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("TBX_AOT", None)
        else:
            os.environ["TBX_AOT"] = prev


def audit(name: str, build: Callable[[Env], Callable[[], Any]],
          env: Env) -> Dict[str, Any]:
    """Run one entry on ``env`` under the recorder: ``{"conversions":
    [(src, shape), ...], "launches": n, "opaque": m}`` (``n``: the lens
    kernel's launches in the call, 0 on the CPU; ``m``: the conversions
    left unrecorded inside a twin), or ``{"error": "<type>: <message>"}``."""
    import torch

    from taboo_brittleness_tpu_torch.ops import lens_kernel

    try:
        with _eager(), torch.no_grad():
            call = build(env)
            seen: List[Tuple[str, Tuple[int, ...]]] = []
            launches = lens_kernel.lens_stats.launches
            recorder = _recorder(env.marker, seen)
            with recorder:
                call()
            launches = lens_kernel.lens_stats.launches - launches
            if str(env.device).startswith("cuda"):
                torch.cuda.synchronize(env.device)
    except Exception as e:  # registry drift is a finding, not a crash
        return {"error": f"{type(e).__name__}: {e}"}
    return {"conversions": seen, "launches": launches,
            "opaque": recorder.opaque}


def tp_rank(rank: int, job: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A rank of the ``[tp]`` entries: each of ``job["names"]`` on this
    rank's shard of the group, once per ``(device, marker)`` of
    ``job["runs"]``.  Rank 0 returns ``{run index: {name: audit}}``."""
    out: Dict[int, Dict[str, Any]] = {}
    makers = dict(ENTRY_POINTS)
    for i, (device, marker) in enumerate(job["runs"]):
        env = Env(device=device, marker=marker, tp=TP)
        out[i] = {name: audit(name, makers[name], env)
                  for name in job["names"]}
    return out if rank == 0 else None


def run_entries(entries: Iterable[Tuple[str, Callable]], *,
                runs: Iterable[Tuple[Any, int]] = (("cpu", VOCAB_MARKER),)
                ) -> List[Dict[str, Dict[str, Any]]]:
    """Audit ``entries`` once per ``(device, marker)`` of ``runs``: the
    ``[tp]`` ones in one spawn of :data:`TP` ranks (``gloo``; on the card
    both ranks share it), which runs while the single-process ones run
    here.  Returns one ``{name: audit}`` per run."""
    from concurrent.futures import ThreadPoolExecutor

    runs = [(str(d), int(m)) for d, m in runs]
    entries = list(entries)
    tp_names = [name for name, _ in entries if is_tp(name)]
    results: List[Dict[str, Dict[str, Any]]] = [{} for _ in runs]
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = None
        if tp_names:
            from taboo_brittleness_tpu_torch.parallel.multihost import run_ranks

            device = next((d for d, _ in runs if d.startswith("cuda")), "cpu")
            ranks = pool.submit(run_ranks, tp_rank, TP,
                                {"names": tp_names, "runs": runs},
                                device=device)
        for i, (device, marker) in enumerate(runs):
            env = Env(device=device, marker=marker)
            for name, build in entries:
                if not is_tp(name):
                    results[i][name] = audit(name, build, env)
        if ranks is not None:
            try:
                by_run = ranks.result()[0]
            except Exception as e:  # the spawn failed: each of its entries did
                by_run = {i: {name: {"error": f"{type(e).__name__}: {e}"}
                              for name in tp_names} for i in range(len(runs))}
            for i in range(len(runs)):
                results[i].update(by_run[i])
    return [{name: r[name] for name, _ in entries} for r in results]


def findings_of(results: Dict[str, Dict[str, Any]],
                marker: int = VOCAB_MARKER) -> List[Finding]:
    """TBX101 per recorded conversion, TBX100 per entry that failed."""
    findings: List[Finding] = []
    for name, res in results.items():
        if "error" in res:
            findings.append(Finding(
                path=f"<deep:{name}>", line=0, col=0,
                code="TBX100", alias="deep-entry",
                message=f"entry point failed to run: {res['error']}",
                snippet=f"run-failure {res['error'].split(':')[0]}"))
            continue
        for src, shape in res["conversions"]:
            findings.append(Finding(
                path=f"<deep:{name}>", line=0, col=0,
                code="TBX101", alias="deep-f32",
                message=(f"dispatch materializes {src}->float32 on a "
                         f"vocab-carrying operand {shape} (vocab marker dim "
                         f"{marker}); at the real 256k vocab this is the "
                         "GB-scale f32 tensor — keep it transient or "
                         "baseline it as reviewed"),
                snippet=f"{src}->f32 {shape}"))
    return findings


def map_marker(shape: Iterable[int], marker: int) -> Tuple[int, ...]:
    """``shape`` with each multiple of ``marker`` mapped to the same
    multiple of :data:`VOCAB_MARKER` (a card run's shapes in the CPU
    run's terms)."""
    return tuple(d // marker * VOCAB_MARKER if d and d % marker == 0 else d
                 for d in shape)


def run_deep(entries: Iterable[Tuple[str, Callable]] = None) -> List[Finding]:
    """Run each registered entry point on the CPU and return TBX101
    findings for vocab-dim f32 materializations (TBX100 if an entry fails
    to run — a broken registry must fail the gate, not skip silently)."""
    results = run_entries(entries if entries is not None else ENTRY_POINTS)
    return findings_of(results[0])
