"""The TBX001..TBX010 AST rules, in the port's idiom.

Each rule is a small class with ``code`` / ``alias`` / ``summary`` and a
``check(ctx, repo)`` generator over :class:`~.core.Finding`.  Rules are
deliberately narrow: the gate must hold the port at zero unsuppressed
findings (``tests/test_torch_analysis.py``), so precision beats recall —
every widening of a rule is paid for in pragmas.

"Traced" code is the reach of a replayed step's roots (``core``): what a
CUDA graph captures, the entry a launch keys, and the deep registry's entry
points.  TBX003 (buffer donation) and TBX004 (``static_argnames``) check
arguments of ``jax.jit``, which the port does not have: they are listed in
:data:`JAX_ONLY` and check nothing here.

Suppress any finding with ``# tbx: <code-or-alias>-ok — <reason>`` on the
violating line or the line directly above.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set

from taboo_brittleness_tpu_torch.analysis.core import (
    PKG_MARKER, Finding, FunctionLike, ModuleContext, fn_name)


# ---------------------------------------------------------------------------
# Repo-level context shared by all modules (declared mesh axes).
# ---------------------------------------------------------------------------

_DEFAULT_AXES = frozenset({"dp", "tp", "sp"})


def _axes_from_mesh_module(path: str) -> Optional[frozenset]:
    """The strings of ``AXES = (...)`` in the port's ``parallel/mesh.py``
    (``AXES = ("dp", "tp", "sp")``) — the single source of truth for which
    logical axes exist."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    axes: Set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "AXES"
                        for t in node.targets)):
            for const in _string_constants(node.value):
                axes.add(const.value)
    return frozenset(axes) or None


@dataclasses.dataclass(frozen=True)
class RepoContext:
    """Cross-module facts the rules need (currently: the mesh axis names)."""

    mesh_axes: frozenset = _DEFAULT_AXES

    @classmethod
    def discover(cls, paths: Sequence[str] = ()) -> "RepoContext":
        """Axis names from the port's ``parallel/mesh.py`` (located relative
        to the analysis package, so the gate works from any cwd)."""
        mesh_py = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "parallel", "mesh.py")
        axes = _axes_from_mesh_module(mesh_py)
        return cls(mesh_axes=axes or _DEFAULT_AXES)


# ---------------------------------------------------------------------------
# Shared AST helpers.
# ---------------------------------------------------------------------------

def _top_level_traced(ctx: ModuleContext) -> List[FunctionLike]:
    """Traced functions whose parent is NOT traced — walking each exactly
    once covers every traced line without double-reporting nested defs."""
    return [fn for fn in ctx.traced if ctx.parents.get(fn) not in ctx.traced]


def _string_constants(node: ast.expr) -> Iterator[ast.Constant]:
    """String literals in an expression, descending through tuples/lists."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _string_constants(elt)


_EXEMPT_MARKER = PKG_MARKER + "analysis/"


def _in_package(rel: str) -> bool:
    """The port's package, outside this ``analysis/`` subpackage (the
    checker's stdout is its interface, and its deep registry calls entries
    by construction)."""
    rel = rel.replace(os.sep, "/")
    if _EXEMPT_MARKER in rel:
        return False
    return PKG_MARKER in rel or rel.startswith("taboo_brittleness_tpu_torch")


# ---------------------------------------------------------------------------
# TBX001 — host sync inside traced code.
# ---------------------------------------------------------------------------

#: Tensor methods that copy to the host (no arguments).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
_SYNC_CALLS = {"torch.cuda.synchronize": "torch.cuda.synchronize()",
               "torch.nonzero": "torch.nonzero()"}
_SCALAR_CASTS = {"bool", "int", "float"}
#: Method calls read as a tensor's (a reduction or a comparison): a Python
#: scalar cast of one reads the device.
_TENSOR_RESULT_METHODS = {
    "sum", "max", "min", "any", "all", "mean", "argmax", "argmin", "prod",
    "amax", "amin", "norm", "count_nonzero", "eq", "ne", "lt", "le", "gt",
    "ge", "abs", "std", "var"}


class HostSyncRule:
    """``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.nonzero()``, a device-wide ``torch.cuda.synchronize()``, or
    ``bool/int/float(<tensor>)`` in a function reachable from a replayed
    step's root: each waits for the card.  Inside a CUDA-graph capture a
    sync raises or, device-wide, invalidates the capture of another thread
    (the fault ``runtime/aot.py`` records); in an eager step it serializes
    the host on the device queue once per step."""

    code = "TBX001"
    alias = "host-sync"
    summary = ("host sync (.item()/.tolist()/.cpu()/.numpy()/.nonzero()/"
               "torch.cuda.synchronize()/bool|int|float(tensor)) in traced code")

    def _tensor_names(self, ctx: ModuleContext, fn: FunctionLike) -> Set[str]:
        """Names that hold tensors in ``fn``: parameters annotated
        ``torch.Tensor`` and locals assigned from a ``torch.*`` call."""
        names: Set[str] = set()
        a = fn.args
        for p in [*getattr(a, "posonlyargs", []), *a.args, *a.kwonlyargs]:
            if p.annotation is not None and (ctx.dotted(p.annotation) or "") \
                    == "torch.Tensor":
                names.add(p.arg)
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and (ctx.dotted(node.value.func) or "").startswith("torch.")):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        return names

    def _is_tensor(self, ctx: ModuleContext, node: ast.expr,
                   tensors: Set[str]) -> bool:
        if isinstance(node, ast.Call):
            name = ctx.dotted(node.func) or ""
            if name.startswith("torch.") and not name.startswith(
                    ("torch.cuda.", "torch.backends.")):
                return True
            return (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_RESULT_METHODS)
        if isinstance(node, ast.Subscript):
            return self._is_tensor(ctx, node.value, tensors)
        if isinstance(node, ast.Compare):
            return any(self._is_tensor(ctx, n, tensors)
                       for n in [node.left, *node.comparators])
        if isinstance(node, ast.UnaryOp):
            return self._is_tensor(ctx, node.operand, tensors)
        return isinstance(node, ast.Name) and node.id in tensors

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        for fn in _top_level_traced(ctx):
            tensors = self._tensor_names(ctx, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = ctx.dotted(node.func)
                what = None
                if name in _SYNC_CALLS:
                    what = _SYNC_CALLS[name]
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_METHODS and not node.args
                        and not node.keywords):
                    what = f".{node.func.attr}()"
                elif (isinstance(node.func, ast.Name)
                        and node.func.id in _SCALAR_CASTS
                        and len(node.args) == 1
                        and self._is_tensor(ctx, node.args[0], tensors)):
                    what = f"{node.func.id}(<tensor>)"
                if what is None:
                    continue
                yield ctx.finding(
                    node, self.code, self.alias,
                    f"{what} inside traced function `{fn_name(fn)}` — waits "
                    "for the card (and breaks or invalidates a CUDA-graph "
                    "capture); keep the step host-free and pull results "
                    "once, batched, outside it")


# ---------------------------------------------------------------------------
# TBX002 — vocab-scale f32 materialization.
# ---------------------------------------------------------------------------

_F32_NAMES = {"torch.float32", "torch.float", "numpy.float32"}
_RNG_DRAWS = {"random", "normal", "integers", "uniform", "standard_normal",
              "rand", "randn", "choice", "randint", "rand_like", "randn_like"}
_VOCAB_NAME_RE = re.compile(r"(^|_)(all_)?(logits?|probs?|vocab)(_|$)", re.I)
# A shape comment carrying a vocab dim: "[B, T, V]", "[L,S,V]", "[b, T, V/tp]".
_VOCAB_LINE_RE = re.compile(r"\[[^\]\n]{0,60}\bV\b[^\]\n]{0,20}\]|256[_,]?000|\bvocab\b",
                            re.I)


def _is_f32_arg(ctx: ModuleContext, node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and node.value == "float32":
        return True
    return ctx.dotted(node) in _F32_NAMES


def _f32_conversion(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
    """``.float()``, ``.to(torch.float32)``, ``.to(dtype=torch.float32)``
    or ``.type(torch.float32)``: the spelling, else None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    attr = node.func.attr
    if attr == "float" and not node.args and not node.keywords:
        return ".float()"
    if attr in ("to", "type"):
        if node.args and _is_f32_arg(ctx, node.args[0]):
            return f".{attr}(torch.float32)"
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_f32_arg(ctx, kw.value):
                return f".{attr}(dtype=torch.float32)"
    return None


class VocabF32Rule:
    """``.float()`` / ``.to(torch.float32)`` applied to a vocab-carrying
    tensor (name or shape comment says logits/probs/vocab or ``[.., V]``):
    one [L, S, V] f32 tensor is ~1.16 GB/prompt at Gemma-2 scale
    (PAPER.md).  Conversions that are numerically required (softmax in
    f32) stay — with an explicit ``# tbx: f32-ok — <reason>`` pragma so
    every one is a reviewed decision."""

    code = "TBX002"
    alias = "f32"
    summary = "f32 materialization of a vocab-scale tensor (.float()/.to(float32))"

    def _assign_targets(self, ctx: ModuleContext) -> Dict[int, List[str]]:
        """id(value-expression) -> assigned names, to catch
        ``logits = (x @ e.T).float()``."""
        out: Dict[int, List[str]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                if names:
                    out[id(node.value)] = names
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if isinstance(node.target, ast.Name):
                    out[id(node.value)] = [node.target.id]
        return out

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        targets = self._assign_targets(ctx)
        for node in ast.walk(ctx.tree):
            spelling = _f32_conversion(ctx, node)
            if spelling is None:
                continue
            # ``torch.randn(T, V).float()`` is fixture construction, not a
            # materialization of a model's tensor.
            recv = node.func.value
            if (isinstance(recv, ast.Call)
                    and isinstance(recv.func, ast.Attribute)
                    and recv.func.attr in _RNG_DRAWS):
                continue
            receiver_names = {
                n.id for n in ast.walk(node.func.value)
                if isinstance(n, ast.Name)}
            vocab_names = [n for n in receiver_names if _VOCAB_NAME_RE.search(n)]
            vocab_names += [n for n in targets.get(id(node), [])
                            if _VOCAB_NAME_RE.search(n)]
            hint = None
            if vocab_names:
                hint = f"`{sorted(set(vocab_names))[0]}`"
            elif _VOCAB_LINE_RE.search(ctx.line_text(node.lineno)) and (
                    id(node) in targets or not receiver_names):
                hint = "shape comment"
            if hint is None:
                continue
            yield ctx.finding(
                node, self.code, self.alias,
                f"{spelling} on a vocab-carrying tensor ({hint}): at "
                "[L,S,V] scale this is ~1.16 GB/prompt of f32 in device "
                "memory; keep bf16 or justify with `# tbx: f32-ok — <reason>`")


# ---------------------------------------------------------------------------
# TBX003, TBX004 — jax.jit arguments: JAX-only.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JaxOnlyRule:
    """A rule of the JAX checker with nothing to check in the port."""

    code: str
    alias: str
    summary: str
    reason: str


JAX_ONLY = [
    JaxOnlyRule("TBX003", "donate",
                "jit takes a KV-cache-named arg but donates no buffers",
                "buffer donation is an argument of jax.jit; the port has no "
                "jit: a program's KV cache is one pooled buffer written in "
                "place (runtime/aot.py)"),
    JaxOnlyRule("TBX004", "static-args",
                "static_argnames lists a name absent from the wrapped signature",
                "static_argnames is an argument of jax.jit; the port has no "
                "jit: a program's statics are keyed by name and value "
                "(runtime/aot.py signature)"),
]


# ---------------------------------------------------------------------------
# TBX005 — mesh-axis consistency.
# ---------------------------------------------------------------------------

_PSPEC_SUFFIX = ".PartitionSpec"
_COLLECTIVES = {
    "jax.lax.psum", "jax.lax.pmax", "jax.lax.pmin", "jax.lax.pmean",
    "jax.lax.all_gather", "jax.lax.ppermute", "jax.lax.pswapaxes",
    "jax.lax.axis_index", "jax.lax.all_to_all", "jax.lax.psum_scatter",
}
#: ``parallel.mesh.Mesh``'s collectives and axis lookups (and the mesh
#: helpers taking an ``axis=``): their string arguments are axis names.
_MESH_METHODS = {"all_reduce", "pmax", "all_gather", "axis_index",
                 "ring_shift", "local_shard_size", "tp_topk"}


class MeshAxisRule:
    """Axis strings in the port's mesh collectives (``mesh.all_gather(t,
    "tp")``, ``mesh.pmax``, ``mesh.all_reduce``, ``mesh.axis_index``, an
    ``axis=`` / ``axis_name=`` keyword; and ``PartitionSpec``/lax
    collectives, as the JAX checker reads them) must be axes declared in
    ``parallel/mesh.py`` ``AXES`` — a typo'd axis fails only at run time on
    a real mesh, long after CI."""

    code = "TBX005"
    alias = "mesh-axis"
    summary = "mesh collective/axis string not declared in parallel/mesh.py AXES"

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        axes = repo.mesh_axes
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.dotted(node.func) or ""
            method = (node.func.attr if isinstance(node.func, ast.Attribute)
                      else name)
            check_args = (name.endswith(_PSPEC_SUFFIX)
                          or name in _COLLECTIVES
                          or method in _MESH_METHODS)
            if check_args:
                for arg in node.args:
                    for const in _string_constants(arg):
                        if const.value not in axes:
                            yield self._finding(ctx, const, axes)
            for kw in node.keywords:
                if (kw.arg == "axis_name" or (kw.arg == "axis" and method
                                              in _MESH_METHODS)) \
                        and kw.value is not None:
                    for const in _string_constants(kw.value):
                        if const.value not in axes:
                            yield self._finding(ctx, const, axes)

    def _finding(self, ctx: ModuleContext, const: ast.Constant,
                 axes: frozenset) -> Finding:
        return ctx.finding(
            const, self.code, self.alias,
            f"mesh axis '{const.value}' is not declared in parallel/mesh.py "
            f"(declared: {sorted(axes)}) — this fails only at run time on a "
            "real mesh")


# ---------------------------------------------------------------------------
# TBX006 — nondeterminism inside traced code.
# ---------------------------------------------------------------------------

_CLOCK_CALLS = {"time.time", "time.time_ns", "time.monotonic",
                "time.perf_counter", "time.process_time"}
_TORCH_DRAWS = {"torch.rand", "torch.rand_like", "torch.randn",
                "torch.randn_like", "torch.randint", "torch.randint_like",
                "torch.randperm", "torch.multinomial", "torch.normal",
                "torch.bernoulli", "torch.poisson"}
_TENSOR_DRAWS = {"normal_", "uniform_", "random_", "bernoulli_",
                 "exponential_", "cauchy_", "log_normal_", "geometric_"}


class NondeterminismRule:
    """``time.*`` clocks, Python ``random``, unseeded ``np.random``, or a
    torch draw with no ``generator=`` inside traced code: a CUDA graph
    replays the capture's draw (or its clock) on every launch, and an
    eager step's draw comes from the global generator that anything else
    may advance.  Pass a seeded ``torch.Generator``, or draw outside the
    step and pass the values in."""

    code = "TBX006"
    alias = "nondet"
    summary = "host clock / RNG / unseeded torch draw inside traced code"

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        for fn in _top_level_traced(ctx):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = ctx.dotted(node.func) or ""
                seeded = any(kw.arg == "generator" for kw in node.keywords)
                if name in _CLOCK_CALLS:
                    what = f"{name}()"
                elif name.startswith("random."):
                    what = f"{name}() (Python random)"
                elif name.startswith("numpy.random."):
                    what = f"np.{name[6:]}() (host-side numpy RNG)"
                elif name in _TORCH_DRAWS and not seeded:
                    what = f"{name}() with no generator="
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _TENSOR_DRAWS and not seeded):
                    what = f".{node.func.attr}() with no generator="
                else:
                    continue
                yield ctx.finding(
                    node, self.code, self.alias,
                    f"{what} inside traced function `{fn_name(fn)}` — a "
                    "replayed step repeats the captured value and an eager "
                    "one draws from shared state; pass a seeded "
                    "torch.Generator (or compute it outside the step and "
                    "pass it in)")


# ---------------------------------------------------------------------------
# TBX007 — wall clock where a monotonic clock belongs.
# ---------------------------------------------------------------------------

_TIMING_NAME_RE = re.compile(
    r"^(t\d*|t_\w+|start\w*|started\w*|begin\w*|\w*_t0)$")


class WallClockRule:
    """``time.time()`` used for duration math (subtraction, a ``t0 = ...``
    start mark, or passed as a timestamp factory): wall-clock jumps under
    NTP steps/leap smears, so recorded durations can come out negative or
    wildly long.  Use ``time.monotonic()``/``perf_counter()`` for durations;
    pragma the genuine epoch-timestamp uses."""

    code = "TBX007"
    alias = "wallclock"
    summary = "time.time() used where a monotonic clock belongs"

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        call_funcs = {id(n.func) for n in ast.walk(ctx.tree)
                      if isinstance(n, ast.Call)}

        def is_time_call(node: ast.AST) -> bool:
            return (isinstance(node, ast.Call)
                    and ctx.dotted(node.func) == "time.time")

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                if is_time_call(node.left) or is_time_call(node.right):
                    yield ctx.finding(
                        node, self.code, self.alias,
                        "duration computed by subtracting time.time() — "
                        "wall clock is not monotonic; use time.monotonic() "
                        "or time.perf_counter()")
            elif (isinstance(node, ast.Attribute)
                    and ctx.dotted(node) == "time.time"
                    and id(node) not in call_funcs):
                yield ctx.finding(
                    node, self.code, self.alias,
                    "bare time.time passed as a callback/factory — if the "
                    "value feeds duration math use time.monotonic; pragma "
                    "if an epoch timestamp is genuinely intended")
            elif isinstance(node, ast.Assign) and is_time_call(node.value):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Name)
                            and _TIMING_NAME_RE.match(tgt.id)):
                        yield ctx.finding(
                            node, self.code, self.alias,
                            f"`{tgt.id} = time.time()` start mark — use "
                            "time.monotonic()/perf_counter() so the "
                            "duration survives clock adjustments")
                        break


# ---------------------------------------------------------------------------
# TBX008 — mutable defaults / captured module-level tensors.
# ---------------------------------------------------------------------------

_TENSOR_CTORS = {"tensor", "as_tensor", "zeros", "ones", "full", "empty",
                 "arange", "linspace", "eye", "from_numpy", "zeros_like",
                 "ones_like", "full_like", "empty_like"}


def _is_tensor_ctor(ctx: ModuleContext, call: ast.Call) -> bool:
    name = ctx.dotted(call.func) or ""
    head, _, last = name.rpartition(".")
    return head == "torch" and last in _TENSOR_CTORS


class CapturedConstantRule:
    """Traced functions must not carry mutable defaults (shared across every
    call and every capture) or read module-level tensor constants: a CUDA
    graph captures the constant's address on the device it was made for,
    and a default tensor is built once at def time on the CPU.  Pass
    tensors as arguments instead."""

    code = "TBX008"
    alias = "capture"
    summary = "mutable default / captured module-level tensor in traced function"

    def _module_tensor_consts(self, ctx: ModuleContext) -> Set[str]:
        consts: Set[str] = set()
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            if _is_tensor_ctor(ctx, node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        consts.add(tgt.id)
        return consts

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        tensor_consts = self._module_tensor_consts(ctx)
        for fn in ctx.traced:
            defaults = list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    yield ctx.finding(
                        d, self.code, self.alias,
                        f"mutable default in traced function `{fn_name(fn)}` "
                        "— shared across every call and capture; default to "
                        "None and build inside")
                elif isinstance(d, ast.Call) and (
                        _is_tensor_ctor(ctx, d)
                        or (ctx.dotted(d.func) or "").startswith("numpy.")):
                    yield ctx.finding(
                        d, self.code, self.alias,
                        f"tensor-valued default in traced function "
                        f"`{fn_name(fn)}` — built once at def time (on the "
                        "CPU) and captured by every step; pass it as an "
                        "argument")
        if not tensor_consts:
            return
        for fn in _top_level_traced(ctx):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Load)
                        and node.id in tensor_consts):
                    yield ctx.finding(
                        node, self.code, self.alias,
                        f"module-level tensor `{node.id}` captured by traced "
                        f"function `{fn_name(fn)}` — a graph replays its "
                        "captured address; pass it as an argument")


# ---------------------------------------------------------------------------
# TBX009 — bare print() in package code.
# ---------------------------------------------------------------------------

class BarePrintRule:
    """``print(...)`` inside the port's package: package code emits
    telemetry through ``taboo_brittleness_tpu_torch.obs`` (structured events
    + stderr mirror via ``obs.warn``), not prints — a print is invisible to
    the event stream and unparseable by tooling.

    Scope is the package only: tests and ``chip_smoke.py`` print by design,
    and the ``analysis/`` subpackage (this CLI) is exempt — its stdout IS
    its interface.  User-facing CLI output keeps an explicit
    ``# tbx: TBX009-ok — <reason>`` pragma per line."""

    code = "TBX009"
    alias = "print"
    summary = "bare print() in package code (use obs events / obs.warn)"

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        if not _in_package(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                continue
            yield ctx.finding(
                node, self.code, self.alias,
                "bare print() in package code — emit a structured event "
                "(obs.event / obs.warn mirrors to stderr) so the telemetry "
                "stream sees it; CLI stdout contracts get an explicit "
                "`# tbx: TBX009-ok — <reason>` pragma")


# ---------------------------------------------------------------------------
# TBX010 — registered entry point called outside a profiler annotation.
# ---------------------------------------------------------------------------

#: Context managers that count as an annotation: the port's helper
#: (``obs.profile.annotate``) and the torch primitive it wraps.
_ANNOTATION_CM_SUFFIXES = (".annotate", ".record_function")
_ANNOTATION_CM_NAMES = {"annotate", "record_function"}


class UnannotatedEntryCallRule:
    """A registered entry point (``analysis/deep.py`` ``ENTRY_NAMES``)
    called directly in package code with no enclosing
    ``obs.profile.annotate`` / ``torch.profiler.record_function``: its
    kernels are unattributable on the profiler timeline (obs/profile.py),
    so the device report shows its time as an anonymous gap.  Calls inside
    traced code are not launch sites and are skipped; tests,
    ``chip_smoke.py`` and the ``analysis/`` subpackage (whose deep registry
    calls entries by construction) are out of scope."""

    code = "TBX010"
    alias = "annotate"
    summary = "registered entry point called outside obs.profile.annotate/record_function"

    def _entry_names(self) -> frozenset:
        from taboo_brittleness_tpu_torch.analysis.deep import entry_point_names

        return entry_point_names()

    def _annotated_spans(self, ctx: ModuleContext) -> List[tuple]:
        spans = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                expr = item.context_expr
                if not isinstance(expr, ast.Call):
                    continue
                name = ctx.dotted(expr.func) or ""
                short = name.rsplit(".", 1)[-1]
                if (name.endswith(_ANNOTATION_CM_SUFFIXES)
                        or short in _ANNOTATION_CM_NAMES):
                    spans.append((node.lineno,
                                  getattr(node, "end_lineno", node.lineno)))
                    break
        return spans

    def check(self, ctx: ModuleContext, repo: RepoContext) -> Iterator[Finding]:
        if not _in_package(ctx.rel):
            return
        entries = self._entry_names()
        spans = self._annotated_spans(ctx)

        def annotated(lineno: int) -> bool:
            return any(a <= lineno <= b for a, b in spans)

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name not in entries:
                continue
            if ctx.enclosing_traced(node) is not None:
                continue            # a call inside a step is not a launch site
            if annotated(node.lineno):
                continue
            yield ctx.finding(
                node, self.code, self.alias,
                f"registered entry point `{name}` called without a profiler "
                "annotation — wrap the call in `with obs.profile.annotate("
                "<program>, fn=...)` so the device profiler can attribute "
                "its kernels (or pragma with the reason it must stay "
                "unannotated)")


RULES = [
    HostSyncRule(),
    VocabF32Rule(),
    MeshAxisRule(),
    NondeterminismRule(),
    WallClockRule(),
    CapturedConstantRule(),
    BarePrintRule(),
    UnannotatedEntryCallRule(),
]

RULES_BY_CODE = {r.code: r for r in RULES}
