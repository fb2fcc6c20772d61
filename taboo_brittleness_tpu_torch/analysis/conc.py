"""tbx-check conc: whole-program host-concurrency + runtime-contract pass.

The port's copy of the JAX checker's pass: the same model and rules over
the port's package, with its own fault registry (``runtime/resilience.py``
``FAULT_SITES``) and the port's tests (``tests/test_torch_*.py``) as the
tests that arm its faults.  On the port's tree the two passes give the same
findings (``tests/test_torch_analysis_conc.py``).

The device side of the port is covered by the per-module AST rules
(TBX001–TBX010) and the dispatch-level deep pass (TBX10x).  This module covers the
*host* side: the threads, locks, signal handlers, durable-artifact writers,
and the ``FAULT_SITES`` registry that grew across the resilience / fleet /
telemetry PRs.  Unlike ``rules.py`` it is whole-program: it parses every
package module into one :class:`ConcModel` and checks cross-module
invariants against it.

Rule family (pragmas ``# tbx: <code-or-alias>-ok — reason`` and baseline
fingerprints work exactly like TBX001–TBX010):

TBX201  thread-shared   attribute written on one side of a thread boundary
                        and read on the other with no common lock
TBX202  signal-handler  handler's reachable call graph acquires a lock,
                        performs I/O, or emits telemetry (handlers may only
                        set latches/Events — the tracer-lock self-deadlock
                        class)
TBX203  lock-order      cycle in the lock acquisition-order graph
TBX204  thread-leak     thread started with no reachable join path (the
                        skipped-word prefetch leak class)
TBX205  atomic-write    durable artifact written via bare ``open(.., "w")``
                        instead of the tmp+``os.replace`` protocol
TBX206  fault-site      FAULT_SITES contract drift: fired-but-unregistered,
                        registered-but-never-fired, or never armed in tests

Model scope and limits (deliberate, documented in README):

* Only ``taboo_brittleness_tpu_torch/`` modules participate; ``analysis/`` itself
  is exempt (the checker's CLI is its own I/O surface, like TBX009/TBX010).
* The call graph is module-local by name (plus ``self.X()`` within a
  class); threads spawned through executors (``ThreadPoolExecutor``) own
  their lifecycle and are out of TBX204's scope.
* TBX201 reasons per class: the "thread side" is the closure of
  ``threading.Thread(target=...)`` targets over ``self`` calls, the "main
  side" the closure of every other public entry.  Attributes that are
  threading primitives, or never written outside ``__init__``, are exempt.
  A private method whose every intra-class call site holds a lock is
  treated as lock-protected (how ``roll()``-style daemons factor helpers).
* TBX204 join evidence is token-based with aliasing: ``t, self._thread =
  self._thread, None; t.join()``, ``threads.append(t)`` + loop-join, and
  ``self._pending.pop(word).join()`` all count.
* TBX205 covers the builtin ``open``; ``os.open(..., O_APPEND)`` whole-line
  spool writes are a sanctioned protocol and not flagged.  A write is
  exempt when its enclosing function also calls ``os.replace``/``os.rename``
  or the path expression mentions ``tmp`` (the atomic idiom itself).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Set, Tuple)

from taboo_brittleness_tpu_torch.analysis.core import (
    Finding, ModuleContext, is_suppressed)

_PKG_MARKER = "taboo_brittleness_tpu_torch/"
_EXEMPT_MARKER = "taboo_brittleness_tpu_torch/analysis/"

#: The port's tests: the files TBX206 reads for a fault site's arming.
_PORT_TESTS_PREFIX = "test_torch_"

_THREAD_CTOR = "threading.Thread"
_SYNC_CTORS = {
    "threading.Thread", "threading.Lock", "threading.RLock",
    "threading.Event", "threading.Condition", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier", "threading.local",
    "concurrent.futures.ThreadPoolExecutor",
}
_LOCK_NAME_RE = re.compile(r"(^|_)(lock|mutex|rlock)s?$", re.IGNORECASE)
_MUTATORS = {"append", "add", "extend", "insert", "update", "setdefault",
             "pop", "popleft", "remove", "discard", "clear", "appendleft"}
_IO_CALLS = {
    "open", "print", "os.write", "os.remove", "os.unlink", "os.replace",
    "os.rename", "os.makedirs", "os.rmdir", "os.truncate", "shutil.rmtree",
    "shutil.copy", "shutil.move", "json.dump", "sys.stdout.write",
    "sys.stderr.write", "sys.stdout.flush", "sys.stderr.flush",
}
_TELEMETRY_ATTRS = {"event", "warn", "emit", "record", "dump", "observe",
                    "inc", "set_gauge"}
_TELEMETRY_RECV_RE = re.compile(r"obs|trace|metric|flight|telemetry",
                                re.IGNORECASE)


def _in_scope(rel: str) -> bool:
    rel = rel.replace(os.sep, "/")
    if _EXEMPT_MARKER in rel:
        return False
    return _PKG_MARKER in rel or rel.startswith("taboo_brittleness_tpu_torch")


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _root_token(node: ast.AST) -> Optional[Tuple[str, str]]:
    """Peel calls/subscripts/attribute chains down to a stable token:
    ``("a", attr)`` for a ``self.attr`` root, ``("n", name)`` for a local
    name.  ``self._pending.pop(w)`` -> ("a", "_pending")."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute):
            a = _self_attr(node)
            if a is not None:
                return ("a", a)
            node = node.value
        elif isinstance(node, ast.Name):
            return ("n", node.id)
        else:
            return None


def _expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


# ---------------------------------------------------------------------------
# Lock-aware walking.
# ---------------------------------------------------------------------------

def _walk_held(fn: ast.AST,
               lock_of: Callable[[ast.AST], Optional[str]],
               on_node: Callable[[ast.AST, Tuple[str, ...]], None],
               on_nested: Callable[[ast.AST, Tuple[str, ...]], None],
               on_acquire: Optional[
                   Callable[[Tuple[str, ...], str, ast.AST], None]] = None,
               ) -> None:
    """Visit ``fn``'s body tracking the stack of held locks through ``with``
    blocks.  Nested function/lambda definitions are reported via
    ``on_nested`` and not descended into (they do not run where they are
    defined).  ``on_acquire(held, lock, site)`` fires when a ``with`` block
    acquires ``lock`` — the hook TBX203 builds its order graph from."""

    def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
        on_node(node, held)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            on_nested(node, held)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in node.items:
                visit(item.context_expr, held)
                if item.optional_vars is not None:
                    visit(item.optional_vars, held)
                lock = lock_of(item.context_expr)
                if lock is not None:
                    if on_acquire is not None:
                        on_acquire(tuple(inner), lock, node)
                    inner.append(lock)
            for stmt in node.body:
                visit(stmt, tuple(inner))
            return
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        body: List[ast.AST] = list(fn.body)
    elif isinstance(fn, ast.Lambda):
        body = [fn.body]
    else:
        body = [fn]
    for stmt in body:
        visit(stmt, ())


# ---------------------------------------------------------------------------
# Per-class concurrency model (TBX201).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Access:
    attr: str
    write: bool
    locked: bool
    node: ast.AST


@dataclasses.dataclass
class _Call:
    name: str          # self-method name
    locked: bool


class _Unit:
    """One body that can run: a method, or a nested thread-target function
    defined inside a method (which runs on the spawned thread)."""

    def __init__(self, name: str, node: ast.AST, is_target_fn: bool = False):
        self.name = name
        self.node = node
        self.is_target_fn = is_target_fn
        self.accesses: List[_Access] = []
        self.calls: List[_Call] = []


class _ClassModel:
    def __init__(self, mod: "_Module", cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        self.name = cls.name
        self.methods: Dict[str, ast.FunctionDef] = {
            s.name: s for s in cls.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.sync_attrs = self._sync_attrs()
        self.target_methods: Set[str] = set()
        self.target_fns: List[Tuple[ast.AST, str]] = []  # (fn node, owner)
        self._find_targets()
        self.units: Dict[str, _Unit] = {}
        self._build_units()
        self._propagate_private_locks()

    # -- attribute classification -----------------------------------------

    def _sync_attrs(self) -> Set[str]:
        """Attributes holding threading primitives (exempt from TBX201):
        assigned from a threading ctor, or annotated as one."""
        out: Set[str] = set()
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                d = self.mod.ctx.dotted(node.value.func)
                if d in _SYNC_CTORS:
                    for t in node.targets:
                        a = _self_attr(t)
                        if a:
                            out.add(a)
            elif isinstance(node, ast.AnnAssign):
                a = _self_attr(node.target)
                if a and any(isinstance(n, (ast.Name, ast.Attribute))
                             and getattr(n, "attr", getattr(n, "id", "")) in
                             ("Thread", "Lock", "RLock", "Event", "Condition")
                             for n in ast.walk(node.annotation)):
                    out.add(a)
        return out

    def _find_targets(self) -> None:
        for name, fn in self.methods.items():
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and self.mod.ctx.dotted(node.func) == _THREAD_CTOR):
                    continue
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    a = _self_attr(kw.value)
                    if a is not None:
                        self.target_methods.add(a)
                    elif isinstance(kw.value, ast.Name):
                        nested = self._nested_def(fn, kw.value.id)
                        if nested is not None:
                            self.target_fns.append((nested, name))

    def _nested_def(self, fn: ast.AST, name: str) -> Optional[ast.AST]:
        for node in ast.walk(fn):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node is not fn and node.name == name):
                return node
        return None

    # -- unit construction -------------------------------------------------

    def _lock_of(self, node: ast.AST) -> Optional[str]:
        a = _self_attr(node)
        if a is not None and (a in self.sync_attrs or _LOCK_NAME_RE.search(a)):
            return f"self.{a}"
        if isinstance(node, ast.Name) and (
                node.id in self.mod.module_locks
                or _LOCK_NAME_RE.search(node.id)):
            return node.id
        return None

    def _collect(self, unit: _Unit, fn: ast.AST) -> None:
        target_nodes = {n for n, _ in self.target_fns}

        def on_node(node: ast.AST, held: Tuple[str, ...]) -> None:
            locked = bool(held)
            if isinstance(node, ast.Attribute):
                a = _self_attr(node)
                if a is None or a in self.methods:
                    return
                write = isinstance(node.ctx, (ast.Store, ast.Del))
                unit.accesses.append(_Access(a, write, locked, node))
            elif isinstance(node, ast.Subscript):
                a = _self_attr(node.value)
                if a is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
                    unit.accesses.append(_Access(a, True, locked, node))
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute):
                    a = _self_attr(node.func.value)
                    if a is not None and node.func.attr in _MUTATORS:
                        unit.accesses.append(
                            _Access(a, True, locked, node))
                a = _self_attr(node.func)
                if a is not None and a in self.methods:
                    unit.calls.append(_Call(a, locked))

        def on_nested(node: ast.AST, held: Tuple[str, ...]) -> None:
            # Thread-target nested defs get their own unit; other nested
            # defs (callbacks, key fns) are folded into the enclosing unit
            # with a fresh (empty) lock stack — they do not run where they
            # are defined.
            if node in target_nodes:
                return
            _walk_held(node, self._lock_of,
                       on_node, on_nested)

        _walk_held(fn, self._lock_of, on_node, on_nested)

    def _build_units(self) -> None:
        for name, fn in self.methods.items():
            if name == "__init__":
                continue
            unit = _Unit(name, fn)
            self._collect(unit, fn)
            self.units[name] = unit
        for fn, owner in self.target_fns:
            key = f"{owner}.<{fn.name}>"
            unit = _Unit(fn.name, fn, is_target_fn=True)
            self._collect(unit, fn)
            self.units[key] = unit

    def _propagate_private_locks(self) -> None:
        """A method whose every intra-class call site holds a lock is
        lock-protected by convention (``roll()`` factoring ``_collect`` /
        ``_write`` helpers).  Iterate to cover one level of chaining."""
        for _ in range(2):
            for name, fn in self.methods.items():
                unit = self.units.get(name)
                if unit is None or name in self.target_methods:
                    continue
                sites = [c for u in self.units.values()
                         for c in u.calls if c.name == name]
                if sites and all(c.locked for c in sites):
                    for acc in unit.accesses:
                        acc.locked = True
                    for c in unit.calls:
                        c.locked = True

    # -- side closures -----------------------------------------------------

    def _closure(self, roots: Iterable[str]) -> Set[str]:
        seen: Set[str] = set()
        frontier = [r for r in roots if r in self.units]
        while frontier:
            key = frontier.pop()
            if key in seen:
                continue
            seen.add(key)
            for call in self.units[key].calls:
                if call.name in self.units and call.name not in seen:
                    frontier.append(call.name)
        return seen

    def shared_attr_findings(self) -> Iterator[Tuple[str, str, ast.AST, str]]:
        """Yield (attr, unit_name, node, other_side_desc) for each attribute
        accessed without a common lock on both sides of the thread boundary."""
        if not self.target_methods and not self.target_fns:
            return
        thread_units = self._closure(self.target_methods)
        thread_units |= {k for k, u in self.units.items() if u.is_target_fn}
        for key in list(thread_units):
            u = self.units.get(key)
            if u is not None and u.is_target_fn:
                thread_units |= self._closure(c.name for c in u.calls)
        main_roots = [n for n in self.methods
                      if n != "__init__" and n not in self.target_methods]
        main_units = self._closure(main_roots)
        if not thread_units or not main_units:
            return

        def unlocked(units: Set[str], attr: str, write: bool) -> List[
                Tuple[str, _Access]]:
            out = []
            for key in units:
                for acc in self.units[key].accesses:
                    if (acc.attr == attr and not acc.locked
                            and (acc.write or not write)):
                        out.append((key, acc))
            return out

        attrs = {a.attr for u in self.units.values() for a in u.accesses}
        written_outside_init = {
            a.attr for u in self.units.values() for a in u.accesses if a.write}
        for attr in sorted(attrs):
            if attr in self.sync_attrs or attr not in written_outside_init:
                continue
            t_writes = unlocked(thread_units, attr, write=True)
            m_writes = unlocked(main_units, attr, write=True)
            t_any = unlocked(thread_units, attr, write=False)
            m_any = unlocked(main_units, attr, write=False)
            if t_writes and m_any:
                key, acc = t_writes[0]
                other = m_any[0][0]
                yield attr, self.units[key].name, acc.node, other
            elif m_writes and t_any:
                key, acc = t_any[0]
                other = m_writes[0][0]
                yield attr, self.units[key].name, acc.node, other


# ---------------------------------------------------------------------------
# Per-module model.
# ---------------------------------------------------------------------------

class _Module:
    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.rel = ctx.rel.replace(os.sep, "/")
        i = self.rel.find(_PKG_MARKER)
        base = self.rel[i:] if i >= 0 else self.rel
        self.modname = base[:-3].replace("/", ".") if base.endswith(
            ".py") else base.replace("/", ".")
        self.module_locks: Set[str] = set()
        for node in self.ctx.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                d = self.ctx.dotted(node.value.func)
                if d in ("threading.Lock", "threading.RLock"):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks.add(t.id)
        self.classes = [
            _ClassModel(self, n) for n in ast.walk(self.ctx.tree)
            if isinstance(n, ast.ClassDef)]
        self.class_spans = [
            (n.lineno, getattr(n, "end_lineno", n.lineno), cm)
            for n, cm in ((c.cls, c) for c in self.classes)]
        self.stmt_parent: Dict[ast.AST, ast.stmt] = {}
        self._index_statements()

    def _index_statements(self) -> None:
        def visit(node: ast.AST, stmt: Optional[ast.stmt]) -> None:
            for child in ast.iter_child_nodes(node):
                s = child if isinstance(child, ast.stmt) else stmt
                if s is not None:
                    self.stmt_parent[child] = s
                visit(child, s)

        visit(self.ctx.tree, None)

    def enclosing_class(self, lineno: int) -> Optional[_ClassModel]:
        best = None
        for start, end, cm in self.class_spans:
            if start <= lineno <= end and (
                    best is None or start >= best[0]):
                best = (start, cm)
        return best[1] if best else None

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        line = getattr(node, "lineno", None)
        if line is None:
            return None
        best = None
        for fn in self.ctx.functions:
            end = getattr(fn, "end_lineno", None)
            if end is not None and fn.lineno <= line <= end:
                if best is None or fn.lineno >= best.lineno:
                    best = fn
        return best

    def lock_id(self, node: ast.AST) -> Optional[str]:
        """Global identity for a lock expression: imported module-level locks
        resolve to their dotted origin (shared across modules); ``self``
        attribute locks are qualified by module+class."""
        a = _self_attr(node)
        if a is not None and _LOCK_NAME_RE.search(a):
            cm = self.enclosing_class(getattr(node, "lineno", 0))
            cls = cm.name if cm else "?"
            return f"{self.modname}.{cls}.{a}"
        if isinstance(node, ast.Name):
            if node.id in self.module_locks:
                return f"{self.modname}.{node.id}"
            if _LOCK_NAME_RE.search(node.id):
                origin = self.ctx.aliases.get(node.id)
                return origin if origin else f"{self.modname}.{node.id}"
        if isinstance(node, ast.Attribute):
            d = self.ctx.dotted(node)
            if d is not None and _LOCK_NAME_RE.search(d.rsplit(".", 1)[-1]):
                return d
        return None

    def finding(self, node_or_line, code: str, alias: str,
                message: str) -> Finding:
        if isinstance(node_or_line, int):
            line = node_or_line
            col = 1
        else:
            line = getattr(node_or_line, "lineno", 0)
            col = getattr(node_or_line, "col_offset", 0) + 1
        return Finding(path=self.ctx.rel, line=line, col=col, code=code,
                       alias=alias, message=message,
                       snippet=self.ctx.line_text(line),
                       scope=self.ctx.scope_of(line))


class ConcModel:
    """The whole-program model: every in-scope package module, plus the
    location of the repo's ``tests/`` dir for the TBX206 arming scan."""

    def __init__(self, modules: List[_Module],
                 tests_dir: Optional[str], tests_prefix: str = ""):
        self.modules = modules
        self.tests_dir = tests_dir
        self.tests_prefix = tests_prefix
        self.by_rel = {m.ctx.rel: m for m in modules}

    @classmethod
    def build(cls, files: Sequence[str],
              rels: Optional[Dict[str, str]] = None,
              tests_dir: Optional[str] = "auto") -> "ConcModel":
        """``tests_dir``: a directory whose every ``.py`` file (outside
        ``fixtures/``) is read for TBX206's arming scan; ``"auto"``: the
        port's tests, ``tests/test_torch_*.py`` beside the package."""
        modules: List[_Module] = []
        for path in files:
            rel = (rels or {}).get(path, path)
            if not _in_scope(rel):
                continue
            try:
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
                ctx = ModuleContext(path, source, rel=rel)
            except (OSError, SyntaxError):
                continue  # TBX000 comes from the static pass
            modules.append(_Module(ctx))
        prefix = ""
        if tests_dir == "auto":
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            cand = os.path.join(os.path.dirname(pkg_root), "tests")
            tests_dir = cand if os.path.isdir(cand) else None
            prefix = _PORT_TESTS_PREFIX
        return cls(modules, tests_dir, prefix)

    def tests_source(self) -> str:
        if not self.tests_dir or not os.path.isdir(self.tests_dir):
            return ""
        chunks: List[str] = []
        for root, dirs, names in os.walk(self.tests_dir):
            dirs[:] = sorted(d for d in dirs if d != "fixtures")
            for name in sorted(names):
                if name.endswith(".py") and name.startswith(
                        self.tests_prefix):
                    try:
                        with open(os.path.join(root, name), "r",
                                  encoding="utf-8") as f:
                            chunks.append(f.read())
                    except OSError:
                        continue
        return "\n".join(chunks)


# ---------------------------------------------------------------------------
# TBX201 — shared attribute across the thread boundary.
# ---------------------------------------------------------------------------

class SharedAttrRule:
    code = "TBX201"
    alias = "thread-shared"
    summary = ("attribute crosses a thread boundary with no common lock "
               "on both paths")

    def check(self, model: ConcModel) -> Iterator[Finding]:
        for mod in model.modules:
            for cm in mod.classes:
                for attr, unit, node, other in cm.shared_attr_findings():
                    yield mod.finding(
                        node, self.code, self.alias,
                        f"`{cm.name}.{attr}` is accessed from thread-side "
                        f"`{unit}` and from `{other}` with no common lock "
                        "on both paths — hold one lock on every access, or "
                        "serialize via join/Event and pragma with the "
                        "happens-before argument")


# ---------------------------------------------------------------------------
# TBX202 — signal handlers must only set latches.
# ---------------------------------------------------------------------------

class SignalHandlerRule:
    code = "TBX202"
    alias = "signal-handler"
    summary = ("signal handler call graph acquires a lock / performs I/O / "
               "emits telemetry")

    def _handlers(self, mod: _Module) -> List[Tuple[ast.AST,
                                                    Optional[_ClassModel],
                                                    str]]:
        out = []
        for node in ast.walk(mod.ctx.tree):
            if not (isinstance(node, ast.Call)
                    and mod.ctx.dotted(node.func) == "signal.signal"
                    and len(node.args) >= 2):
                continue
            h = node.args[1]
            a = _self_attr(h)
            if a is not None:
                cm = mod.enclosing_class(node.lineno)
                if cm is not None and a in cm.methods:
                    out.append((cm.methods[a], cm, a))
            elif isinstance(h, ast.Name):
                fn = mod.ctx.module_funcs.get(h.id)
                if fn is not None:
                    out.append((fn, None, h.id))
            elif isinstance(h, ast.Lambda):
                out.append((h, mod.enclosing_class(node.lineno), "<lambda>"))
        return out

    def _hazard(self, mod: _Module, node: ast.Call) -> Optional[str]:
        d = mod.ctx.dotted(node.func)
        if d is not None:
            if d in _IO_CALLS:
                return f"performs I/O (`{d}`)"
            parts = d.split(".")
            if ("obs" in parts or "flightrec" in parts
                    or d.startswith("taboo_brittleness_tpu_torch.obs")):
                return f"emits telemetry (`{d}`)"
            if d.endswith(".acquire"):
                return f"acquires a lock (`{d}`)"
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in ("write", "flush"):
                recv = _expr_text(node.func.value)
                if re.search(r"stderr|stdout|file|fh|fd|sock", recv):
                    return f"performs I/O (`{recv}.{node.func.attr}`)"
            if node.func.attr in _TELEMETRY_ATTRS:
                recv = node.func.value
                rname = (recv.attr if isinstance(recv, ast.Attribute)
                         else recv.id if isinstance(recv, ast.Name) else "")
                if _TELEMETRY_RECV_RE.search(rname):
                    return (f"emits telemetry "
                            f"(`{rname}.{node.func.attr}`)")
            if node.func.attr == "acquire":
                return "acquires a lock (`.acquire()`)"
        return None

    def check(self, model: ConcModel) -> Iterator[Finding]:
        for mod in model.modules:
            for handler, cm, hname in self._handlers(mod):
                yield from self._scan(mod, cm, hname, handler)

    def _scan(self, mod: _Module, cm: Optional[_ClassModel], hname: str,
              root: ast.AST) -> Iterator[Finding]:
        seen: Set[int] = set()
        frontier: List[ast.AST] = [root]
        flagged: Set[int] = set()
        depth = 0
        while frontier and depth < 10:
            depth += 1
            next_frontier: List[ast.AST] = []
            for fn in frontier:
                if id(fn) in seen:
                    continue
                seen.add(id(fn))
                lock_of = (cm._lock_of if cm is not None
                           else lambda n: mod.lock_id(n))

                def on_node(node, held, _fn=fn):
                    if isinstance(node, ast.Call):
                        if id(node) in flagged:
                            return
                        hz = self._hazard(mod, node)
                        if hz is not None:
                            flagged.add(id(node))
                            findings.append(mod.finding(
                                node, self.code, self.alias,
                                f"signal handler `{hname}` reachably "
                                f"{hz} — handlers may only set "
                                "latches/Events (self-deadlock class: a "
                                "signal can land while the lock is held); "
                                "move the work to the poll side or pragma "
                                "with the reason this call is "
                                "async-signal-safe"))
                            return
                        # expand: self.X() and module-level f()
                        a = _self_attr(node.func)
                        if (a is not None and cm is not None
                                and a in cm.methods):
                            next_frontier.append(cm.methods[a])
                        elif isinstance(node.func, ast.Name):
                            callee = mod.ctx.module_funcs.get(node.func.id)
                            if callee is not None:
                                next_frontier.append(callee)

                def on_acquire(held, lock, site):
                    if id(site) not in flagged:
                        flagged.add(id(site))
                        findings.append(mod.finding(
                            site, self.code, self.alias,
                            f"signal handler `{hname}` reachably acquires "
                            f"lock `{lock}` — a signal delivered while the "
                            "main thread holds it self-deadlocks (the "
                            "tracer-lock incident); handlers may only set "
                            "latches/Events"))

                findings: List[Finding] = []
                _walk_held(fn, lock_of, on_node,
                           lambda n, h: None, on_acquire)
                yield from findings
            frontier = next_frontier


# ---------------------------------------------------------------------------
# TBX203 — lock-order cycles.
# ---------------------------------------------------------------------------

class LockOrderRule:
    code = "TBX203"
    alias = "lock-order"
    summary = "cycle in the lock acquisition-order graph"

    def check(self, model: ConcModel) -> Iterator[Finding]:
        edges: Dict[Tuple[str, str], Tuple[_Module, ast.AST]] = {}
        for mod in model.modules:
            for fn in mod.ctx.functions:
                def on_acquire(held, lock, site, _mod=mod):
                    for h in held:
                        if h != lock:
                            edges.setdefault((h, lock), (_mod, site))
                _walk_held(fn, mod.lock_id, lambda n, h: None,
                           lambda n, h: None, on_acquire)

        adj: Dict[str, Set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)

        seen_cycles: Set[frozenset] = set()
        for start in sorted(adj):
            path: List[str] = []
            on_path: Set[str] = set()

            def dfs(node: str) -> Optional[List[str]]:
                if node in on_path:
                    return path[path.index(node):] + [node]
                if node not in adj:
                    return None
                path.append(node)
                on_path.add(node)
                for nxt in sorted(adj[node]):
                    cyc = dfs(nxt)
                    if cyc is not None:
                        return cyc
                path.pop()
                on_path.discard(node)
                return None

            cyc = dfs(start)
            if cyc is None:
                continue
            key = frozenset(cyc)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            # Anchor at the first edge of the cycle that we have a site for.
            for a, b in zip(cyc, cyc[1:]):
                if (a, b) in edges:
                    mod, site = edges[(a, b)]
                    yield mod.finding(
                        site, self.code, self.alias,
                        "lock-order cycle: " + " -> ".join(cyc) +
                        " — two threads taking these locks in opposite "
                        "order deadlock; pick one global order (or collapse "
                        "to a single lock)")
                    break


# ---------------------------------------------------------------------------
# TBX204 — threads with no reachable join path.
# ---------------------------------------------------------------------------

class ThreadLeakRule:
    code = "TBX204"
    alias = "thread-leak"
    summary = "thread started with no reachable join/stop path"

    def _tokens_of_targets(self, targets: Sequence[ast.AST]) -> Set[Tuple]:
        toks: Set[Tuple] = set()
        for t in targets:
            if isinstance(t, ast.Tuple):
                toks |= self._tokens_of_targets(t.elts)
                continue
            tok = _root_token(t)
            if tok is not None:
                toks.add(tok)
        return toks

    def _alias_edges(self, mod: _Module) -> List[Tuple[Tuple, Tuple]]:
        edges: List[Tuple[Tuple, Tuple]] = []
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Assign):
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Tuple)
                        and isinstance(node.value, ast.Tuple)
                        and len(node.targets[0].elts) == len(
                            node.value.elts)):
                    pairs = zip(node.targets[0].elts, node.value.elts)
                else:
                    pairs = ((t, node.value) for t in node.targets)
                for tgt, val in pairs:
                    a = _root_token(tgt)
                    b = _root_token(val)
                    if a is not None and b is not None and a != b:
                        edges.append((a, b))
            elif isinstance(node, ast.For):
                a = _root_token(node.target)
                b = _root_token(node.iter)
                if a is not None and b is not None and a != b:
                    edges.append((a, b))
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MUTATORS):
                coll = _root_token(node.func.value)
                if coll is not None:
                    for arg in node.args:
                        tok = _root_token(arg)
                        if tok is not None and tok != coll:
                            edges.append((tok, coll))
        return edges

    def check(self, model: ConcModel) -> Iterator[Finding]:
        for mod in model.modules:
            creations: List[Tuple[ast.Call, Set[Tuple], bool]] = []
            join_roots: Set[Tuple] = set()
            for node in ast.walk(mod.ctx.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "join"):
                    tok = _root_token(node.func.value)
                    if tok is not None:
                        join_roots.add(tok)
                if (isinstance(node, ast.Call)
                        and mod.ctx.dotted(node.func) == _THREAD_CTOR):
                    stmt = mod.stmt_parent.get(node)
                    toks: Set[Tuple] = set()
                    escapes = False
                    if isinstance(stmt, (ast.Assign,)):
                        toks = self._tokens_of_targets(stmt.targets)
                    elif isinstance(stmt, ast.AnnAssign) and stmt.target is not None:
                        toks = self._tokens_of_targets([stmt.target])
                    elif isinstance(stmt, ast.Return):
                        escapes = True   # factory: the caller owns it
                    elif isinstance(stmt, ast.Expr):
                        pass             # Thread(...).start() — no handle
                    else:
                        # Ctor in argument position etc: conservatively
                        # treat as escaping to avoid false positives.
                        escapes = True
                    creations.append((node, toks, escapes))
            if not creations:
                continue

            # Token connectivity: a creation is joined if any of its handle
            # tokens reaches a `.join()` root through the alias graph.
            adj: Dict[Tuple, Set[Tuple]] = {}
            for a, b in self._alias_edges(mod):
                adj.setdefault(a, set()).add(b)
                adj.setdefault(b, set()).add(a)
            joined: Set[Tuple] = set()
            frontier = list(join_roots)
            while frontier:
                tok = frontier.pop()
                if tok in joined:
                    continue
                joined.add(tok)
                frontier.extend(adj.get(tok, ()))

            for node, toks, escapes in creations:
                if escapes or (toks and toks & joined):
                    continue
                handle = (", ".join(sorted(
                    ("self." if k == "a" else "") + v
                    for k, v in toks)) or "<none>")
                yield mod.finding(
                    node, self.code, self.alias,
                    f"thread started here is never joined (handle: "
                    f"{handle}) — keep the handle and join it on the stop "
                    "path (the prefetch-leak class), or pragma with "
                    "the reason it may outlive its owner")


# ---------------------------------------------------------------------------
# TBX205 — durable artifacts must use the atomic tmp+rename protocol.
# ---------------------------------------------------------------------------

class AtomicWriteRule:
    code = "TBX205"
    alias = "atomic-write"
    summary = ("durable artifact written via bare open(..,'w') instead of "
               "tmp+os.replace")

    def _write_mode(self, node: ast.Call) -> Optional[str]:
        mode = None
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                mode = kw.value.value
        # Only truncate-write modes: append-only logs ("a") are a sanctioned
        # protocol (crash leaves the prefix intact; readers quarantine a
        # torn tail), and "x" is exclusive-create used by claim protocols.
        if mode and mode[:1] == "w":
            return mode
        return None

    def check(self, model: ConcModel) -> Iterator[Finding]:
        for mod in model.modules:
            for node in ast.walk(mod.ctx.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "open" and node.args):
                    continue
                mode = self._write_mode(node)
                if mode is None:
                    continue
                path_text = _expr_text(node.args[0])
                if "tmp" in path_text.lower():
                    continue  # the atomic idiom's own tmp-file open
                fn = mod.enclosing_function(node)
                if fn is not None and any(
                        isinstance(n, ast.Call)
                        and mod.ctx.dotted(n.func) in ("os.replace",
                                                       "os.rename")
                        for n in ast.walk(fn)):
                    continue  # writes tmp then renames: atomic protocol
                yield mod.finding(
                    node, self.code, self.alias,
                    f"durable artifact `{path_text or '?'}` written via "
                    f"bare open(.., {mode!r}) — a crash mid-write leaves a "
                    "torn file for readers/resume; write a tmp sibling and "
                    "os.replace() it (see resilience.atomic_json_dump), or "
                    "pragma with the reason torn output is acceptable")


# ---------------------------------------------------------------------------
# TBX206 — FAULT_SITES contract drift.
# ---------------------------------------------------------------------------

class FaultSiteRule:
    code = "TBX206"
    alias = "fault-site"
    summary = ("FAULT_SITES drift: fired-unregistered / never-fired / "
               "never-armed-in-tests")

    def check(self, model: ConcModel) -> Iterator[Finding]:
        registry: Dict[str, Tuple[_Module, int]] = {}
        reg_mod: Optional[_Module] = None
        fires: Dict[str, Tuple[_Module, ast.Call]] = {}
        for mod in model.modules:
            for node in mod.ctx.tree.body:
                if (isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "FAULT_SITES"
                                for t in node.targets)
                        and isinstance(node.value, (ast.Tuple, ast.List))):
                    reg_mod = mod
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(
                                elt.value, str):
                            registry[elt.value] = (mod, elt.lineno)
            for node in ast.walk(mod.ctx.tree):
                if not (isinstance(node, ast.Call) and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                d = mod.ctx.dotted(node.func)
                if d is not None and (d == "fire" or d.endswith(".fire")):
                    fires.setdefault(node.args[0].value, (mod, node))
        if reg_mod is None:
            return  # no registry in the analyzed set (partial run)

        for site, (mod, node) in sorted(fires.items()):
            if site not in registry:
                yield mod.finding(
                    node, self.code, self.alias,
                    f"fault site '{site}' is fired here but absent from "
                    "FAULT_SITES — register it so TABOO_FAULT_PLAN "
                    "schedules can arm it (unregistered sites are "
                    "untestable dead protocol)")

        tests_src = model.tests_source()
        for site, (mod, lineno) in sorted(registry.items()):
            if site not in fires:
                yield mod.finding(
                    lineno, self.code, self.alias,
                    f"fault site '{site}' is registered in FAULT_SITES but "
                    "never fired anywhere in the package — wire "
                    f"resilience.fire('{site}', ...) at the site or drop "
                    "the registry entry")
            elif tests_src and site not in tests_src:
                yield mod.finding(
                    lineno, self.code, self.alias,
                    f"fault site '{site}' is never armed by any test "
                    "(no TABOO_FAULT_PLAN / arm reference in tests/) — add "
                    "schedule coverage so the site's failure path is "
                    "exercised, or pragma with the reason")


CONC_RULES = [SharedAttrRule(), SignalHandlerRule(), LockOrderRule(),
              ThreadLeakRule(), AtomicWriteRule(), FaultSiteRule()]
CONC_RULES_BY_CODE = {r.code: r for r in CONC_RULES}


def run_conc(files: Sequence[str], *,
             rels: Optional[Dict[str, str]] = None,
             tests_dir: Optional[str] = "auto",
             rules: Optional[Iterable] = None,
             ) -> Tuple[List[Finding], List[Finding]]:
    """Build the whole-program model over the package subset of ``files``
    and run the TBX2xx rules.  Returns (active, suppressed) with the same
    pragma semantics as the per-module pass."""
    model = ConcModel.build(files, rels=rels, tests_dir=tests_dir)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in (rules if rules is not None else CONC_RULES):
        for finding in rule.check(model):
            mod = model.by_rel.get(finding.path)
            pragmas = mod.ctx.pragmas if mod is not None else {}
            (suppressed if is_suppressed(finding, pragmas)
             else active).append(finding)
    active.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return active, suppressed
