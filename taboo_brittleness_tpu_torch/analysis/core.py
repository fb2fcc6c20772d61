"""tbx-check core: findings, suppression pragmas, per-module AST context.

Everything here is stdlib-only (``ast`` + ``re``): the static pass must cost
milliseconds and run before torch is even importable.  The dispatch-level
pass lives in ``deep.py``.

Findings, pragmas and fingerprints are the JAX package's own, byte for byte,
so one baseline file format and one pragma syntax serve both checkers.  What
differs is the notion of *traced* code.  The port has no ``jax.jit``; the
code whose every host sync, f32 slab or unseeded draw is paid on each
replay is reached from these roots:

- the step callable handed to ``aot.Program(step, ...)`` (the function a
  CUDA graph captures and replays, or the eager step on the CPU);
- the program captured by ``aot.capture(program, ...)``: its step is the
  one its ``aot.Program(step, ...)`` was made with, a root already;
- the entry function registered through ``aot.entry(name, fn)`` or
  ``aot.lookup(name, fn, ...)`` (the launch it keys);
- the functions named in the deep pass's registry (``deep.ENTRY_NAMES``),
  matched by module and name;
- a ``jax.jit`` binding, should one appear (the JAX checker's roots, kept so
  the two agree on shared sources).

The reach through helpers is the JAX checker's: the module-local by-name
call graph, plus every function defined inside a traced one.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file line (or a deep-mode entry)."""

    path: str        # repo-relative posix path, or "<deep:entry>" for deep findings
    line: int        # 1-based; 0 for deep-mode findings
    col: int
    code: str        # "TBX001"
    alias: str       # "host-sync" — usable in pragmas interchangeably with code
    message: str
    snippet: str = ""  # stripped source line: the line-number-free fingerprint basis
    scope: str = ""    # module-relative qualname of the enclosing def/class
    #                    ("TimeseriesRecorder.stop"); "" at module level.  The
    #                    path-free half of the baseline fingerprint, so a pure
    #                    file move does not churn the ratchet.

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} [{self.alias}] {self.message}"


# ---------------------------------------------------------------------------
# Suppression pragmas.
# ---------------------------------------------------------------------------

# ``# tbx: f32-ok — reason`` / ``# tbx: TBX002-ok, TBX001-ok: reason``.
# Tokens are <code-or-alias>-ok; anything after them is the (recommended)
# one-line justification.  A trailing pragma suppresses its own line; a
# pragma inside a comment block suppresses the first code line after the
# block (so multi-line justifications work wherever the tbx line sits).
_PRAGMA_LINE_RE = re.compile(r"#\s*tbx:\s*(?P<body>.+)$")
_PRAGMA_TOKEN_RE = re.compile(r"([A-Za-z0-9]+(?:-[A-Za-z0-9]+)*)-ok\b")


def parse_pragmas(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of suppressed rule tokens (codes or
    aliases, lowercased; the literal token ``all`` suppresses every rule)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _PRAGMA_LINE_RE.search(line)
        if not m:
            continue
        tokens = {t.lower() for t in _PRAGMA_TOKEN_RE.findall(m.group("body"))}
        if not tokens:
            continue
        out.setdefault(i, set()).update(tokens)
        if line.strip().startswith("#"):
            # Comment-only pragma: walk past the rest of the comment block so
            # it covers the statement the block documents.
            j = i
            while j < len(lines) and lines[j].strip().startswith("#"):
                j += 1
            out.setdefault(j + 1, set()).update(tokens)
    return out


def is_suppressed(finding: Finding, pragmas: Dict[int, Set[str]]) -> bool:
    tokens = pragmas.get(finding.line, ())
    return ("all" in tokens or finding.code.lower() in tokens
            or finding.alias.lower() in tokens)


# ---------------------------------------------------------------------------
# Import alias resolution + dotted names.
# ---------------------------------------------------------------------------

def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> fully dotted origin (``np`` -> ``numpy``, ``aot`` ->
    ``taboo_brittleness_tpu_torch.runtime.aot``, ``partial`` ->
    ``functools.partial``)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted origin of a Name/Attribute chain, alias-expanded; None for
    anything that is not a plain chain (calls, subscripts, ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# Roots: how a function came to run on every replay of a step.
# ---------------------------------------------------------------------------

#: The port's package marker: a module's registry name is its path after it.
PKG_MARKER = "taboo_brittleness_tpu_torch/"

JIT_WRAPPERS = {
    "jax.jit", "jax.pjit", "jax.pmap",
    "jax.experimental.pjit.pjit",
}
PARTIAL_NAMES = {"functools.partial"}

#: ``runtime/aot.py``'s calls that hand a function to the registry: the
#: argument position (and keyword) of the function each takes.
AOT_ROOT_CALLS = {"Program": (0, "step"), "entry": (1, "fn"),
                  "lookup": (1, "fn")}

FunctionLike = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


def fn_name(fn: FunctionLike) -> str:
    return getattr(fn, "name", "<lambda>")


def module_name(rel: str) -> Optional[str]:
    """``runtime.decode`` for ``.../taboo_brittleness_tpu_torch/runtime/
    decode.py`` (the deep registry's naming); None outside the package."""
    rel = rel.replace("\\", "/")
    i = rel.find(PKG_MARKER)
    if i < 0 or not rel.endswith(".py"):
        return None
    tail = rel[i + len(PKG_MARKER):-3]
    if tail.endswith("/__init__"):
        tail = tail[:-len("/__init__")]
    return tail.replace("/", ".")


@dataclasses.dataclass
class Root:
    """One function that runs on every launch of a step, and why: ``kind``
    is ``program`` / ``entry`` / ``registry`` / ``jit``."""

    fn: FunctionLike
    kind: str


class ModuleContext:
    """Parsed module + everything the rules need: alias map, roots, and the
    set of functions reachable from a root (module-local call graph by
    name; nested defs inherit their parent's reachability)."""

    def __init__(self, path: str, source: str, rel: Optional[str] = None):
        self.path = path
        self.rel = rel or path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = import_aliases(self.tree)
        self.pragmas = parse_pragmas(self.lines)
        self.module = module_name(self.rel)

        self.functions: List[ast.FunctionDef] = []
        self.parents: Dict[ast.AST, Optional[ast.FunctionDef]] = {}
        self.module_funcs: Dict[str, ast.FunctionDef] = {}
        self.class_methods: List[Tuple[ast.ClassDef, Dict[str, ast.FunctionDef]]] = []
        self._index_functions()
        self._scopes: List[Tuple[int, int, str]] = []
        self._index_scopes()

        self.roots: List[Root] = []
        self._collect_roots()
        self.traced: Set[FunctionLike] = self._traced_closure()

    # -- indexing ----------------------------------------------------------

    def _index_functions(self) -> None:
        def visit(node: ast.AST, parent: Optional[ast.FunctionDef]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions.append(child)
                    self.parents[child] = parent
                    if parent is None:
                        self.module_funcs[child.name] = child
                    visit(child, child)
                elif isinstance(child, ast.Lambda):
                    self.parents[child] = parent
                    visit(child, parent)
                else:
                    if isinstance(child, ast.ClassDef):
                        self.class_methods.append((child, {
                            s.name: s for s in child.body
                            if isinstance(s, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))}))
                    visit(child, parent)

        visit(self.tree, None)

    def _index_scopes(self) -> None:
        """Source spans of every def/class, with module-relative qualnames
        (``Cls.method``).  Used to stamp findings with a path-free anchor
        for baseline fingerprints."""
        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    qual = f"{prefix}.{child.name}" if prefix else child.name
                    end = getattr(child, "end_lineno", child.lineno)
                    self._scopes.append((child.lineno, end, qual))
                    visit(child, qual)
                else:
                    visit(child, prefix)

        visit(self.tree, "")

    def scope_of(self, lineno: int) -> str:
        """Qualname of the innermost def/class containing ``lineno`` ("" at
        module level)."""
        best = ""
        best_start = 0
        for start, end, qual in self._scopes:
            if start <= lineno <= end and start >= best_start:
                best, best_start = qual, start
        return best

    def dotted(self, node: ast.AST) -> Optional[str]:
        return dotted(node, self.aliases)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, node: ast.AST, code: str, alias: str, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(path=self.rel, line=line,
                       col=getattr(node, "col_offset", 0) + 1,
                       code=code, alias=alias, message=message,
                       snippet=self.line_text(line), scope=self.scope_of(line))

    def _innermost(self, nodes: Iterable[ast.AST], line: int) -> Optional[ast.AST]:
        best: Optional[ast.AST] = None
        for fn in nodes:
            end = getattr(fn, "end_lineno", None)
            if end is not None and fn.lineno <= line <= end:
                if best is None or fn.lineno >= best.lineno:
                    best = fn
        return best

    # -- roots -------------------------------------------------------------

    def _is_jit(self, node: ast.expr) -> bool:
        """``jax.jit`` (and kin) or ``partial(jax.jit, ...)``."""
        if isinstance(node, ast.Call):
            if self.dotted(node.func) in PARTIAL_NAMES and node.args:
                return self.dotted(node.args[0]) in JIT_WRAPPERS
            node = node.func
        return self.dotted(node) in JIT_WRAPPERS

    def _jit_roots(self) -> List[Root]:
        """The JAX checker's roots: jit decorators and ``g = jax.jit(fn)``."""
        roots = [Root(fn, "jit") for fn in self.functions
                 for deco in fn.decorator_list if self._is_jit(deco)]
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Call)
                    and self.dotted(node.func) in JIT_WRAPPERS and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in self.module_funcs):
                roots.append(Root(self.module_funcs[node.args[0].id], "jit"))
        return roots

    def _aot_call(self, node: ast.Call) -> Optional[str]:
        """``Program`` / ``entry`` / ``lookup`` when ``node``
        calls that function of the port's ``runtime/aot.py`` (or, inside
        that module, its own)."""
        name = self.dotted(node.func)
        if name is None:
            return None
        head, _, last = name.rpartition(".")
        if last not in AOT_ROOT_CALLS:
            return None
        if head == "aot" or head.endswith(".aot"):
            return last
        if not head and self.module == "runtime.aot":
            return last
        return None

    def resolve(self, expr: ast.AST, site: ast.AST) -> List[FunctionLike]:
        """The functions an expression names at ``site``: a lambda itself, a
        name by the nearest enclosing def's nested defs and then the
        module's, ``self.x`` by the enclosing class's methods, and
        ``functools.partial(f, ...)`` by ``f``."""
        if isinstance(expr, ast.Lambda):
            return [expr]
        if isinstance(expr, ast.Call) and self.dotted(expr.func) in PARTIAL_NAMES \
                and expr.args:
            return self.resolve(expr.args[0], site)
        line = getattr(site, "lineno", 0)
        if isinstance(expr, ast.Name):
            scope = self._innermost(self.functions, line)
            while scope is not None:
                for other in self.functions:
                    if self.parents.get(other) is scope and other.name == expr.id:
                        return [other]
                scope = self.parents.get(scope)
            fn = self.module_funcs.get(expr.id)
            return [fn] if fn is not None else []
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            cls = self._innermost([c for c, _ in self.class_methods], line)
            for c, methods in self.class_methods:
                if c is cls and expr.attr in methods:
                    return [methods[expr.attr]]
        return []

    def _collect_roots(self) -> None:
        self.roots.extend(self._jit_roots())
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = self._aot_call(node)
            if kind is None:
                continue
            pos, kw = AOT_ROOT_CALLS[kind]
            arg = node.args[pos] if len(node.args) > pos else next(
                (k.value for k in node.keywords if k.arg == kw), None)
            if arg is None:
                continue
            label = "program" if kind == "Program" else "entry"
            for fn in self.resolve(arg, node):
                self.roots.append(Root(fn, label))
        if self.module is not None:
            from taboo_brittleness_tpu_torch.analysis.deep import ENTRY_NAMES

            # A ``[variant]`` names the same function once more.
            quals = dict.fromkeys(q.split("[")[0] for q in ENTRY_NAMES)
            for qual in quals:
                mod, _, name = qual.rpartition(".")
                if mod == self.module and name in self.module_funcs:
                    fn = self.module_funcs[name]
                    self.roots.append(Root(fn, "registry"))

    # -- traced reachability ----------------------------------------------

    def _loaded_names(self, fn: ast.AST) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                names.add(node.id)
        return names

    def _traced_closure(self) -> Set[FunctionLike]:
        """Roots + the module-local by-name call-graph closure, plus every
        function *defined inside* a traced function (its body runs on every
        launch too).  A lambda root's names resolve as at its site."""
        traced: Set[FunctionLike] = set()
        frontier: List[FunctionLike] = [r.fn for r in self.roots]
        while frontier:
            fn = frontier.pop()
            if fn in traced:
                continue
            traced.add(fn)
            for other in self.functions:
                if self.parents.get(other) is fn:
                    frontier.append(other)
            for name in self._loaded_names(fn):
                if isinstance(fn, ast.Lambda):
                    callees = self.resolve(ast.Name(id=name, ctx=ast.Load()), fn)
                else:
                    callee = self.module_funcs.get(name)
                    callees = [callee] if callee is not None else []
                frontier.extend(c for c in callees if c not in traced)
        return traced

    def enclosing_traced(self, node: ast.AST) -> Optional[FunctionLike]:
        """The innermost traced function whose source span contains
        ``node``."""
        line = getattr(node, "lineno", None)
        if line is None:
            return None
        return self._innermost(self.traced, line)


def analyze_file(path: str, rel: Optional[str] = None,
                 rules: Optional[Iterable] = None,
                 repo=None) -> Tuple[List[Finding], List[Finding]]:
    """Run the AST rules over one file.  Returns (active, suppressed)."""
    from taboo_brittleness_tpu_torch.analysis.rules import RULES, RepoContext

    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        ctx = ModuleContext(path, source, rel=rel)
    except SyntaxError as e:
        f_err = Finding(path=rel or path, line=e.lineno or 0, col=e.offset or 0,
                        code="TBX000", alias="syntax",
                        message=f"file does not parse: {e.msg}")
        return [f_err], []
    repo = repo if repo is not None else RepoContext.discover([path])
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in (rules if rules is not None else RULES):
        for finding in rule.check(ctx, repo):
            (suppressed if is_suppressed(finding, ctx.pragmas)
             else active).append(finding)
    active.sort(key=lambda f: (f.line, f.col, f.code))
    suppressed.sort(key=lambda f: (f.line, f.col, f.code))
    return active, suppressed
