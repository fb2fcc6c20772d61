"""Graph registry: captured decode steps, keyed and warm-started.

The counterpart of the JAX package's ``runtime/aot.py``.  There, each hot
entry point is one compiled XLA program per argument signature (the decode
loop runs inside it as a ``lax.while_loop``), built ahead of the first word
by a warm start.  Here the counterpart of "one compiled program per shape"
is a CUDA graph: a step function over static buffers, captured once per key
and replayed, so a decode step costs one launch from the host instead of
one per operation.

A :class:`Program` is that step function, the static buffers it reads and
writes in place, static copies of the edit params' tensors, and on the card
its captured graph.  The functions that step (``decode.greedy_decode``,
``speculate.speculative_decode``) fill the buffers, run the program
``N`` times from a host loop and copy their results out.

Keys (:func:`signature`) cover the entry name, the shape and dtype of every
tensor argument, the static arguments (functions by qualified name and
identity), the edit params' structure and the shapes of their tensors, and
the **identity of the params**: the ``data_ptr`` of every leaf.  A graph
reads the tensors it captured, so after a word switch a key of shapes alone
would replay the old word.  The edit params' tensors (SAE weights, latent
ids, bases, spike positions) are copied into the program's static copies at
every launch, so one graph serves every arm of a launch shape.

Memory: the KV cache is pooled by launch shape (:func:`pooled`), so the
programs of one shape with different edits share one cache, and a launch
of a shape seen before recycles that shape's KV block.  The pools live
under an LRU cap in bytes (:data:`POOL_SHARE` of the card's memory from
``torch.cuda.mem_get_info``).  A pool evicted takes its programs with it.  A program holds weak references to its params' leaves
and is dropped at the next lookup once any of them is freed (a word switch
frees the old word's params).

Devices:

- ``cuda``: a miss captures (two warm-up steps on a side stream, then
  ``torch.cuda.graph`` on that stream in ``thread_local`` error mode, with
  one graph memory pool shared by every program).  A capture error raises;
  nothing falls back to eager steps.  Other threads may launch, copy and
  allocate during a capture (a checkpoint prefetch does), but a device-wide
  ``torch.cuda.synchronize`` from one invalidates it: such a thread waits
  on its own stream.
- ``cpu``: the same programs are kept and their steps run eagerly (the CPU
  path, chosen by device).
- ``TBX_AOT=0`` turns the registry off, as in the JAX package: every launch
  builds fresh buffers and steps eagerly, on the card too, and nothing is
  keyed.

Not ported: the JAX package's on-disk store of serialized executables.
There is nothing here to serialize.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

#: Eager steps run on the capture stream before the capture (cuBLAS handles
#: and workspaces exist before the graph records them).
WARMUP_STEPS = 2

#: Share of the card's memory the pooled buffers may hold by default.
POOL_SHARE = 0.27

#: Pool cap on the CPU (the CPU path's pools are a tiny model's).
CPU_POOL_BYTES = 4 << 30


def enabled() -> bool:
    """``TBX_AOT=0`` turns the registry off (eager steps, nothing keyed);
    on by default."""
    return os.environ.get("TBX_AOT", "1") != "0"


# ---------------------------------------------------------------------------
# Trees of edit params: dicts, tuples (named or not), tensors and scalars.
# ---------------------------------------------------------------------------

def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _static_repr(v: Any) -> str:
    """Functions by qualified name and identity (two closures of one name
    are two edits), everything else by repr."""
    if callable(v) and hasattr(v, "__qualname__"):
        return f"{getattr(v, '__module__', '?')}.{v.__qualname__}@{id(v):x}"
    return repr(v)


def _tree_sig(tree: Any) -> str:
    """Structure and leaf signatures: tensors by shape, dtype and device,
    other leaves by value."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_tree_sig(tree[k])}"
                              for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__ + "(" + ",".join(_tree_sig(v) for v in tree)
                + ")")
    if isinstance(tree, torch.Tensor):
        return f"T{tuple(tree.shape)}:{tree.dtype}:{tree.device}"
    return _static_repr(tree)


def params_identity(params: Any) -> Tuple[int, ...]:
    """The ``data_ptr`` of every tensor leaf of ``params``."""
    return tuple(x.data_ptr() for x in tree_leaves(params)
                 if isinstance(x, torch.Tensor))


def signature(name: str, dynamic: Dict[str, Any], static: Dict[str, Any]) -> str:
    """The key of one launch: ``dynamic`` holds the tensor arguments (trees
    allowed; ``params`` also contributes its identity), ``static`` the
    rest."""
    parts = [name]
    for k in sorted(dynamic):
        parts.append(f"{k}={_tree_sig(dynamic[k])}")
    if "params" in dynamic:
        parts.append(f"params@{params_identity(dynamic['params'])}")
    parts += [f"{k}={_static_repr(v)}" for k, v in sorted(static.items())]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]


def static_copy(tree: Any) -> Any:
    """``tree`` with each tensor replaced by a static one of its path, shape
    and dtype, shared by every program whose edit has that leaf: launches
    run one at a time and each copies its own values in first
    (:func:`copy_into`), so one copy of an SAE's weights serves every
    program that edits with it.  A leaf that exists already takes
    ``tree``'s values here too: a new program's capture steps it before
    the launch copies anything in, and the values another launch left
    there may not fit this one (latent ids of a wider SAE index past a
    narrower one's rows).  With the registry off a launch's program is its
    own, so the tree passes through."""
    if not enabled():
        return tree

    def walk(x: Any, path: str) -> Any:
        if isinstance(x, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v, f"{path}/{f}")
                             for f, v in zip(x._fields, x)))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v, f"{path}/{i}") for i, v in enumerate(x))
        if not isinstance(x, torch.Tensor):
            return x
        key = (path, tuple(x.shape), x.dtype, str(x.device))
        with _LOCK:
            leaf = _EDIT_LEAVES.get(key)
            if leaf is None:
                leaf = _EDIT_LEAVES[key] = x.clone()
            elif leaf.data_ptr() != x.data_ptr():
                leaf.copy_(x)
            return leaf

    return walk(tree, "")


def copy_into(static: Any, tree: Any) -> None:
    """Copy ``tree``'s tensors into a :func:`static_copy` of the same
    signature (a tensor that already is the static one is skipped)."""
    for s, x in zip(tree_leaves(static), tree_leaves(tree)):
        if isinstance(s, torch.Tensor) and s.data_ptr() != x.data_ptr():
            s.copy_(x)


# ---------------------------------------------------------------------------
# Pools of static buffers (LRU under a byte cap).
# ---------------------------------------------------------------------------

class _Pool:
    def __init__(self, tensors: Dict[str, torch.Tensor]) -> None:
        self.tensors = tensors
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        self.programs: List[Tuple[str, str]] = []   # (entry, key)


Specs = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def _nbytes(specs: Specs) -> int:
    n = 0
    for shape, dtype in specs.values():
        count = 1
        for d in shape:
            count *= d
        n += count * torch.empty((), dtype=dtype).element_size()
    return n


_LOCK = threading.RLock()
_POOLS: "OrderedDict[Tuple, _Pool]" = OrderedDict()
_GRAPH_POOL: Dict[int, Any] = {}     # device index -> graph_pool_handle
_CAPTURE_STREAM: Dict[int, Any] = {}  # device index -> the capture stream
_EDIT_LEAVES: Dict[Tuple, torch.Tensor] = {}   # static edit-param tensors
_WARMING = threading.local()


def pool_cap_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return CPU_POOL_BYTES
    return int(POOL_SHARE * torch.cuda.mem_get_info(device)[1])


def pooled(key: Tuple, specs: Specs,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """The static tensors of pool ``key``: zeros of ``specs`` (name ->
    shape, dtype) made on first use.  Before making one, the least
    recently used pools go, with their programs, until the pools and the
    new one fit the cap (the requested pool itself is always made)."""
    with _LOCK:
        pool = _POOLS.get(key)
        if pool is not None:
            _POOLS.move_to_end(key)
            return pool.tensors
        cap = pool_cap_bytes(device)
        need = _nbytes(specs)
        while _POOLS and pool_bytes() + need > cap:
            _evict(next(iter(_POOLS)))
        pool = _POOLS[key] = _Pool({
            name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in specs.items()})
        return pool.tensors


def pool_bytes() -> int:
    with _LOCK:
        return sum(p.nbytes for p in _POOLS.values())


def _evict(key: Tuple) -> None:
    pool = _POOLS.pop(key)
    for name, pkey in pool.programs:
        e = _REGISTRY.get(name)
        if e is not None:
            e.programs.pop(pkey, None)


def kv_pool_key(cfg: Any, rows: int, width: int, device: torch.device) -> Tuple:
    return ("kv", str(device), str(cfg.compute_dtype), cfg.num_layers, rows,
            width, cfg.num_kv_heads, cfg.head_dim)


def _kv_specs(cfg: Any, rows: int, width: int) -> Specs:
    shape = (cfg.num_layers, rows, width, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, cfg.compute_dtype), "v": (shape, cfg.compute_dtype),
            "valid": ((rows, width), torch.bool)}


def fresh_kv(cfg: Any, rows: int, width: int,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """A KV cache (``k``, ``v``, ``valid``) of ``rows`` x ``width`` columns
    of a launch's own (the registry off)."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in _kv_specs(cfg, rows, width).items()}


def pooled_kv(cfg: Any, rows: int, width: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """The pooled KV cache (``k``, ``v``, ``valid``) of ``rows`` x
    ``width`` columns."""
    return pooled(kv_pool_key(cfg, rows, width, device),
                  _kv_specs(cfg, rows, width), device)


# ---------------------------------------------------------------------------
# Programs and entries.
# ---------------------------------------------------------------------------

class Program:
    """One step function over static buffers and, on the card, its graph.

    ``step(params)`` writes its buffers in place; once captured, ``run``
    replays the graph and ``step`` stays only as the eager twin that
    measurements set beside it.  ``state`` holds whatever
    the stepping function keeps with the program (buffers, static edit
    params); ``pool_keys`` names the pools whose buffers it steps over (an
    evicted pool drops the program).  The program holds no reference to the params: ``run`` takes
    them, and on the card the graph reads the tensors it captured, which
    the key guarantees are the caller's."""

    def __init__(self, step: Callable[[Any], None], state: Any,
                 pool_keys: Tuple[Tuple, ...] = ()) -> None:
        self.step: Optional[Callable[[Any], None]] = step
        self.state = state
        self.pool_keys = pool_keys
        self.graph: Optional[Any] = None
        self.refs: List[Any] = []

    def run(self, params: Any) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.step(params)

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)


def _graph_pool(device: torch.device) -> Any:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _GRAPH_POOL:
        _GRAPH_POOL[idx] = torch.cuda.graph_pool_handle()
    return _GRAPH_POOL[idx]


def capture(program: Program, params: Any, device: torch.device) -> float:
    """Capture ``program``'s step into a CUDA graph; returns the seconds
    taken (warm-up included).  Any error raises."""
    t0 = time.perf_counter()
    main = torch.cuda.current_stream(device)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    side = _CAPTURE_STREAM.get(idx)
    if side is None:
        # One stream for every capture: cuBLAS keeps a workspace per stream.
        side = _CAPTURE_STREAM[idx] = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            program.step(params)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_graph_pool(device), stream=side,
                          capture_error_mode="thread_local"):
        program.step(params)
    main.wait_stream(side)
    program.graph = graph          # run() replays it from now on
    return time.perf_counter() - t0


class AotEntry:
    """One stepping entry point's programs and counters."""

    def __init__(self, name: str, fn: Optional[Callable]) -> None:
        self.name = name
        self.fn = fn
        self.programs: Dict[str, Program] = {}
        self.hits = 0
        self.misses = 0
        self.captures = 0
        self.capture_seconds = 0.0

    def signature(self, dynamic: Dict[str, Any], static: Dict[str, Any]) -> str:
        return signature(self.name, dynamic, static)

    def program(self, key: str, *, params: Any, device: torch.device,
                make: Callable[[], Program]) -> Program:
        """The program of ``key``, made (and on the card captured) on a
        miss.  A warm start's lookups count neither hits nor misses."""
        counting = not getattr(_WARMING, "on", False)
        with _LOCK:
            self._purge()
            prog = self.programs.get(key)
            if prog is not None:
                if counting:
                    self.hits += 1
                for pk in prog.pool_keys:
                    if pk in _POOLS:
                        _POOLS.move_to_end(pk)
                return prog
            if counting:
                self.misses += 1
        prog = make()
        prog.refs = [weakref.ref(x) for x in tree_leaves(params)
                     if isinstance(x, torch.Tensor)]
        if device.type == "cuda":
            dt = capture(prog, params, device)
            self.captures += 1
            self.capture_seconds += dt
        with _LOCK:
            self.programs[key] = prog
            for pk in prog.pool_keys:
                pool = _POOLS.get(pk)
                if pool is not None:
                    pool.programs.append((self.name, key))
        return prog

    def _purge(self) -> None:
        for key in [k for k, p in self.programs.items() if not p.alive()]:
            del self.programs[key]

    def build(self, dynamic: Dict[str, Any], static: Dict[str, Any]) -> Dict[str, Any]:
        """Warm start: make (and capture) the program of this launch by
        running the entry once on these inputs, outputs discarded.  Returns
        ``{entry, key, source: "memory" | "captured", seconds}``."""
        key = self.signature(dynamic, static)
        rec: Dict[str, Any] = {"entry": self.name, "key": key}
        with _LOCK:
            self._purge()
            if key in self.programs:
                rec["source"] = "memory"
                return rec
        t0 = time.perf_counter()
        with warming():
            self.fn(**dynamic, **static)
        rec["source"] = "captured"
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        return rec


@contextlib.contextmanager
def warming():
    """Lookups inside count neither hits nor misses (a warm start)."""
    prev = getattr(_WARMING, "on", False)
    _WARMING.on = True
    try:
        yield
    finally:
        _WARMING.on = prev


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, AotEntry] = {}


def entry(name: str, fn: Optional[Callable] = None) -> AotEntry:
    """The registry entry ``name`` (made on first sight; ``fn`` is what
    :meth:`AotEntry.build` runs)."""
    with _LOCK:
        e = _REGISTRY.get(name)
        if e is None:
            e = _REGISTRY[name] = AotEntry(name, fn)
        elif fn is not None:
            e.fn = fn
        return e


def lookup(name: str, fn: Callable, dynamic: Dict[str, Any],
           static: Dict[str, Any], *, params: Any, device: torch.device,
           make: Callable[[], Program]) -> Program:
    """The program of one launch of entry ``name``: from the registry when
    it is on, else made fresh (eager steps, nothing keyed)."""
    if not enabled():
        return make()
    e = entry(name, fn)
    return e.program(e.signature(dynamic, static), params=params,
                     device=device, make=make)


def stats() -> Dict[str, Any]:
    """Per-entry hits, misses, captures, capture seconds and programs, the
    pooled bytes and the static edit-param bytes (tests assert a warmed
    study records zero misses)."""
    with _LOCK:
        out: Dict[str, Any] = {
            name: {"hits": e.hits, "misses": e.misses, "captures": e.captures,
                   "capture_seconds": round(e.capture_seconds, 3),
                   "programs": len(e.programs)}
            for name, e in _REGISTRY.items()}
        out["pool_bytes"] = pool_bytes()
        out["edit_bytes"] = sum(t.numel() * t.element_size()
                                for t in _EDIT_LEAVES.values())
        return out


def graph_pool_bytes() -> int:
    """Device memory reserved by CUDA graphs' private pools (every segment
    outside the default pool: what the graphs' intermediates replay in);
    0 without a card."""
    if not torch.cuda.is_available():
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def reset() -> None:
    """Drop every entry, program and pool (tests; frees the buffers)."""
    with _LOCK:
        _REGISTRY.clear()
        _POOLS.clear()
        _EDIT_LEAVES.clear()
