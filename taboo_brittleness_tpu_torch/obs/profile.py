"""Phase-scoped device-timeline profiling: ``torch.profiler`` traces joined
to host spans.

Everything the span stream (obs.trace) records is HOST wall time: a program
span covers enqueue (and sometimes a blocking pull), and
``tools/trace_report.py`` *infers* dispatch gaps as "word time covered by no
phase span".  Host clocks cannot tell device-idle from device-busy-on-the-
wrong-thing.  This module is the device half of the telemetry:

1. **Capture** (:class:`SweepCapture` / :class:`DeviceCapture`) — opt-in via
   ``TBX_PROFILE=1`` (or the CLI ``--profile`` flag), the sweep observer
   wraps the first ``TBX_PROFILE_WORDS`` (default 2) computed words of a run
   in ONE ``torch.profiler`` window (CPU and CUDA activities, no stacks, no
   shapes), exported gzipped under ``<output_dir>/_profile/``.  Bounding the
   window keeps the trace small; a couple of steady-state words is what
   attribution needs.
2. **Annotation** (:func:`annotate`) — every program launch (decode /
   readout / nll / fused / serve.step / the warm-start builds / the direct
   lens and forcing launches) wraps itself in a
   ``torch.profiler.record_function`` named
   ``tbx:<program>#<span_id>[@<fn>][!<phases>]``, so device slices are
   attributable to the host span that launched them.  The outermost
   annotation of a thread owns a launch: a program called inside another's
   launch (the decode inside a fused launch, a launch inside a warm-start
   build) is part of it, as it is inside one compiled program in the JAX
   package.  When no capture is active the wrapper is a shared null context.
3. **Parse** (:func:`parse_trace_file` / :func:`build_profile`) — a
   stdlib-only reader for the Kineto Chrome trace that pools device slices
   (``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events) per annotation and
   writes ``<output_dir>/_device_profile.json`` in the JAX package's schema:
   per-program and per-phase device-busy seconds, the device-idle share
   measured from the device timeline itself, top kernels by device time,
   and op classes.

Joining device slices to annotations goes first by **launch correlation**:
each kernel's ``args.correlation`` names the host runtime call that launched
it (``cudaLaunchKernel``, ``cuLaunchKernel`` or, for every kernel of a CUDA
graph replay, ``cudaGraphLaunch``); the kernel belongs to the innermost
annotation on that call's thread whose window holds the call (``"joined":
"correlation"``), however long after the window the card runs it.  On a
trace without device events (the CPU, which only the tests use) the slices
are the outermost ``cpu_op`` events of each thread, joined to the innermost
annotation holding them and clipped to it (``"window"``).  Slices with
neither go through the JAX package's per-module cascade (window, fifo,
order), kept as it is.

``tools/trace_report.py --device`` renders the artifact unchanged.

This module also hosts the drivers behind the ``profile`` CLI
(:func:`run_launch_profile` — one phase launch under capture — and
:func:`run_study_host_profile` + :class:`StageTimers`, the host wall-clock
breakdown of real study words).

Contract, as for the rest of obs/: host-side only, fail-open end to end
(capture or parse errors never take down a run), stdlib + lazily imported
torch.

The PyTorch port's counterpart of the JAX package's ``obs/profile.py``.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Bumped whenever ``_device_profile.json`` gains/renames a REQUIRED key;
#: readers (tools/trace_report.py --device) accept their own version and older.
SCHEMA_VERSION = 1

DEVICE_PROFILE_FILENAME = "_device_profile.json"
PROFILE_DIRNAME = "_profile"

#: Annotation wire format:
#: ``tbx:<program>#<span_id>[@<fn_name>][!<phase>=<w>[+<phase>=<w>...]]``.
#: The optional ``!`` suffix is the FUSED launch's phase table (runtime/
#: fused.py): ordered sub-phases with analytic device-cost weights at the
#: launch shapes, so one launch splits its measured device seconds per phase
#: without any host timestamp.
_ANNOT_PREFIX = "tbx:"
_ANNOT_RE = re.compile(
    r"^tbx:(?P<program>[^#]+)#(?P<span>\d+)"
    r"(?:@(?P<fn>[^!]+))?(?:!(?P<phases>.+))?$")

#: Gap (microseconds) that splits two slices of the same module into
#: separate execution groups (the JAX cascade's grouping).
_GROUP_GAP_US = 5000.0

#: Cap on per-launch records in the artifact (a profiled serving run steps
#: thousands of times; phases still aggregate everything).
_MAX_PROGRAM_RECORDS = 400

#: Kineto categories of the card's own timeline.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Kineto categories of host calls into the CUDA runtime / driver (the
#: launches a device slice's correlation id names).
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def enabled() -> bool:
    """Opt-in master switch: ``TBX_PROFILE=1`` (or the CLI ``--profile``
    flag, which sets it) arms the sweep observer's device capture."""
    return os.environ.get("TBX_PROFILE", "0") == "1"


def capture_words() -> int:
    """How many computed words one capture window covers
    (``TBX_PROFILE_WORDS``, default 2)."""
    try:
        return max(1, int(os.environ.get("TBX_PROFILE_WORDS", "2")))
    except ValueError:
        return 2


# ---------------------------------------------------------------------------
# Annotation.
# ---------------------------------------------------------------------------

#: True while a capture started by THIS module is live.  ``annotate`` keys
#: off it so the per-dispatch cost with profiling off is one attribute read.
_ACTIVE = False

#: Per-thread depth of live annotations: only the outermost one is emitted.
_DEPTH = threading.local()


class _NullCtx:
    """Shared no-op context for the not-capturing fast path."""

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_CTX = _NullCtx()


class _Annotation:
    """One ``record_function`` range, counted on this thread's depth so a
    launch called inside it stays part of it."""

    def __init__(self, name: str) -> None:
        import torch

        self._rf = torch.profiler.record_function(name)

    def __enter__(self) -> "_Annotation":
        _DEPTH.n = getattr(_DEPTH, "n", 0) + 1
        try:
            self._rf.__enter__()
        except BaseException:
            _DEPTH.n -= 1
            raise
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._rf.__exit__(exc_type, exc, tb)
        finally:
            _DEPTH.n -= 1


def annotation_name(program: str, span_id: Optional[int],
                    fn_name: Optional[str],
                    phases: Optional[Dict[str, float]] = None) -> str:
    name = f"{_ANNOT_PREFIX}{program}#{int(span_id or 0)}"
    if fn_name:
        name += f"@{fn_name}"
    if phases:
        name += "!" + "+".join(f"{p}={w:g}" for p, w in phases.items())
    return name


def parse_phase_table(text: Optional[str]) -> Optional[Dict[str, float]]:
    """``decode=0.62+readout=0.21+nll=0.17`` → ordered {phase: weight};
    None for absent/unparseable (a malformed table degrades to a plain
    single-phase annotation, never an error)."""
    if not text:
        return None
    table: Dict[str, float] = {}
    for part in text.split("+"):
        name, sep, w = part.partition("=")
        if not sep or not name:
            return None
        try:
            table[name] = float(w)
        except ValueError:
            return None
    return table or None


def capturing() -> bool:
    """True while a capture started by this module is live — call sites use
    it to skip work (the fused launch's phase-table arithmetic) that exists
    only for the trace parser."""
    return _ACTIVE


def annotate(program: str, *, fn: Any = None,
             span_id: Optional[int] = None,
             phases: Optional[Dict[str, float]] = None):
    """Context manager marking one program launch on the profiler timeline.

    ``fn`` (the launched callable, or its name) rides along in the name.
    ``span_id`` defaults to the innermost active obs span — the id the
    artifact is later joined back to ``_events.jsonl`` with.  ``phases``
    attaches a fused launch's phase table (``runtime.fused.phase_table``).

    A shared null context when no capture is active, and inside another
    annotation on the same thread (the outer launch owns the work).
    """
    if not _ACTIVE or getattr(_DEPTH, "n", 0):
        return _NULL_CTX
    try:
        if span_id is None:
            from taboo_brittleness_tpu_torch.obs import trace as trace_mod

            t = trace_mod.get_tracer()
            cur = t.current_span() if t is not None else None
            span_id = getattr(cur, "span_id", None)
        fn_name = fn if isinstance(fn, str) else (
            getattr(fn, "__name__", None) if fn is not None else None)
        return _Annotation(
            annotation_name(program, span_id, fn_name, phases=phases))
    except Exception:  # noqa: BLE001 — profiling must never poison a dispatch
        return _NULL_CTX


# ---------------------------------------------------------------------------
# Capture.
# ---------------------------------------------------------------------------

def _device_meta() -> Dict[str, Any]:
    try:
        import torch

        if torch.cuda.is_available():
            return {"backend": "cuda",
                    "device_kind": torch.cuda.get_device_name()}
    except Exception:  # noqa: BLE001 — probing the card is best-effort
        pass
    return {"backend": "cpu", "device_kind": "cpu"}


class DeviceCapture:
    """One ``torch.profiler`` window → parsed profile dict.

    Fail-open: ``start`` returns False (and the capture stays inert) when
    profiling cannot start — another capture of this module live in the
    process, a profiler already running, an unwritable trace dir."""

    def __init__(self, trace_dir: str, *, meta: Optional[Dict[str, Any]] = None):
        self.trace_dir = trace_dir
        self.meta = dict(meta or {})
        self.active = False
        self.trace_file: Optional[str] = None
        self._t0: Optional[float] = None
        self._prof: Any = None

    def start(self) -> bool:
        global _ACTIVE
        if self.active or _ACTIVE:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.trace_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts, record_shapes=False,
                           with_stack=False, profile_memory=False)
            prof.start()
        except Exception:  # noqa: BLE001 — profiling is best-effort
            return False
        self._prof = prof
        self.active = True
        self._t0 = time.monotonic()
        _ACTIVE = True
        return True

    def stop(self) -> Optional[Dict[str, Any]]:
        """Stop the window, export and parse its trace, and return the
        profile dict (None on any failure)."""
        global _ACTIVE
        if not self.active:
            return None
        self.active = False
        _ACTIVE = False
        wall = (time.monotonic() - self._t0) if self._t0 is not None else None
        prof, self._prof = self._prof, None
        spent: Dict[str, float] = {}
        t = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t
            now = time.perf_counter()
            spent[name] = round(now - t, 3)
            t = now

        try:
            try:
                import torch

                if torch.cuda.is_available():
                    # The window's last launches land in the trace.
                    torch.cuda.synchronize()
            except Exception:  # noqa: BLE001
                pass
            prof.stop()
            lap("stop")
            plain = _export_plain(prof, self.trace_dir)
            lap("export")
        except Exception:  # noqa: BLE001
            return None
        try:
            meta = dict(self.meta)
            if wall is not None:
                meta["capture_wall_seconds"] = round(wall, 3)
            for k, v in _device_meta().items():
                meta.setdefault(k, v)
            # The kept copy is gzipped on a thread while the plain file is
            # parsed (zlib and file IO release the GIL).
            zipped: Dict[str, Any] = {}

            def gzip_it() -> None:
                try:
                    zipped["path"] = _gzip_file(plain, remove=False)
                except Exception as e:  # noqa: BLE001 — raised below
                    zipped["error"] = e

            zipper = threading.Thread(target=gzip_it, name="tbx-trace-gzip")
            zipper.start()
            try:
                annotations, slices = parse_trace_file(plain)
            finally:
                zipper.join()
            lap("parse")
            os.remove(plain)
            if "error" in zipped:
                raise zipped["error"]
            self.trace_file = path = zipped["path"]
            profile = build_profile(annotations, slices, meta=meta,
                                    trace_file=path)
            lap("build")
            # What the capture cost after its window closed.
            profile["capture"]["overhead_seconds"] = spent
            return profile
        except Exception:  # noqa: BLE001 — a bad trace must not kill the run
            return None


def _export_plain(prof: Any, trace_dir: str) -> str:
    os.makedirs(trace_dir, exist_ok=True)
    plain = os.path.join(
        trace_dir, f"tbx_{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(plain)
    return plain


def _gzip_file(plain: str, *, remove: bool = True) -> str:
    """``plain`` gzipped at level 1 beside itself (and removed): a profiled
    sweep's trace runs to hundreds of thousands of kernels, and level 9
    would cost seconds per capture."""
    import shutil

    with open(plain, "rb") as src, \
            gzip.open(plain + ".gz", "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 1 << 20)
    if remove:
        os.remove(plain)
    return plain + ".gz"


def export_trace(prof: Any, trace_dir: str) -> str:
    """Export a stopped ``torch.profiler.profile`` as
    ``<trace_dir>/tbx_<pid>_<ms>.pt.trace.json.gz`` (the pattern
    :func:`find_trace_file` globs) and return its path."""
    return _gzip_file(_export_plain(prof, trace_dir))


class SweepCapture:
    """The sweep observer's bounded capture: starts with the run, stops after
    ``TBX_PROFILE_WORDS`` computed words (or at observer close), writes
    ``<output_dir>/_device_profile.json``."""

    def __init__(self, output_dir: str, *, tracer: Any = None,
                 words_limit: Optional[int] = None):
        self.output_dir = output_dir
        self.tracer = tracer
        self.limit = words_limit if words_limit is not None else capture_words()
        self._capture = DeviceCapture(
            os.path.join(output_dir, PROFILE_DIRNAME))
        self._words_done = 0
        self.profile: Optional[Dict[str, Any]] = None
        self.artifact_path: Optional[str] = None

    def start(self) -> bool:
        return self._capture.start()

    def word_done(self) -> None:
        """One computed (non-resumed) word finished; stop once the budget is
        spent so the rest of a long sweep costs nothing."""
        if not self._capture.active:
            return
        self._words_done += 1
        if self._words_done >= self.limit:
            self.finish()

    def finish(self) -> None:
        if not self._capture.active:
            return
        profile = self._capture.stop()
        if profile is None:
            return
        profile.setdefault("capture", {})["words"] = self._words_done
        self.profile = profile
        path = os.path.join(self.output_dir, DEVICE_PROFILE_FILENAME)
        try:
            from taboo_brittleness_tpu_torch.runtime.resilience import (
                atomic_json_dump)

            atomic_json_dump(profile, path)
            self.artifact_path = path
        except Exception:  # noqa: BLE001 — fail-open
            return
        if self.tracer is not None:
            try:
                self.tracer.event(
                    "profile.captured", words=self._words_done,
                    file=DEVICE_PROFILE_FILENAME,
                    programs=len(profile.get("programs", [])),
                    device_busy_seconds=profile.get("device", {}).get(
                        "busy_union_seconds"))
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# Trace parsing (stdlib-only).
# ---------------------------------------------------------------------------

def find_trace_file(trace_dir: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` under a profiler log dir."""
    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                  recursive=True),
        key=lambda p: os.path.getmtime(p))
    return files[-1] if files else None


def _outermost(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The events of one thread not nested inside another of them."""
    out: List[Dict[str, Any]] = []
    end = float("-inf")
    for ev in sorted(events, key=lambda e: (e["t0"], -e["dur"])):
        if ev["t0"] >= end:
            out.append(ev)
            end = ev["t0"] + ev["dur"]
    return out


def parse_trace_file(path: str) -> Tuple[List[Dict[str, Any]],
                                         List[Dict[str, Any]]]:
    """(annotations, device slices) from one Kineto Chrome trace
    (``export_chrome_trace``, plain or gzipped).

    - An *annotation* is a host ``user_annotation`` event whose name parses
      as ``tbx:<program>#<span>[@<fn>][!<phases>]``; it keeps its thread.
    - A *device slice* is a ``kernel``, ``gpu_memcpy`` or ``gpu_memset``
      event.  One whose ``args.correlation`` matches a host runtime or
      driver call carries that call's time and thread (``launch_ts``,
      ``launch_tid``): the join attributes it by that launch.
    - A trace without device slices (a CPU run) takes the outermost
      ``cpu_op`` events of each thread as its slices, each launched where
      it starts.
    Times are microseconds as emitted.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        tr = json.load(f)
    events = tr.get("traceEvents") or []
    annotations: List[Dict[str, Any]] = []
    slices: List[Dict[str, Any]] = []
    launches: Dict[Any, Tuple[float, Any]] = {}
    cpu_ops: Dict[Any, List[Dict[str, Any]]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("ts") is None:
            continue
        cat = ev.get("cat")
        if cat in _DEVICE_CATS:         # most of a card's trace: keep it lean
            slices.append({"name": ev.get("name", ""), "module": None,
                           "t0": float(ev["ts"]),
                           "dur": float(ev.get("dur") or 0.0),
                           "tid": ev.get("tid"),
                           "correlation": (ev.get("args") or {}).get(
                               "correlation")})
            continue
        args = ev.get("args") or {}
        if cat in _LAUNCH_CATS:
            corr = args.get("correlation")
            if corr is not None:
                launches[corr] = (float(ev["ts"]), ev.get("tid"))
            continue
        ts = ev["ts"]
        name = str(ev.get("name", ""))
        dur = float(ev.get("dur", 0.0) or 0.0)
        if name.startswith(_ANNOT_PREFIX) and cat != "gpu_user_annotation":
            m = _ANNOT_RE.match(name)
            if m:
                ann = {
                    "program": m.group("program"),
                    "span_id": int(m.group("span")),
                    "fn": m.group("fn"),
                    "t0": float(ts), "t1": float(ts) + dur,
                    "tid": ev.get("tid"),
                }
                table = parse_phase_table(m.group("phases"))
                if table:
                    ann["phases"] = table
                annotations.append(ann)
        elif cat == "cpu_op":
            cpu_ops.setdefault(ev.get("tid"), []).append(
                {"name": name, "module": None, "t0": float(ts), "dur": dur,
                 "tid": ev.get("tid")})
    if slices:
        for s in slices:
            hit = launches.get(s.pop("correlation"))
            if hit is not None:
                s["launch_ts"], s["launch_tid"] = hit
    else:
        for tid, ops in cpu_ops.items():
            for s in _outermost(ops):
                s["launch_ts"], s["launch_tid"] = s["t0"], tid
                s["host"] = True
                slices.append(s)
    annotations.sort(key=lambda a: a["t0"])
    slices.sort(key=lambda s: s["t0"])
    return annotations, slices


#: HBM-traffic-proportional op classes, coarsest-that-still-ranks: matmuls
#: stream weights, copies/transposes are pure HBM traffic, fusions blend both.
#: The JAX package's patterns, with the card's matmul kernel families
#: (cuBLAS's ``nvjet_*``, ``*wgmma*``, ``*gemv*``) added to ``matmul``.
_OP_CLASS_PATTERNS = (
    # Order matters: collectives/transfers first (an "all-gather" must not
    # read as a copy, nor an "all-reduce" as a reduce).
    ("collective", re.compile(r"all-reduce|all-gather|all-to-all|"
                              r"collective|psum|permute", re.I)),
    ("host-transfer", re.compile(r"infeed|outfeed|transfer|copy-start|"
                                 r"copy-done", re.I)),
    ("matmul", re.compile(r"dot|conv|gemm|einsum|nvjet|wgmma|gemv", re.I)),
    ("copy", re.compile(
        r"copy|transpose|reshape|bitcast|concatenate|dynamic-slice|"
        r"dynamic_slice|dynamic-update|dynamic_update|slice|pad|gather|scatter",
        re.I)),
    ("fusion", re.compile(r"fusion", re.I)),
    ("reduce", re.compile(r"reduce|sort|top-k|topk|cumsum|argmax|argmin", re.I)),
)


def classify_op(name: str) -> str:
    for cls, pat in _OP_CLASS_PATTERNS:
        if pat.search(name):
            return cls
    return "other"


def _base_op_name(name: str) -> str:
    """``dot.4`` → ``dot`` — the per-instruction suffix only splits totals."""
    return re.sub(r"\.\d+$", "", name)


def _union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total covered microseconds of a set of [t0, t1) intervals → seconds."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur0, cur1 = intervals[0]
    for t0, t1 in intervals[1:]:
        if t0 > cur1:
            total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    total += cur1 - cur0
    return total / 1e6


def _join_by_launch(annotations: List[Dict[str, Any]],
                    slices: List[Dict[str, Any]]) -> Tuple[
                        Dict[int, List[Tuple[Dict[str, Any], str]]],
                        List[Dict[str, Any]]]:
    """Attribute each slice that knows its launch to the innermost
    annotation holding the launch: on the launching thread when any
    annotation there holds it, else on any thread.  A host slice (a CPU
    op) is a ``"window"`` join, a device slice a ``"correlation"`` one.
    Returns (annotation index → [(one-slice group, how)], unattributed
    one-slice groups)."""
    by_tid: Dict[Any, List[int]] = {}
    for i, a in enumerate(annotations):
        by_tid.setdefault(a.get("tid"), []).append(i)
    all_idx = list(range(len(annotations)))
    starts = {tid: [annotations[i]["t0"] for i in idx]
              for tid, idx in by_tid.items()}
    all_starts = [a["t0"] for a in annotations]

    def innermost(idx: List[int], t0s: List[float], ts: float) -> Optional[int]:
        k = bisect.bisect_right(t0s, ts)
        for j in range(k - 1, -1, -1):
            a = annotations[idx[j]]
            if a["t1"] >= ts:
                return idx[j]
        return None

    assigned: Dict[int, List[Tuple[Dict[str, Any], str]]] = {}
    unattributed: List[Dict[str, Any]] = []
    for s in slices:
        ts = s["launch_ts"]
        tid = s.get("launch_tid")
        i = None
        if tid in by_tid:
            i = innermost(by_tid[tid], starts[tid], ts)
        if i is None:
            i = innermost(all_idx, all_starts, ts)
        g = {"module": s.get("module"), "t0": s["t0"],
             "t1": s["t0"] + s["dur"], "slices": [s]}
        if i is None:
            unattributed.append(g)
        else:
            assigned.setdefault(i, []).append(
                (g, "window" if s.get("host") else "correlation"))
    return assigned, unattributed


def _group_slices(slices: List[Dict[str, Any]],
                  annotations: Sequence[Dict[str, Any]] = ()) -> Dict[
                      Optional[str], List[Dict[str, Any]]]:
    """Per-module execution groups — one group ≈ one launch's execution
    (the JAX package's grouping, for slices that know no launch).

    A group is a maximal run of same-module slices on one executor thread:
    the run breaks when a slice of a DIFFERENT module lands in between, when
    the intra-module gap exceeds ``_GROUP_GAP_US``, or when a new
    fn-matched annotation started inside the gap."""
    ann_starts: Dict[Optional[str], List[float]] = {}
    if annotations:
        modules = {s["module"] for s in slices}
        for module in modules:
            starts = sorted(a["t0"] for a in annotations
                            if _module_matches(module, a.get("fn")))
            if starts:
                ann_starts[module] = starts

    def dispatch_between(module: Optional[str], t0: float, t1: float) -> bool:
        starts = ann_starts.get(module)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t0)
        return i < len(starts) and starts[i] <= t1

    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for s in slices:
        by_tid.setdefault(s["tid"], []).append(s)
    groups: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for ss in by_tid.values():                         # already time-sorted
        cur: Optional[Dict[str, Any]] = None
        for s in ss:
            t1 = s["t0"] + s["dur"]
            if (cur is not None and s["module"] == cur["module"]
                    and s["t0"] - cur["t1"] <= _GROUP_GAP_US
                    and not dispatch_between(s["module"], cur["t1"],
                                             s["t0"])):
                cur["t1"] = max(cur["t1"], t1)
                cur["slices"].append(s)
            else:
                cur = {"module": s["module"], "t0": s["t0"], "t1": t1,
                       "slices": [s]}
                groups.setdefault(s["module"], []).append(cur)
    for module_groups in groups.values():
        module_groups.sort(key=lambda g: g["t0"])
    return groups


def _module_matches(module: Optional[str], fn: Optional[str]) -> bool:
    if not module or not fn:
        return False
    return module == f"jit_{fn}" or module == fn or module.startswith(
        f"jit_{fn}")


def _join(annotations: List[Dict[str, Any]],
          groups: Dict[Optional[str], List[Dict[str, Any]]]) -> Tuple[
              Dict[int, List[Tuple[Dict[str, Any], str]]],
              List[Dict[str, Any]]]:
    """Assign execution groups to annotations (the JAX package's window →
    fifo → order cascade).  Returns (annotation index → list of (group,
    how)), plus the unattributed groups."""
    assigned: Dict[int, List[Tuple[Dict[str, Any], str]]] = {}
    unattributed: List[Dict[str, Any]] = []

    def candidates(module: Optional[str]) -> List[int]:
        out = [i for i, a in enumerate(annotations)
               if _module_matches(module, a.get("fn"))]
        if out:
            return out
        # No fn-matched annotation for this module: fall back to window
        # containment against every annotation.
        return list(range(len(annotations)))

    for module, module_groups in groups.items():
        cand = candidates(module)
        fn_matched = any(_module_matches(module, annotations[i].get("fn"))
                         for i in cand)
        remaining_groups: List[Dict[str, Any]] = []
        taken: set = set()
        # Pass 1: window containment (group midpoint inside the window).
        for g in module_groups:
            mid = (g["t0"] + g["t1"]) / 2.0
            hits = [i for i in cand
                    if annotations[i]["t0"] <= mid <= annotations[i]["t1"]]
            if len(hits) == 1 or (hits and fn_matched):
                # Ambiguity (nested/overlapping windows) resolves to the
                # latest-started containing window — the innermost dispatch.
                i = max(hits, key=lambda j: annotations[j]["t0"])
                assigned.setdefault(i, []).append((g, "window"))
                taken.add(i)
            elif fn_matched:
                remaining_groups.append(g)
            else:
                unattributed.append(g)
        if not fn_matched:
            continue
        # Pass 2: FIFO zip when the leftover counts agree exactly.
        free = [i for i in cand if i not in taken]
        if remaining_groups and len(remaining_groups) == len(free):
            for g, i in zip(remaining_groups, free):
                assigned.setdefault(i, []).append((g, "fifo"))
            continue
        # Pass 3: latest candidate annotation started before the group.
        for g in remaining_groups:
            before = [i for i in cand if annotations[i]["t0"] <= g["t0"]]
            i = max(before, default=(cand[0] if cand else None),
                    key=lambda j: annotations[j]["t0"])
            if i is None:
                unattributed.append(g)
            else:
                assigned.setdefault(i, []).append((g, "order"))
    return assigned, unattributed


def build_profile(annotations: List[Dict[str, Any]],
                  slices: List[Dict[str, Any]], *,
                  meta: Optional[Dict[str, Any]] = None,
                  trace_file: Optional[str] = None) -> Dict[str, Any]:
    """Pool device slices per annotation and assemble the
    ``_device_profile.json`` payload (the JAX package's schema; ``v`` gates
    readers).  Slices that carry ``launch_ts`` join by their launch
    (:func:`_join_by_launch`), the rest through the JAX cascade."""
    by_launch = [s for s in slices if "launch_ts" in s]
    rest = [s for s in slices if "launch_ts" not in s]
    assigned, unattributed = _join_by_launch(annotations, by_launch)
    if rest:
        more, more_un = _join(annotations, _group_slices(rest, annotations))
        for i, got in more.items():
            assigned.setdefault(i, []).extend(got)
        unattributed.extend(more_un)
    last_slice_end = max((s["t0"] + s["dur"] for s in slices), default=0.0)

    programs: List[Dict[str, Any]] = []
    phases: Dict[str, Dict[str, Any]] = {}
    # Fused launches (annotations carrying a phase table) additionally split
    # their measured device seconds across the listed sub-phases; the launch
    # still appears exactly once under its own program in `phases`.
    fused_split: Dict[str, Dict[str, float]] = {}
    fused_split_source_s = 0.0
    for i, a in enumerate(annotations):
        window_s = max(0.0, (a["t1"] - a["t0"]) / 1e6)
        got = assigned.get(i, [])
        device_us = 0.0
        n_slices = 0
        rec_intervals: List[Tuple[float, float]] = []
        how = "unjoined"
        for g, g_how in got:
            for s in g["slices"]:
                if g_how == "window":
                    # Clip to the window: joined device time can then never
                    # exceed the host span that launched it.
                    o0 = max(s["t0"], a["t0"])
                    o1 = min(s["t0"] + s["dur"], a["t1"])
                    if o1 <= o0:
                        continue
                    device_us += o1 - o0
                    rec_intervals.append((o0, o1))
                else:
                    device_us += s["dur"]
                    rec_intervals.append((s["t0"], s["t0"] + s["dur"]))
                n_slices += 1
        if got:
            hows = {g_how for _, g_how in got}
            how = (hows.pop() if len(hows) == 1
                   else "correlation" if "correlation" in hows
                   else "fifo" if "fifo" in hows
                   else "order")
        rec = {
            "program": a["program"],
            "span_id": a["span_id"],
            "fn": a.get("fn"),
            "window_seconds": round(window_s, 6),
            # sum = device resource-seconds (parallel work double-counts);
            # union = device occupancy.
            "device_seconds": round(device_us / 1e6, 6),
            "device_union_seconds": round(_union_seconds(rec_intervals), 6),
            "slices": n_slices,
            "joined": how,
        }
        table = a.get("phases")
        if table:
            rec["phases_in_launch"] = list(table)
            total_w = sum(table.values()) or 1.0
            for pname, w in table.items():
                cell = fused_split.setdefault(
                    pname, {"device_seconds": 0.0, "launches": 0})
                cell["device_seconds"] += (device_us / 1e6) * (w / total_w)
                cell["launches"] += 1
            fused_split_source_s += device_us / 1e6
        if how == "unjoined" and a["t0"] >= last_slice_end:
            # Dispatched inside the capture window but executed after it
            # closed: truncated by the capture boundary, not a join miss.
            rec["truncated"] = True
        if len(programs) < _MAX_PROGRAM_RECORDS:
            programs.append(rec)
        ph = phases.setdefault(a["program"], {
            "launches": 0, "device_seconds": 0.0, "window_seconds": 0.0,
            "slices": 0, "unjoined_launches": 0})
        ph["launches"] += 1
        ph["device_seconds"] += device_us / 1e6
        ph["window_seconds"] += window_s
        ph["slices"] += n_slices
        if how == "unjoined":
            ph["unjoined_launches"] += 1
    for ph in phases.values():
        ph["device_seconds"] = round(ph["device_seconds"], 6)
        ph["window_seconds"] = round(ph["window_seconds"], 6)

    # Device-timeline totals: busy union vs the capture extent IS the
    # measured idle share (no host inference involved).
    intervals = [(s["t0"], s["t0"] + s["dur"]) for s in slices]
    busy_union = _union_seconds(intervals)
    busy_sum = sum(s["dur"] for s in slices) / 1e6
    ts_all = ([s["t0"] for s in slices] + [a["t0"] for a in annotations])
    te_all = ([s["t0"] + s["dur"] for s in slices]
              + [a["t1"] for a in annotations])
    capture_s = ((max(te_all) - min(ts_all)) / 1e6) if ts_all else 0.0
    idle_s = max(0.0, capture_s - busy_union)

    top: Dict[str, Dict[str, Any]] = {}
    for s in slices:
        base = _base_op_name(s["name"])
        cell = top.get(base)
        if cell is None:
            # Classified once per op: a card's trace holds ~10^5 kernels of
            # a few hundred names, each name up to a kilobyte long.
            cell = top[base] = {"op": base, "seconds": 0.0, "count": 0,
                                "class": classify_op(base)}
        cell["seconds"] += s["dur"] / 1e6
        cell["count"] += 1
    top_ops = sorted(top.values(), key=lambda c: -c["seconds"])[:15]
    for c in top_ops:
        c["seconds"] = round(c["seconds"], 6)
    op_classes: Dict[str, float] = {}
    for cell in top.values():
        op_classes[cell["class"]] = (op_classes.get(cell["class"], 0.0)
                                     + cell["seconds"])
    op_classes = {
        k: {"seconds": round(v, 6),
            "share": round(v / busy_sum, 4) if busy_sum > 0 else 0.0}
        for k, v in sorted(op_classes.items(), key=lambda kv: -kv[1])}

    if fused_split:
        for cell in fused_split.values():
            cell["device_seconds"] = round(cell["device_seconds"], 6)
        fused_section = {
            "phases": fused_split,
            "source_device_seconds": round(fused_split_source_s, 6),
            "note": "single fused launches split per sub-phase by the "
                    "in-graph phase table riding each launch's annotation "
                    "(runtime/fused.py; analytic weights at launch shapes)",
        }
    else:
        fused_section = None

    unattr_s = sum(s["dur"] for g in unattributed for s in g["slices"]) / 1e6
    capture_meta = {
        "annotations": len(annotations),
        "device_slices": len(slices),
    }
    if trace_file:
        capture_meta["trace_file"] = trace_file
    meta = dict(meta or {})
    capture_meta.update(
        {k: meta.pop(k) for k in list(meta)
         if k in ("capture_wall_seconds", "words")})
    out = {
        "v": SCHEMA_VERSION,
        "generated_by": "taboo_brittleness_tpu_torch.obs.profile",
        **meta,
        "capture": capture_meta,
        "programs": programs,
        "phases": phases,
        "device": {
            "busy_seconds": round(busy_sum, 6),
            "busy_union_seconds": round(busy_union, 6),
            "capture_seconds": round(capture_s, 6),
            "idle_seconds": round(idle_s, 6),
            "idle_share": round(idle_s / capture_s, 4) if capture_s > 0 else 0.0,
        },
        "top_ops": top_ops,
        "op_classes": op_classes,
        "unattributed": {
            "seconds": round(unattr_s, 6),
            "groups": len(unattributed),
        },
    }
    if fused_section is not None:
        out["fused_phase_split"] = fused_section
    return out


def load_device_profile(path: str) -> Dict[str, Any]:
    """Read a ``_device_profile.json`` (raises on unreadable/newer-schema —
    callers decide whether that is fatal)."""
    with open(path, "r", encoding="utf-8") as f:
        profile = json.load(f)
    if not isinstance(profile, dict):
        raise ValueError(f"{path}: not a JSON object")
    if int(profile.get("v", 0)) > SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema v{profile.get('v')} is newer than this reader "
            f"(v{SCHEMA_VERSION})")
    return profile


# ---------------------------------------------------------------------------
# `profile` CLI drivers.
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_launch_profile(*, phase: str = "decode", rows: Optional[int] = None,
                       prompt_len: int = 32, new_tokens: int = 50,
                       trace_dir: Optional[str] = None, top: int = 20,
                       device: Any = None) -> Dict[str, Any]:
    """Device-profile ONE sweep launch (decode / readout / nll): on the
    card ``gemma2_bench`` at 330 rows (the study's 33-arm launch), on the
    CPU ``gemma2_tiny`` at 8.  Runs the phase once outside the capture
    window (on the card that captures the decode's graph), then captures
    exactly one annotated launch and returns the parsed profile, the
    registry's misses during the captured launch (``aot_misses``) and a
    rendered ``lines`` summary for the CLI to print.  ``device`` defaults
    to ``cuda`` and raises without it."""
    import numpy as np
    import torch

    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import aot, decode

    if phase not in ("decode", "readout", "nll"):
        raise ValueError(f"unknown phase {phase!r}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = gemma2.PRESETS["gemma2_bench" if on_card else "gemma2_tiny"]
    rows = rows or (330 if on_card else 8)
    params = gemma2.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    sae = sae_ops.init_random(torch.Generator(device=dev).manual_seed(1),
                              cfg.hidden_size, 16384 if on_card else 64,
                              device=dev)
    tap = min(31, cfg.num_layers - 1)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=prompt_len))
               for _ in range(rows)]
    padded, valid, positions = decode.pad_prompts(prompts)
    ins = (torch.from_numpy(padded).long().to(dev),
           torch.from_numpy(valid).to(dev),
           torch.from_numpy(positions).long().to(dev))
    ep = {"sae": sae,
          "latent_ids": torch.from_numpy(
              rng.integers(0, sae.d_sae, size=(rows, 32))).long().to(dev),
          "layer": tap}
    resp_start = prompt_len - 1
    kw = dict(max_new_tokens=new_tokens, edit_fn=iv.sae_ablation_edit,
              edit_params=ep, stop_ids=(-1,), capture_residual_layer=tap,
              return_prefill_cache=True)

    def run_decode():
        with annotate("decode", fn=decode.greedy_decode, span_id=1):
            d = decode.greedy_decode(params, cfg, *ins, **kw)
            _sync(dev)
        return d

    dec = run_decode()                       # capture + downstream inputs
    layout = decode.response_layout_device(dec)

    def run_readout():
        with annotate("readout", fn=iv._residual_measure, span_id=2):
            iv._residual_measure(
                params, cfg, dec.residual, layout.sequences,
                layout.response_mask,
                torch.zeros((rows,), dtype=torch.long, device=dev),
                top_k=5, resp_start=resp_start)
            _sync(dev)

    def run_nll():
        pos2 = torch.clamp(torch.cumsum(dec.sequence_valid.long(), 1) - 1,
                           min=0)
        nm = torch.zeros_like(dec.sequence_valid)
        nm[:, resp_start:-1] = True
        with annotate("nll", fn=iv._teacher_forced_nll_cached, span_id=3):
            iv._teacher_forced_nll_cached(
                params, cfg, *dec.prefill_cache, dec.sequences,
                dec.sequence_valid, pos2, nm, iv.sae_ablation_edit,
                decode.with_chunk_positions(ep, pos2[:, resp_start:]),
                resp_start=resp_start)
            _sync(dev)

    fn = {"decode": run_decode, "readout": run_readout, "nll": run_nll}[phase]
    if phase != "decode":
        fn()                                  # warm the chosen phase
    misses0 = aot.stats().get("decode", {}).get("misses", 0)
    trace_dir = trace_dir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "tbx_prof")
    capture = DeviceCapture(trace_dir)
    if not capture.start():
        raise RuntimeError(
            f"could not start a profiler capture into {trace_dir} "
            "(another capture live in this process?)")
    fn()
    profile = capture.stop()
    if profile is None:
        raise RuntimeError(f"no trace parsed from {trace_dir}")
    misses = aot.stats().get("decode", {}).get("misses", 0) - misses0

    lines = [f"top {top} ops for ONE {phase} launch at {rows} rows "
             f"({profile.get('device_kind')}):"]
    for cell in profile["top_ops"][:top]:
        lines.append(f"  {cell['seconds']:10.6f}s  x{cell['count']:5d}  "
                     f"[{cell['class']:<8}] {cell['op'][:80]}")
    dev_block = profile["device"]
    lines.append(
        f"device busy {dev_block['busy_seconds']:.4f}s "
        f"(union {dev_block['busy_union_seconds']:.4f}s) over a "
        f"{dev_block['capture_seconds']:.4f}s capture — idle share "
        f"{dev_block['idle_share']:.1%}")
    lines.append(f"raw trace -> {capture.trace_file}")
    return {"profile": profile, "phase": phase, "rows": rows,
            "aot_misses": misses, "trace_file": capture.trace_file,
            "lines": lines}


class StageTimers:
    """Nested wall-clock timers with self-time attribution (the host half of
    the profiler).

    ``wrap(mod, name)`` monkeypatches ``mod.name`` with a timed version;
    nesting is tracked on a stack so a parent's self-time excludes its timed
    children.
    """

    def __init__(self) -> None:
        self.total: Dict[str, float] = {}
        self.self_time: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self._stack: List[List] = []   # [name, t0, child_seconds]
        self._restore: List[Tuple[Any, str, Any]] = []

    def enter(self, name: str) -> None:
        self._stack.append([name, time.perf_counter(), 0.0])

    def exit(self) -> None:
        name, t0, child = self._stack.pop()
        dt = time.perf_counter() - t0
        self.total[name] = self.total.get(name, 0.0) + dt
        self.self_time[name] = self.self_time.get(name, 0.0) + dt - child
        self.count[name] = self.count.get(name, 0) + 1
        if self._stack:
            self._stack[-1][2] += dt

    def wrap(self, mod: Any, name: str, label: Optional[str] = None) -> None:
        import functools

        label = label or name
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def timed(*a, **kw):
            self.enter(label)
            try:
                return fn(*a, **kw)
            finally:
                self.exit()

        setattr(mod, name, timed)
        self._restore.append((mod, name, fn))

    def unwrap(self) -> None:
        """Put every wrapped attribute back (newest first)."""
        while self._restore:
            mod, name, fn = self._restore.pop()
            setattr(mod, name, fn)

    def reset(self) -> None:
        self.total.clear()
        self.self_time.clear()
        self.count.clear()

    def report_lines(self, wall: float, title: str) -> List[str]:
        lines = [f"== {title} (wall {wall:.2f}s) ==",
                 f"  {'stage':42s} {'total':>8s} {'self':>8s} {'calls':>6s}"]
        for name in sorted(self.self_time, key=self.self_time.get,
                           reverse=True):
            lines.append(f"  {name:42s} {self.total[name]:8.3f} "
                         f"{self.self_time[name]:8.3f} {self.count[name]:6d}")
        accounted = sum(self.total[n] for n in self.total
                        if self.count[n] and n.startswith("word:"))
        untimed = wall - accounted
        if abs(untimed) > 0.01:
            lines.append(f"  {'(outside timed stages)':42s} {untimed:8.3f}")
        return lines


def run_study_host_profile(*, words: int = 2, prompt_len: int = 32,
                           new_tokens: int = 50,
                           device: Any = None) -> Dict[str, Any]:
    """Host-side wall-clock breakdown of real study words: runs the real
    ``run_intervention_studies`` on synthetic words (``gemma2_bench`` on the
    card, ``gemma2_tiny`` on the CPU) with every interesting stage wrapped
    in a nested timer, and returns a self-time-ranked tree per word.  Device
    waits show up inside whichever stage blocks — read next to
    ``_device_profile.json`` (the device half).

    The first word pays every graph capture; per-word reports return
    separately so the steady state is readable on its own.
    ``TBX_PROFILE_NO_SPLIT=1`` times the real ``_collect_rows`` instead of
    splitting it into a device wait and the host half."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from taboo_brittleness_tpu_torch.config import (
        Config, ExperimentConfig, InterventionConfig, ModelConfig)
    from taboo_brittleness_tpu_torch.device import resolve_device
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens, projection
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    preset = "gemma2_bench" if on_card else "gemma2_tiny"
    cfg = gemma2.PRESETS[preset]
    params = gemma2.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    sae = sae_ops.init_random(torch.Generator(device=dev).manual_seed(2),
                              cfg.hidden_size, 16384 if on_card else 64,
                              device=dev)
    tap = min(31, cfg.num_layers - 1)

    word_list = [f"profword{i}" for i in range(words)]
    lex = [f"w{i:02d}" for i in range(
        max(4, min(64, (cfg.vocab_size - 109) // 2 - words - 2)))]
    tok = WordTokenizer(word_list + lex, vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(7)
    prompts = [" ".join(rng.choice(lex, size=max(prompt_len - 8, 2)))
               for _ in range(10)]
    config = Config(
        model=ModelConfig(layer_idx=tap, top_k=5, arch=preset,
                          dtype="bfloat16", param_dtype="bfloat16"),
        experiment=ExperimentConfig(seed=0, max_new_tokens=new_tokens,
                                    pad_to_multiple=prompt_len),
        intervention=InterventionConfig(),
        word_plurals={w: [w] for w in word_list},
        prompts=prompts,
    )

    t = StageTimers()
    # Stage wrappers, outer to inner; _collect_rows reads the launch back.
    for mod, name, label in (
            (iv, "prepare_word_state", None),
            (iv, "prepare_word_dispatch", None),
            (iv, "prepare_word_collect", None),
            (iv, "score_latents_for_word", None),
            (iv, "plan_ablation_sweep", None),
            (iv, "plan_projection_sweep", None),
            (iv, "measure_arm_sets", None),
            (iv, "_dispatch_rows", None),
            (iv, "_residual_measure", "residual_measure(dispatch)"),
            (iv, "_decode_guess_rows", None),
            (iv, "_tile_rows_ep", None),
            (iv, "_atomic_json_dump", "json_dump"),
            (iv.metrics_mod, "calculate_metrics", None),
            (iv.metrics_mod, "leak_rate", None),
            (projection, "principal_subspace", None),
            (decode, "greedy_decode", "decode.greedy_decode(dispatch)"),
            (decode, "decode_texts", "decode_texts(host work)"),
            (decode, "texts_from_tokens", "texts_from_tokens(host)"),
            (decode, "response_layout_device", None),
            (lens, "spike_positions_batch", "spike_positions(dispatch)")):
        if hasattr(mod, name):
            t.wrap(mod, name, label)

    # Split _collect_rows into the device wait and the host work: wait for
    # the card FIRST under a timer, so the wrapped inner stages measure pure
    # host time.
    split = os.environ.get("TBX_PROFILE_NO_SPLIT", "0") != "1"
    real_collect = iv._collect_rows

    def collect_split(tok_, config_, state_, handle):
        t.enter("collect.device_wait")
        try:
            _sync(dev)
        finally:
            t.exit()
        t.enter("collect.host")
        try:
            return real_collect(tok_, config_, state_, handle)
        finally:
            t.exit()

    if split:
        iv._collect_rows = collect_split
    else:
        t.wrap(iv, "_collect_rows")

    def model_loader(word):
        return params, cfg, tok

    out_dir = tempfile.mkdtemp(prefix="tbx_prof_study_")
    reports: List[Dict[str, Any]] = []
    try:
        for i, w in enumerate(word_list):
            t.reset()
            t.enter(f"word:{w}")
            t0 = time.perf_counter()
            iv.run_intervention_studies(
                config, model_loader=model_loader, sae=sae, words=[w],
                output_dir=out_dir)
            wall = time.perf_counter() - t0
            t.exit()
            title = f"word {i} ({'capture' if i == 0 else 'steady'})"
            reports.append({
                "word": w, "wall_seconds": round(wall, 3),
                "total": {k: round(v, 4) for k, v in t.total.items()},
                "self": {k: round(v, 4) for k, v in t.self_time.items()},
                "calls": dict(t.count),
                "lines": t.report_lines(wall, title),
            })
    finally:
        iv._collect_rows = real_collect
        t.unwrap()
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"preset": preset, "words": reports}
