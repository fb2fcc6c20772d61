"""Structured run manifest: ``run_manifest.json`` next to a run's results.

The PyTorch port's copy of the JAX package's ``runtime/manifest.py``, with
the same schema: the command, a config snapshot, the environment (Python,
platform, git commit, and here torch's version, backend and CUDA device
names where JAX records its own), per-stage wall times, artifact paths, the
``obs`` block (schema version, events path, metrics snapshot), the
preemption margin, the supervised run's incarnation, and the failure
ledger's blocks.  ``runtime.supervise`` folds its incarnation history into
the manifest a supervised child leaves behind.

:func:`maybe_profile` is the CLI's ``--trace-dir``: a raw
``torch.profiler`` trace of the whole command where the JAX module takes a
``jax.profiler`` one (the attributed ``_device_profile.json`` is
``--profile``'s, ``obs/profile.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import platform
import subprocess
import time
import uuid
from typing import Any, Dict, List, Optional


def _git_commit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))))
        # A failed rev-parse (not a repo) exits non-zero: trust stdout only
        # on success.
        if out.returncode != 0:
            return None
        return out.stdout.strip() or None
    except Exception:  # noqa: BLE001 — the manifest never fails a run
        return None


def environment_info() -> Dict[str, Any]:
    """Python, platform, git commit, and torch's version, backend and
    devices (``cuda`` with the card names, or ``cpu``)."""
    info: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "git_commit": _git_commit(),
    }
    try:
        import torch

        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
        if torch.cuda.is_available():
            info["backend"] = "cuda"
            info["devices"] = [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]
        else:
            info["backend"] = "cpu"
            info["devices"] = ["cpu"]
    except Exception as e:  # noqa: BLE001 — the manifest never fails a run
        info["torch_error"] = repr(e)
    return info


@dataclasses.dataclass
class RunManifest:
    """Collects run metadata; write once at the end with :meth:`save`."""

    command: str
    config: Optional[Dict[str, Any]] = None
    run_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:12])
    # tbx: wallclock-ok — epoch timestamp for humans; durations use _mono_start
    started_at: float = dataclasses.field(default_factory=time.time)
    _mono_start: float = dataclasses.field(default_factory=time.monotonic)
    environment: Dict[str, Any] = dataclasses.field(default_factory=environment_info)
    stages: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    artifacts: List[str] = dataclasses.field(default_factory=list)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The failure ledger's blocks (runtime.resilience.FailureLedger); empty
    # blocks are left out of the file.
    failures: Dict[str, Any] = dataclasses.field(default_factory=dict)
    retries: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, **meta: Any):
        """Record one timed stage: ``with manifest.stage("decode", word=w): ...``"""
        t0 = time.perf_counter()
        record: Dict[str, Any] = {"name": name, **meta}
        try:
            yield record
            record["status"] = "ok"
        except BaseException:
            record["status"] = "error"
            raise
        finally:
            record["seconds"] = round(time.perf_counter() - t0, 4)
            self.stages.append(record)

    def add_artifact(self, path: str) -> None:
        self.artifacts.append(path)

    def record_resilience(self, ledger) -> None:
        """Fold a :class:`~.resilience.FailureLedger` (or its dict form)
        into the manifest's failures/retries blocks."""
        data = ledger.to_dict() if hasattr(ledger, "to_dict") else dict(ledger)
        self.failures.update(data.get("quarantined", {}))
        self.retries.update(data.get("retried", {}))

    def _obs_block(self) -> Dict[str, Any]:
        """The obs schema version, the events path (when a tracer is or was
        active in this process) and the metrics registry's snapshot."""
        block: Dict[str, Any] = {}
        try:
            from taboo_brittleness_tpu_torch import obs

            block["schema_version"] = obs.SCHEMA_VERSION
            path = obs.events_path()
            if path:
                block["events_path"] = path
            snap = obs.metrics.snapshot()
            if snap:
                block["metrics"] = snap
        except Exception:  # noqa: BLE001 — the manifest never fails a run
            pass
        return block

    def _preempt_block(self) -> Dict[str, Any]:
        """The sweep observer's ``sweep.preempt_margin_s`` gauge as a field
        of its own (omitted when no word was measured)."""
        try:
            from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics

            gauge = (obs_metrics.snapshot().get("gauges") or {}).get(
                "sweep.preempt_margin_s")
            return {} if gauge is None else {"preempt_margin_s": gauge}
        except Exception:  # noqa: BLE001 — the manifest never fails a run
            return {}

    def _incarnation_block(self) -> Dict[str, Any]:
        """Which incarnation of a supervised run wrote this manifest, and
        whether it exited on a drain; omitted for a plain run."""
        try:
            from taboo_brittleness_tpu_torch.runtime import supervise
            from taboo_brittleness_tpu_torch.runtime.resilience import (
                current_incarnation)

            inc = current_incarnation()
            drained = supervise.drain_requested()
            if not inc and not drained:
                return {}
            return {"incarnation": {"id": inc, "drained": drained}}
        except Exception:  # noqa: BLE001 — the manifest never fails a run
            return {}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "run_id": self.run_id,
            "command": self.command,
            "started_at": self.started_at,
            "wall_seconds": round(time.monotonic() - self._mono_start, 3),
            "environment": self.environment,
            "config": self.config,
            "stages": self.stages,
            "artifacts": self.artifacts,
            "obs": self._obs_block(),
            **self._preempt_block(),
            **self._incarnation_block(),
            **({"failures": self.failures} if self.failures else {}),
            **({"retries": self.retries} if self.retries else {}),
            **({"extra": self.extra} if self.extra else {}),
        }

    def save(self, path: str) -> str:
        """Write atomically (supervise and a resume read the file)."""
        from taboo_brittleness_tpu_torch.runtime.resilience import atomic_json_dump

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        atomic_json_dump(self.to_dict(), path)
        return path


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activity) of the block into ``trace_dir`` when it is set, exported as a
    Chrome trace (``chrome://tracing``, Perfetto); a no-op otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    from taboo_brittleness_tpu_torch.obs.profile import export_trace

    export_trace(prof, trace_dir)
