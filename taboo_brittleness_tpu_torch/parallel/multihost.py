"""Process groups, host-aware meshes and the rank launcher.

The counterpart of the JAX package's ``parallel/multihost.py``.  There one
process per host joins ``jax.distributed`` and every host's devices form
one global view.  Here every rank is a process of its own, so this module
also starts them:

- :func:`initialize` joins this process to the ``torch.distributed`` group
  when it has arguments or finds a coordinator in the environment, and is a
  no-op otherwise, so every entry point can call it.  JAX's coordinator
  address maps to ``MASTER_ADDR``/``MASTER_PORT``, its process count to
  ``WORLD_SIZE`` and its process id to ``RANK`` (``torchrun``'s variables,
  which are read as they are).  ``TBX_DIST_INIT`` (an ``init_method``
  such as ``file:///path``) takes precedence over them.
- :func:`worker_initialize` joins a fleet worker to its own slice's group
  from the ``TBX_FLEET_*`` variables, never the global ones.
- :func:`make_host_mesh` keeps ``tp`` and ``sp`` inside a host: only
  ``dp`` may cross hosts.
- :func:`spawn_peers` starts ranks 1..N-1 of a command as child processes
  of rank 0 (``serve --tp 2``, the sweep commands under a multi-rank
  ``config.mesh``), and :func:`run_ranks` runs a function on N ranks
  (tests and ``chip_smoke.py``), each with a file rendezvous.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from taboo_brittleness_tpu_torch.config import MeshConfig
from taboo_brittleness_tpu_torch.parallel.mesh import (
    Mesh,
    choose_backend,
    make_mesh,
    mesh_sizes,
)

#: JAX's coordinator variables, mapped onto ``MASTER_ADDR``/``MASTER_PORT``.
COORDINATOR_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                    "MEGASCALE_COORDINATOR_ADDRESS")


#: How long a collective waits for its peers before it raises: a rank that
#: fails on its own leaves the others waiting this long.
TIMEOUT = datetime.timedelta(hours=1)


def _join(init_method: str, world: int, rank: int,
          device: Optional[torch.device]) -> bool:
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    dev = torch.device(device) if device is not None else torch.device("cpu")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, _ = choose_backend(dev, local)
    if dev.type == "cpu" and world > 1:
        # CPU ranks share the host's cores: one intra-op thread each (a
        # spinning thread pool per rank slows a small step a hundredfold).
        torch.set_num_threads(1)
    if backend == "nccl" and dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return True


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Any = None) -> bool:
    """Join the process group; True when it did (or had).

    A no-op (False) without arguments and without a coordinator in the
    environment: ``TBX_DIST_INIT``, ``MASTER_ADDR`` with ``WORLD_SIZE``, or
    one of JAX's :data:`COORDINATOR_VARS`.  As in JAX, scheduler markers
    such as ``SLURM_JOB_ID`` do not count.  ``device`` picks the backend
    (``parallel.mesh.choose_backend``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    explicit = any(a is not None
                   for a in (coordinator_address, num_processes, process_id))
    env = os.environ
    coord = coordinator_address or next(
        (env[v] for v in COORDINATOR_VARS if env.get(v)), None)
    init = env.get("TBX_DIST_INIT")
    torchrun = bool(env.get("MASTER_ADDR") and env.get("WORLD_SIZE"))
    if not (explicit or coord or init or torchrun):
        return False
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None else env.get("RANK", "0"))
    if init is None:
        if coord:
            host, _, port = coord.rpartition(":")
            init = f"tcp://{host}:{port}"
        else:
            init = "env://"
    return _join(init, world, rank, device)


def worker_initialize(device: Any = None) -> bool:
    """Join a fleet worker to ITS slice's process group, from
    ``TBX_FLEET_COORDINATOR`` (``host:port`` of the slice's rank 0),
    ``TBX_FLEET_NUM_PROCESSES`` and ``TBX_FLEET_PROCESS_ID``.  Unset (the
    local fleet: N workers on one host) it is a no-op and the worker runs
    alone, like any other pipeline invocation."""
    addr = os.environ.get("TBX_FLEET_COORDINATOR")
    if not addr:
        return False
    num = os.environ.get("TBX_FLEET_NUM_PROCESSES")
    pid = os.environ.get("TBX_FLEET_PROCESS_ID")
    host, _, port = addr.rpartition(":")
    return _join(f"tcp://{host}:{port}", int(num) if num else 1,
                 int(pid) if pid else 0, device)


def plan_host_mesh(mesh_cfg: Optional[MeshConfig],
                   hosts: Sequence[int]) -> Dict[str, int]:
    """(dp, tp, sp) extents for ranks whose hosts are ``hosts`` (one host
    index per rank, in rank order), such that every (tp, sp) block of the
    rank layout sits on one host.  ``tp``/``sp`` of -1 absorb the PER-HOST
    remainder.  Raises for uneven hosts, for ``tp * sp`` that does not
    divide a host's ranks, and for ranks not numbered host by host."""
    mesh_cfg = mesh_cfg or MeshConfig()
    n = len(hosts)
    n_hosts = len(set(hosts))
    if n_hosts <= 1:
        return mesh_sizes(mesh_cfg, n)
    if n % n_hosts:
        raise ValueError(
            f"{n} devices across {n_hosts} hosts are uneven; every host must "
            "contribute the same device count")
    per_host = n // n_hosts
    sp, tp = mesh_cfg.sp, mesh_cfg.tp
    if sp == -1 and tp == -1:
        raise ValueError("at most one of tp/sp may be -1")
    if sp == -1:
        sp = per_host // max(tp, 1)
    if tp == -1:
        tp = per_host // max(sp, 1)
    if per_host % (tp * sp):
        raise ValueError(
            f"tp*sp={tp * sp} must divide the {per_host} devices per host: "
            "the model axes must stay on one host; only dp may cross hosts")
    dp = mesh_cfg.dp
    if dp == -1:
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"mesh dp={dp} tp={tp} sp={sp} needs {dp * tp * sp} "
                         f"devices, have {n} across {n_hosts} hosts")
    block = tp * sp
    for start in range(0, n, block):
        if len(set(hosts[start:start + block])) != 1:
            raise ValueError("ranks are not numbered host by host: a (tp, sp) "
                             f"block spans hosts {sorted(set(hosts[start:start + block]))}")
    return {"dp": dp, "tp": tp, "sp": sp}


def make_host_mesh(mesh_cfg: Optional[MeshConfig] = None, *,
                   device: Any = None) -> Mesh:
    """This rank's mesh over every process of the group, host-aware
    (:func:`plan_host_mesh` over each rank's host name).  Alone, or on one
    host, it is ``parallel.mesh.make_mesh``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(mesh_cfg, device=device)
    names: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    index = {h: i for i, h in enumerate(dict.fromkeys(names))}
    sizes = plan_host_mesh(mesh_cfg, [index[h] for h in names])
    return make_mesh(MeshConfig(**sizes), device=device)


# ---------------------------------------------------------------------------
# Starting ranks.
# ---------------------------------------------------------------------------

def in_group() -> bool:
    """Whether this process is a rank some launcher started (``torchrun``
    or :func:`spawn_peers`): it must not start ranks of its own."""
    return bool(os.environ.get("TBX_DIST_INIT")
                or (os.environ.get("MASTER_ADDR")
                    and os.environ.get("WORLD_SIZE")))


def _die_with_parent() -> None:
    """In a child: get SIGKILL when the parent dies (Linux), so a rank 0
    that is killed leaves no peer blocked in a collective.  (A peer latches
    SIGTERM into the drain, which a rank blocked in a collective never
    reads.)"""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass


class Peers:
    """Ranks 1..N-1 of one command, started by rank 0."""

    def __init__(self, procs: List[subprocess.Popen], tmpdir: str):
        self.procs = procs
        self.tmpdir = tmpdir

    def wait(self, timeout_s: float = 120.0) -> List[int]:
        """Exit codes, after each peer ends (killed past ``timeout_s``)."""
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=timeout_s))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        import shutil

        shutil.rmtree(self.tmpdir, ignore_errors=True)
        return codes

    def kill(self) -> None:
        """End the peers now (rank 0 failed: they may be blocked in a
        collective that will never complete)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def spawn_peers(world: int, argv: Sequence[str], *,
                module: str = "taboo_brittleness_tpu_torch") -> Peers:
    """Start ranks 1..``world``-1 as ``python -m module *argv`` with a file
    rendezvous, and set this process up as rank 0 of the same group (the
    caller then calls :func:`initialize`).  The peers' stdout is discarded
    (rank 0 owns the command's outputs); their stderr is this process's."""
    tmpdir = tempfile.mkdtemp(prefix="tbx-ranks-")
    init = f"file://{os.path.join(tmpdir, 'rendezvous')}"
    base = dict(os.environ, TBX_DIST_INIT=init, WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world))
    procs = []
    for rank in range(1, world):
        env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env,
            stdout=subprocess.DEVNULL, preexec_fn=_die_with_parent))
    os.environ.update(TBX_DIST_INIT=init, WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
    return Peers(procs, tmpdir)


def _rank_main(rank: int, world: int, init: str, device: Optional[str],
               fn: Callable, args: tuple, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    _join(init, world, rank, torch.device(device) if device else None)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, device: Any = None,
              workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks joined over a
    file rendezvous in ``workdir`` (a temporary directory by default);
    returns each rank's result (saved with ``torch.save``).  ``fn`` must be
    importable by its module path.  Raises when a rank fails."""
    import torch.multiprocessing as mp

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="tbx-ranks-")
    os.makedirs(workdir, exist_ok=True)
    init = f"file://{os.path.join(workdir, 'rendezvous')}"
    try:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, init, str(device) if device else None, fn, args,
                       workdir))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        if own:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
