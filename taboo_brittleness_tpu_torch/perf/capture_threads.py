"""Which CUDA calls beside a graph capture invalidate it, measured on the card.

    python3 -m taboo_brittleness_tpu_torch.perf.capture_threads [--seconds 8]

``runtime.aot.capture`` captures a decode step on a side stream in
``thread_local`` error mode while other threads of the process keep working
(a checkpoint prefetch loads the next word, the observers sample memory).
Each mode runs in a process of its own: the main thread captures a step of
150 bf16 ``[1024, 1024]`` products (warmed up on the capture stream first,
as ``aot.capture`` does) again and again for ``--seconds`` (at most 60
captures), while either a second thread repeats one call or the capture
itself makes one call inside its window.  A mode reports how many captures
it tried and the first capture's error, if any.

Modes on another thread: ``none``, ``mem_get_info``, ``memory_stats``,
``alloc``, ``h2d``, ``d2h``, ``matmul``, ``stream_sync`` (the thread's own
stream), ``event_sync``, ``device_sync`` (``torch.cuda.synchronize``) and
``lease_keeper`` (a replica's ``serve.server.ServeLeaseKeeper`` renewing 8
request leases every 0.1 s: file IO only, the serve loop's neighbour).
Modes inside the capture: ``del_graph`` (another graph destroyed) and
``event_query``.

Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import torch

BESIDE = ("none", "mem_get_info", "memory_stats", "alloc", "h2d", "d2h",
          "matmul", "stream_sync", "event_sync", "device_sync",
          "lease_keeper")
INSIDE = ("del_graph", "event_query")
MAX_CAPTURES = 60


def _lease_keeper(stop: threading.Event) -> None:
    """A serve replica's lease keeper over 8 held requests until ``stop``."""
    import tempfile

    from taboo_brittleness_tpu_torch.runtime.fleet import LeaseStore
    from taboo_brittleness_tpu_torch.serve.server import ServeLeaseKeeper

    with tempfile.TemporaryDirectory(prefix="capture_threads_") as tmp:
        keeper = ServeLeaseKeeper(LeaseStore(tmp).ensure(), holder="r0-i0",
                                  worker="r0", lease_s=0.3).start()
        for i in range(8):
            keeper.add(f"req{i}", 0)
        stop.wait()
        keeper.stop()


def _beside(mode: str, dev: torch.device, stop: threading.Event) -> None:
    """Repeat ``mode``'s call on this thread until ``stop``."""
    if mode == "lease_keeper":
        _lease_keeper(stop)
        return
    torch.cuda.set_device(dev)
    a = torch.randn(2048, 2048, device=dev)
    host = torch.randn(2048, 2048)
    ev = torch.cuda.Event()
    while not stop.is_set():
        if mode == "none":
            time.sleep(0.001)
        elif mode == "mem_get_info":
            torch.cuda.mem_get_info(dev)
        elif mode == "memory_stats":
            torch.cuda.memory_stats(dev)
        elif mode == "alloc":
            torch.empty(1 << 20, device=dev)
        elif mode == "h2d":
            host.to(dev)
        elif mode == "d2h":
            a.cpu()
        elif mode == "matmul":
            a @ a
        elif mode == "stream_sync":
            a * 2
            torch.cuda.current_stream(dev).synchronize()
        elif mode == "event_sync":
            a * 2
            ev.record()
            ev.synchronize()
        elif mode == "device_sync":
            a * 2
            torch.cuda.synchronize(dev)


def run_mode(mode: str, seconds: float) -> dict:
    dev = torch.device("cuda", 0)
    x = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16)
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    pool = torch.cuda.graph_pool_handle()

    def step():
        y = x
        for _ in range(150):
            y = torch.tanh(y @ x)

    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.synchronize(dev)
    stop = threading.Event()
    thread = None
    if mode in BESIDE:
        thread = threading.Thread(target=_beside, args=(mode, dev, stop),
                                  daemon=True)
        thread.start()
    n, error = 0, None
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end and n < MAX_CAPTURES and error is None:
        n += 1
        victim = None
        if mode == "del_graph":
            victim = torch.cuda.CUDAGraph()
            with torch.cuda.graph(victim, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                x.add_(0)
            main.wait_stream(side)
        elif mode == "event_query":
            victim = torch.cuda.Event()
            victim.record(main)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                step()
                if mode == "del_graph":
                    victim = None
                elif mode == "event_query":
                    victim.query()
                step()
        except Exception as exc:  # noqa: BLE001 — the reading itself
            error = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
            break
        main.wait_stream(side)
        graph.replay()
    stop.set()
    if thread is not None:
        thread.join(timeout=5.0)
    return {"mode": mode, "where": "beside" if mode in BESIDE else "inside",
            "captures": n, "invalidated": error is not None, "error": error}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--mode", help=argparse.SUPPRESS)   # one child process
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        # tbx: TBX009-ok — CLI stderr contract (no card)
        print("capture_threads: no CUDA card", file=sys.stderr)
        return 2
    if args.mode:
        # tbx: TBX009-ok — CLI stdout contract (mode result JSON)
        print(json.dumps(run_mode(args.mode, args.seconds)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    # tbx: TBX009-ok — CLI stdout contract (card name and power limit)
    print(card.strip().splitlines()[0] if card.strip() else "unknown card",
          flush=True)
    rows = []
    for mode in BESIDE + INSIDE:
        proc = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--mode", mode,
             "--seconds", str(args.seconds)],
            capture_output=True, text=True, timeout=120 + args.seconds)
        if proc.returncode != 0:
            # tbx: TBX009-ok — CLI stderr contract (failed mode's stderr)
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    # tbx: TBX009-ok — CLI stdout contract (results JSON)
    print(json.dumps({"capture_threads": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
