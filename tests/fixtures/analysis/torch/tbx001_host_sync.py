"""Seeded TBX001 violations in the port's idiom: host syncs reachable from
a step handed to ``aot.Program`` (the port's replayed step).  The checker's
corpus: ``tests/test_torch_analysis.py`` asserts the exact codes and line
numbers; the repo gates exclude it and nothing imports it."""

import torch

from taboo_brittleness_tpu_torch.runtime import aot


def _pull_helper(x: torch.Tensor):
    return x.cpu()                      # TBX001: .cpu() in the step's reach


def _step(p, bufs):
    torch.cuda.synchronize()            # TBX001: a device-wide sync in a captured step
    n = bufs["n"].item()                # TBX001: .item() in the step
    hits = bufs["mask"].nonzero()       # TBX001: .nonzero() sizes its output on the host
    done = bool(bufs["done"].all())     # TBX001: bool(<tensor>) reads the card
    return _pull_helper(p) + n + hits + done


def make_program(bufs):
    return aot.Program(lambda p: _step(p, bufs), bufs)


def untraced(x: torch.Tensor):
    return x.cpu().numpy()              # not in any step's reach: fine
