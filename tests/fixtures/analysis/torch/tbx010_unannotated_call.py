"""TBX010 corpus: registered entry points called with no profiler
annotation.  The rule is PATH-scoped (only ``taboo_brittleness_tpu_torch/``
outside ``analysis/``), so tests scan this file under a package ``rel``."""

import torch

from taboo_brittleness_tpu_torch import obs
from taboo_brittleness_tpu_torch.runtime import aot
from taboo_brittleness_tpu_torch.runtime.decode import greedy_decode


def bad_call(params, cfg, ids, valid, pos):
    return greedy_decode(params, cfg, ids, valid, pos, max_new_tokens=4)


def good_call(params, cfg, ids, valid, pos):
    with obs.profile.annotate("decode", fn=greedy_decode):
        return greedy_decode(params, cfg, ids, valid, pos, max_new_tokens=4)


def good_record_function(params, cfg, ids, valid, pos):
    with torch.profiler.record_function("tbx:decode#0"):
        return greedy_decode(params, cfg, ids, valid, pos, max_new_tokens=4)


def reviewed_call(params, cfg, ids, valid, pos):
    # tbx: TBX010-ok — warm-up call, device time is deliberately anonymous
    return greedy_decode(params, cfg, ids, valid, pos, max_new_tokens=4)


def _step(params, cfg, ids, valid, pos):
    # Inside a replayed step this is not a launch site: never flagged.
    return greedy_decode(params, cfg, ids, valid, pos, max_new_tokens=4)


def program():
    return aot.Program(_step, None)
