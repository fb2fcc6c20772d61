"""Seeded TBX008 violations: mutable defaults and module-level tensors in a
step that a CUDA graph captures."""

import torch

from taboo_brittleness_tpu_torch.runtime import aot

SCALE = torch.ones(4)                               # module-level tensor


def _step(x, taps=[]):                              # TBX008: mutable default
    return x * SCALE                                # TBX008: captured tensor


def _step_default(x, bias=torch.zeros(4)):         # TBX008: tensor default
    return x + bias


def programs():
    return (aot.Program(_step, None), aot.Program(_step_default, None))
