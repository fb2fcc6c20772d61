"""Seeded TBX006 violations: clocks and unseeded draws in a replayed step
(an entry registered through ``aot.lookup``)."""

import random
import time

import torch

from taboo_brittleness_tpu_torch.runtime import aot


def noisy_step(x, gen):
    jitter = random.random()                        # TBX006: Python random
    stamp = time.perf_counter()                     # TBX006: host clock
    eps = torch.randn(x.shape)                      # TBX006: no generator=
    drop = torch.rand_like(x)                       # TBX006: no generator=
    pick = torch.multinomial(x, 1)                  # TBX006: no generator=
    x.normal_()                                     # TBX006: in-place draw
    seeded = torch.randn(x.shape, generator=gen)    # seeded: fine
    return x * jitter + stamp + eps + drop + pick + seeded


def launch(x, gen, device):
    return aot.lookup("noisy", noisy_step, {}, {}, params=x, device=device,
                      make=lambda: aot.Program(lambda p: None, None))
