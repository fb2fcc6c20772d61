"""A clean module in the port's idiom: each hazard done the right way."""

import time

import torch

from taboo_brittleness_tpu_torch.runtime import aot


def _step(p, bufs, gen):
    logits = p["x"] @ p["embed"].T                  # stays bf16
    tok = torch.argmax(logits, dim=-1)              # on the card
    noise = torch.randn(tok.shape, generator=gen)   # seeded draw
    bufs["tok"].copy_(tok)
    return noise


def host_loop(p, bufs, gen, steps):
    prog = aot.Program(lambda q: _step(q, bufs, gen), bufs)
    t0 = time.monotonic()
    for _ in range(steps):
        prog.run(p)
    out = bufs["tok"].cpu()                         # one pull, after the steps
    return out, time.monotonic() - t0
