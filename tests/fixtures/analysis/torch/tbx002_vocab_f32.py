"""Seeded TBX002 violations: f32 materialization of vocab-carrying tensors."""

import torch


def readout(x, embed, probs_bf16):
    logits = (x @ embed.T).float()                  # TBX002: `logits` target
    wide = probs_bf16.to(torch.float32)             # TBX002: `probs_bf16` receiver
    cast = probs_bf16.to(dtype=torch.float32)       # TBX002: dtype= keyword
    other = probs_bf16.type(torch.float32)          # TBX002: .type()
    rows = x.float()                                # [N, D] rows: fine
    noise = torch.randn(4, 641).float()             # a fresh draw: fine
    return logits, wide, cast, other, rows, noise
