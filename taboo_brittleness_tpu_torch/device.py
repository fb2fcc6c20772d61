"""Device selection shared by every entry point of the port.

An entry point that is not given a device runs on ``cuda`` and raises when
CUDA is absent: the port never falls back to the CPU on its own.  The CPU is
used only when a caller asks for it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for a CUDA device when
    ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default is cuda) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev

