"""Where the port's entry points run.

``System``, ``Tracker``, ``LocalMapper``, ``KeyFrameDatabase`` and local
BA's public functions take ``device="cuda"`` by default: the port is built
for the card. On a machine without one they raise unless the caller passes
``device="cpu"``; they never move to the CPU by themselves.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}, but torch.cuda.is_available() is false: "
            "pass device='cpu' to run on the CPU"
        )
    return dev
