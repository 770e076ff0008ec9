"""Device resolution for the port's entry points.

The port runs on the CUDA card by default.  The CPU is used only when the
caller asks for it (the tests do); a CUDA request on a machine without a
card raises instead of falling back silently.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """Map ``device`` (None = ``"cuda"``) to a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is present, and
    ``ValueError`` for a device type the port does not run on.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
