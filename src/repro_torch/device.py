"""Device resolution for the port's entry points.

The port runs on the CUDA card by default.  The CPU is used only when the
caller asks for it (the tests do, and ``setup_platform("cpu")`` makes it
the default); a CUDA request on a machine without a card raises instead
of falling back silently.  :func:`timed` records a
stage's wall time with the card's queue drained on both sides.
"""
from __future__ import annotations

import time

import torch


#: the device ``resolve(None)`` gives: the card unless
#: :func:`set_default` (``launch.platform.setup_platform``) chose the CPU
_DEFAULT = "cuda"


def set_default(device: str) -> None:
    """Make ``device`` ("cuda" or "cpu") what the entry points run on when
    the caller names none; "cuda" raises without a card, as
    :func:`resolve` does."""
    global _DEFAULT
    _DEFAULT = str(resolve(device))


def default() -> str:
    """The device ``resolve(None)`` gives."""
    return _DEFAULT


def resolve(device: str | torch.device | None = None) -> torch.device:
    """Map ``device`` (None = the default, ``"cuda"`` unless
    :func:`set_default` changed it) to a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is present, and
    ``ValueError`` for a device type the port does not run on.
    """
    dev = torch.device(_DEFAULT if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(timings: dict | None, name: str, dev: torch.device, fn):
    """``fn()``; with ``timings`` (a dict) also its wall seconds, between
    two synchronisations of ``dev``, in ``timings[name]``."""
    if timings is None:
        return fn()
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    timings[name] = time.perf_counter() - t0
    return out
