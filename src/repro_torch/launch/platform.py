"""Process-level platform setup of the port (counterpart of
``repro.launch.platform``).

The reference routes every entry point through ``setup_platform`` before
its first ``import jax``, to set ``JAX_PLATFORMS`` and XLA flags.  The
port has no XLA: what it sets is the device its entry points and
launchers run on when the caller names none (``repro_torch.device``):

  * ``platform`` or ``REPRO_PLATFORM``: "gpu" (the card; raises without
    one, as ``device.resolve`` does) or "cpu".  Unset keeps the port's
    default, the card.
  * ``host_devices`` or ``REPRO_HOST_DEVICES``: the number of host
    processes a CPU mesh runs as (``torch.distributed`` with the gloo
    backend), recorded for ROADMAP A14's mesh; nothing reads it yet.

Arguments beat the environment variables.  Idempotent; returns a record
of what was applied.  The reference's GPU XLA flag set has no
counterpart, and the record says so.
"""
from __future__ import annotations

import os

from repro_torch import device as _device

PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def setup_platform(platform: str | None = None,
                   host_devices: int | None = None) -> dict:
    """Set the port's default device from ``platform`` (or
    ``REPRO_PLATFORM``) and record ``host_devices`` (or
    ``REPRO_HOST_DEVICES``); returns ``{"platform", "device",
    "host_devices", "flags", "xla_flags"}``."""
    platform = platform or os.environ.get("REPRO_PLATFORM") or None
    if host_devices is None:
        hd = os.environ.get("REPRO_HOST_DEVICES")
        host_devices = int(hd) if hd else None
    if platform is not None:
        if platform not in PLATFORMS:
            raise ValueError(f"platform {platform!r} not in "
                             f"{sorted(PLATFORMS)}")
        _device.set_default(PLATFORMS[platform])
    return {"platform": platform, "device": _device.default(),
            "host_devices": host_devices, "flags": [],
            "xla_flags": "none: the port runs no XLA (the reference's GPU "
                         "flag set has no counterpart)"}
