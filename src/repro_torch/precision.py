"""Full float32 precision for the port's entry points.

A float32 product on the card runs in full float32 unless the process
allows single-pass TF32 (``torch.set_float32_matmul_precision("high")``,
``torch.backends.cuda.matmul.allow_tf32``, and for convolutions
``torch.backends.cudnn.allow_tf32``, which is on by default).  TF32 keeps
about three decimal digits, which breaks the float32 bounds of the fit,
the solves and the SSD scan (ROADMAP, constraint (c)).  Every entry point
of the port therefore runs under :func:`full_f32`, which turns single-pass
TF32 off for cuBLAS and cuDNN and gives the caller's setting back when the
call returns or raises.  The hand-written kernels do not read these flags.

The flags are process-wide while entry points may run in several threads
at once (a serving thread beside a publishing one), so the first thread in
turns TF32 off and the last one out restores the caller's setting: one
thread leaving never turns TF32 back on under another still inside.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

_LOCK = threading.Lock()
_depth = 0                  # entry-point calls in flight, every thread
_undo: list = []            # what the first of them turned off


def _matmul_off():
    """Set cuBLAS float32 products to full precision; return the undo, or
    None when they already were."""
    try:
        old = torch.get_float32_matmul_precision()
    except RuntimeError:
        # the caller set TF32 through both the per-backend and the global
        # flags; the per-backend one decides for cuBLAS
        ns = torch.backends.cuda.matmul
        old = ns.fp32_precision
        if old == "ieee":
            return None
        ns.fp32_precision = "ieee"
        return lambda: setattr(ns, "fp32_precision", old)
    if old == "highest":
        return None
    torch.set_float32_matmul_precision("highest")
    return lambda: torch.set_float32_matmul_precision(old)


def _cudnn_off():
    """Set cuDNN float32 convolutions to full precision; return the undo,
    or None when they already were."""
    ns = torch.backends.cudnn
    try:
        old = ns.allow_tf32
    except RuntimeError:
        conv = ns.conv
        old = conv.fp32_precision
        if old == "ieee":
            return None
        conv.fp32_precision = "ieee"
        return lambda: setattr(conv, "fp32_precision", old)
    if not old:
        return None
    ns.allow_tf32 = False
    return lambda: setattr(ns, "allow_tf32", old)


@contextlib.contextmanager
def full_f32():
    """Single-pass TF32 off for cuBLAS and cuDNN inside the block; the
    caller's setting is restored when the last block in flight (in any
    thread) exits, also on an exception."""
    global _depth, _undo
    with _LOCK:
        if _depth == 0:
            _undo = [u for u in (_matmul_off(), _cudnn_off())
                     if u is not None]
        _depth += 1
    try:
        yield
    finally:
        with _LOCK:
            _depth -= 1
            if _depth == 0:
                for u in reversed(_undo):
                    u()
                _undo = []


def entry_point(fn):
    """Run ``fn`` under :func:`full_f32` (a decorator for the port's entry
    points; ``fn.full_f32`` marks them)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    wrapper.full_f32 = True
    return wrapper
