"""Wrapper of the ``hck_leaf_project`` CUDA kernel (``csrc/hck_leaf_project.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.hck_leaf.ref.hck_leaf_project_ref`); on CUDA
tensors it launches the kernel or raises.  ``leaf_project.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref

_SYMBOLS = {torch.float32: "hck_leaf_project_f32",
            torch.float64: "hck_leaf_project_f64"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _entry(dtype: torch.dtype):
    lib = _build.load("hck_leaf_project")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def leaf_project(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c = U^T b per leaf: (P, n0, r), (P, n0, k) -> (P, r, k)."""
    if u.ndim != 3 or b.ndim != 3 or u.shape[:2] != b.shape[:2]:
        raise ValueError(f"leaf_project needs u (P, n0, r) and b (P, n0, k); "
                         f"got {tuple(u.shape)} and {tuple(b.shape)}")
    if u.device.type == "cpu" and b.device.type == "cpu":
        return hck_leaf_project_ref(u, b)
    if u.device.type != "cuda" or b.device != u.device:
        raise ValueError(f"leaf_project needs both tensors on one CUDA device; "
                         f"got {u.device} and {b.device}")
    if u.dtype not in _SYMBOLS or b.dtype != u.dtype:
        raise TypeError(f"leaf_project kernel takes float32 or float64 of one "
                        f"dtype; got {u.dtype} and {b.dtype}")
    if not (u.is_contiguous() and b.is_contiguous()):
        raise ValueError("leaf_project kernel needs contiguous tensors")
    p, n0, r = u.shape
    k = b.shape[2]
    c = torch.empty((p, r, k), dtype=u.dtype, device=u.device)
    if c.numel() == 0:
        return c
    lib, fn = _entry(u.dtype)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = fn(u.data_ptr(), b.data_ptr(), c.data_ptr(), p, n0, r, k,
                  stream)
    _build.check_launch(lib, "hck_leaf_project", code)
    leaf_project.launches += 1
    return c


leaf_project.launches = 0
