"""Wrapper of the ``flash_attention`` CUDA kernels (B14,
``csrc/flash_attention.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`); on CUDA
tensors it launches one of the file's three kernels or raises, chosen by
:func:`variant` from the dtype, the head dim and the alignment before the
launch.  ``flash_attention.launches`` counts every kernel launch,
``flash_attention.wgmma_launches`` those of the Hopper (``wgmma``) kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: query rows per block of the mma.sync and CUDA-core kernels
BQ = 64
#: the widest head the kernels' register tiles hold
MAX_HEAD_DIM = 128
#: the dtypes the kernels take (they accumulate in float32 for both)
DTYPES = (torch.float32, torch.bfloat16)
#: the library symbol of each kernel of csrc/flash_attention.cu
SYMBOLS = {"wgmma": "flash_attention_bf16_wgmma",
           "mma": "flash_attention_bf16",
           "f32": "flash_attention_f32"}


def variant(dtype: torch.dtype, d: int, *ptrs: int) -> str:
    """The kernel that takes inputs of ``dtype`` and head dim ``d`` whose
    base addresses are ``ptrs``: "f32" (CUDA cores) for float32; for
    bfloat16 "wgmma" (TMA, wgmma, warp specialisation) when d % 8 == 0 and
    every base is 16-byte aligned (TMA reads rows whose strides and base
    are multiples of 16 bytes), else "mma" (mma.sync)."""
    if dtype == torch.float32:
        return "f32"
    if d % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Hq, S, D), k and v (B, Hkv, S, D), Hq % Hkv == 0 -> (B, Hq, S,
    D) in q's dtype: softmax(q k^T / sqrt(D)) v with an online softmax in
    float32, causal unless ``causal=False``.  Any S (a ragged tail is
    masked in the kernel) and D <= 128.  bfloat16 runs on the tensor
    cores (``wgmma`` or ``mma.sync``, see :func:`variant`), float32 on
    CUDA cores."""
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"flash_attention needs q (B, Hq, S, D) and k, v "
                         f"(B, Hkv, S, D) with Hq % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    dev = _build.cuda_device("attention", q, k, v, dtypes=DTYPES)
    if dev is None:
        return attention_ref(q, k, v, causal=causal, window=window)
    if window:
        raise NotImplementedError(
            "flash_attention: sliding windows (window > 0) are not in the "
            "CUDA kernel; they come with the families that use them "
            "(ROADMAP A16b)")
    b, hq, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} exceeds the "
                         f"kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kind = variant(q.dtype, d, q.data_ptr(), k.data_ptr(), v.data_ptr())
    launch_kernel(kind, q, k, v, out, causal=causal)
    return out


def launch_kernel(kind: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, out: torch.Tensor, *,
                  causal: bool = True) -> None:
    """Launch kernel ``kind`` of :data:`SYMBOLS` on CUDA tensors that
    :func:`flash_attention` has checked, writing ``out``; counts the
    launch.  The wrapper's path; called directly only to time one kernel
    against another on the same inputs."""
    b, hq, s, d = q.shape
    _build.launch("flash_attention", SYMBOLS[kind], out.device, q, k, v, out,
                  b, hq, k.shape[1], s, d, int(causal), 1.0 / d ** 0.5)
    flash_attention.launches += 1
    if kind == "wgmma":
        flash_attention.wgmma_launches += 1


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
