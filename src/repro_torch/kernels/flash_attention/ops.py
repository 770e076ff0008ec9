"""Wrapper of the ``flash_attention`` CUDA kernel (B14,
``csrc/flash_attention.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`); on CUDA
tensors it launches the kernel or raises.  ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: query rows per block of csrc/flash_attention.cu
BQ = 64
#: the widest head the kernel's register tile holds
MAX_HEAD_DIM = 128
#: the dtypes the kernel takes (it accumulates in float32 for both)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Hq, S, D), k and v (B, Hkv, S, D), Hq % Hkv == 0 -> (B, Hq, S,
    D) in q's dtype: softmax(q k^T / sqrt(D)) v with an online softmax in
    float32, causal unless ``causal=False``.  Any S (a ragged tail is
    masked in the kernel) and D <= 128.  bfloat16 runs on the tensor
    cores (``mma.sync``), float32 on CUDA cores."""
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
    _build.launch("flash_attention",
                  f"flash_attention_{_build.SUFFIX[q.dtype]}", dev, q, k, v,
                  out, b, hq, k.shape[1], s, d, int(causal), 1.0 / d ** 0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
