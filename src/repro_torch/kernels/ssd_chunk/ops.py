"""Wrapper of the ``ssd_intra_chunk`` CUDA kernel (B15,
``csrc/ssd_chunk.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.ssd_chunk.ref.ssd_intra_chunk_ref`); on CUDA
tensors it launches the kernel or raises.  ``ssd_intra_chunk.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

#: query rows per block of csrc/ssd_chunk.cu
BQ = 64
#: the longest chunk, and the widest state and head, the kernel takes
MAX_CHUNK, MAX_WIDTH = 256, 128


def ssd_intra_chunk(c: torch.Tensor, b: torch.Tensor, xdt: torch.Tensor,
                    cs: torch.Tensor) -> torch.Tensor:
    """c, b (BH, nc, Q, N), xdt (BH, nc, Q, P), cs (BH, nc, Q) -> y (BH,
    nc, Q, P) float32, the causal decay-masked quadratic form of each
    chunk.  The kernel takes float32, Q <= 256 and N, P <= 128."""
    if (c.ndim != 4 or b.shape != c.shape or xdt.ndim != 4
            or xdt.shape[:3] != c.shape[:3] or cs.shape != c.shape[:3]):
        raise ValueError(f"ssd_intra_chunk needs c, b (BH, nc, Q, N), xdt "
                         f"(BH, nc, Q, P) and cs (BH, nc, Q); got "
                         f"{tuple(c.shape)}, {tuple(b.shape)}, "
                         f"{tuple(xdt.shape)}, {tuple(cs.shape)}")
    dev = _build.cuda_device("ssd_intra_chunk", c, b, xdt, cs,
                             dtypes=(torch.float32,))
    if dev is None:
        return ssd_intra_chunk_ref(c, b, xdt, cs)
    bh, nc, q, n = c.shape
    p = xdt.shape[3]
    if q > MAX_CHUNK or n > MAX_WIDTH or p > MAX_WIDTH:
        raise ValueError(f"ssd_intra_chunk: chunk {q}, state {n} or head "
                         f"{p} exceeds the kernel's Q <= {MAX_CHUNK}, "
                         f"N, P <= {MAX_WIDTH}")
    out = torch.empty((bh, nc, q, p), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("ssd_chunk", "ssd_intra_chunk_f32", dev, c, b, xdt, cs, out,
                  bh * nc, q, n, p)
    ssd_intra_chunk.launches += 1
    return out


ssd_intra_chunk.launches = 0
