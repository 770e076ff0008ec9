"""Wrapper of the ``ssd_intra_chunk`` CUDA kernels (B15,
``csrc/ssd_chunk.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.ssd_chunk.ref.ssd_intra_chunk_ref`); on CUDA
tensors it launches one of the library's two kernels or raises, chosen by
:func:`variant` from the widths and the addresses before the launch: both
run their products on the tensor cores in split TF32.
``ssd_intra_chunk.launches`` counts every launch,
``ssd_intra_chunk.wgmma_launches`` those of the Hopper (``wgmma``) kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

#: the longest chunk, and the widest state and head, the kernels take
MAX_CHUNK, MAX_WIDTH = 256, 128
#: the widest state and head the wgmma kernel takes (two 32-column boxes)
WGMMA_WIDTH = 64
#: the library symbol of each kernel of csrc/ssd_chunk.cu
SYMBOLS = {"wgmma": "ssd_intra_chunk_wgmma_f32", "mma": "ssd_intra_chunk_f32"}


def variant(n: int, p: int, *ptrs: int) -> str:
    """The kernel that takes state width ``n`` and head width ``p`` on
    tensors whose base addresses are ``ptrs``: "wgmma" (TMA, warp
    specialisation) when n and p are multiples of 4 from 4 to 64 and every
    base is 16-byte aligned (TMA reads rows whose strides and bases are
    multiples of 16 bytes; the kernel keeps two 32-column boxes a row),
    else "mma" (mma.sync)."""
    if (0 < n <= WGMMA_WIDTH and 0 < p <= WGMMA_WIDTH and n % 4 == 0
            and p % 4 == 0 and all(ptr % 16 == 0 for ptr in ptrs)):
        return "wgmma"
    return "mma"


def ssd_intra_chunk(c: torch.Tensor, b: torch.Tensor, xdt: torch.Tensor,
                    cs: torch.Tensor) -> torch.Tensor:
    """c, b (BH, nc, Q, N), xdt (BH, nc, Q, P), cs (BH, nc, Q) -> y (BH,
    nc, Q, P) float32, the causal decay-masked quadratic form of each
    chunk.  The kernels take float32, Q <= 256 and N, P <= 128, and run
    both products on the tensor cores in split TF32 (as accurate as
    float32); :func:`variant` chooses one."""
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
    kind = variant(n, p, c.data_ptr(), b.data_ptr(), xdt.data_ptr())
    launch_kernel(kind, c, b, xdt, cs, out)
    return out


def launch_kernel(kind: str, c: torch.Tensor, b: torch.Tensor,
                  xdt: torch.Tensor, cs: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch kernel ``kind`` of :data:`SYMBOLS` on CUDA tensors that
    :func:`ssd_intra_chunk` has checked, writing ``out``; counts the
    launch.  The wrapper's path; called directly only to time one kernel
    against the other on the same inputs."""
    bh, nc, q, n = c.shape
    _build.launch("ssd_chunk", SYMBOLS[kind], out.device, c, b, xdt, cs, out,
                  bh * nc, q, n, xdt.shape[3])
    ssd_intra_chunk.launches += 1
    if kind == "wgmma":
        ssd_intra_chunk.wgmma_launches += 1


ssd_intra_chunk.launches = 0
ssd_intra_chunk.wgmma_launches = 0
