"""Wrapper of the ``kernel_tile`` CUDA kernel (B11, ``csrc/kernel_tile.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.kernel_tile.ref.pairwise_kernel_ref`); on CUDA
tensors it launches the kernel or raises, at every shape: the reference's
fallback to its jnp oracle below 128 rows is not carried over.
``pairwise_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref

#: rows of X (and of Y) per block tile of csrc/kernel_tile.cu
BM = BN = 64
#: the most row tiles of X one launch takes (the grid's y extent)
MAX_ROW_TILES = 65535


def pairwise_kernel(x: torch.Tensor, y: torch.Tensor, *,
                    name: str = "gaussian", sigma: float = 1.0
                    ) -> torch.Tensor:
    """K(X, Y): (n, d), (m, d) -> (n, m) float32 (inputs are cast to
    float32 first, as the reference pins)."""
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_kernel needs x (n, d) and y (m, d); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    x, y = x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous()
    dev = _build.cuda_device("pairwise_kernel", x, y)
    if dev is None:
        return pairwise_kernel_ref(x, y, name=name, sigma=sigma)
    n, d = x.shape
    m = y.shape[0]
    if -(-n // BM) > MAX_ROW_TILES:
        raise ValueError(f"pairwise_kernel: n={n} rows exceed the "
                         f"{MAX_ROW_TILES * BM} one launch covers")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("kernel_tile", "kernel_tile_f32", dev, x, y, out, n, m, d,
                  _build.EPILOGUE_KIND[name], float(sigma))
    pairwise_kernel.launches += 1
    return out


pairwise_kernel.launches = 0
