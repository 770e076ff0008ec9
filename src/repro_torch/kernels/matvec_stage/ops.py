"""Wrapper of the ``kernel_matvec`` CUDA kernel (B10,
``csrc/kernel_matvec.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.matvec_stage.ref.kernel_matvec_ref`); on CUDA
tensors it launches the kernel or raises.  One launch covers every row
of Xc: the kernel never materialises the (b, m) tile, so, unlike the
plain version, it needs no row chunking.  ``kernel_matvec.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref

#: tile shape of csrc/kernel_matvec.cu (pair_tile.cuh): rows of Xc and of
#: Y per block tile, features per staged chunk, V columns per pass
BM = BN = 64
DC = 32
KC = 32


def matvec_smem(kc: int, itemsize: int) -> int:
    """Shared memory of one block for ``kc`` columns: the two staged
    feature chunks (DC x (BM + 1) and DC x (BN + 1)), the (BM, BN + 1)
    kernel tile, a (BN, KC + 1) chunk of V and the (BM, kc) accumulators."""
    return (DC * (BM + 1 + BN + 1) + BM * (BN + 1) + BN * (KC + 1)
            + BM * kc) * itemsize


def max_columns(itemsize: int) -> int:
    """The most right-hand-side columns one launch keeps on the chip."""
    return (_build.SMEM_MAX // itemsize - DC * (BM + BN + 2)
            - BM * (BN + 1) - BN * (KC + 1)) // BM


def kernel_matvec(
    xc: torch.Tensor, y: torch.Tensor, v: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """z = K(Xc, Y) V: (b, d), (m, d), (m, k) -> (b, k), in the dtype of
    the inputs (float32 or float64, all one dtype on the card).

    Every column group of up to :func:`max_columns` columns (at most 745 in
    float32 and 291 in float64, above any width the solvers use) is one
    launch that computes the distances once for all of its columns.
    """
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")
    if (xc.ndim != 2 or y.ndim != 2 or v.ndim != 2
            or xc.shape[1] != y.shape[1] or v.shape[0] != y.shape[0]):
        raise ValueError(
            "kernel_matvec needs xc (b, d), y (m, d) and v (m, k); got "
            f"{tuple(xc.shape)}, {tuple(y.shape)}, {tuple(v.shape)}")
    dev = _build.cuda_device("kernel_matvec", xc, y, v)
    if dev is None:
        return kernel_matvec_ref(xc, y, v, name=name, sigma=sigma)
    b, d = xc.shape
    m, k = v.shape
    z = torch.empty((b, k), dtype=xc.dtype, device=dev)
    if z.numel() == 0:
        return z
    sym = f"kernel_matvec_{_build.SUFFIX[xc.dtype]}"
    step = max_columns(xc.element_size())
    for k0 in range(0, k, step):
        kc = min(step, k - k0)
        _build.check_smem("kernel_matvec",
                          matvec_smem(kc, xc.element_size()),
                          f"{kc} right-hand-side columns")
        _build.launch("kernel_matvec", sym, dev, xc, y, v[:, k0:], z[:, k0:],
                      b, m, d, kc, k, _build.EPILOGUE_KIND[name],
                      float(sigma))
        kernel_matvec.launches += 1
    return z


kernel_matvec.launches = 0
