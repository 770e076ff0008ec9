"""Wrapper of the ``leaf_update`` CUDA kernel (B13, ``csrc/leaf_update.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.update_stage.ref.leaf_update_ref`); on CUDA
tensors it launches the kernel or raises.  ``leaf_update.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.update_stage.ref import leaf_update_ref


def update_smem(n0: int, k: int, itemsize: int) -> int:
    """Shared memory of one leaf_update block: B^T, L21^T and (L21 Linv)^T
    (n0 rows of stride k | 1), S and L22^-1 (k rows of stride k + 1)."""
    return (3 * n0 * (k | 1) + 2 * k * (k + 1)) * itemsize


def leaf_update(lo: torch.Tensor, linv: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, n0, n0) ``lo`` / ``linv``, (P, k, n0) ``b``, (P, k, k) ``c`` ->
    the extended pair (P, n0 + k, n0 + k), leading quadrants copied."""
    if any(t.ndim != 3 for t in (lo, linv, b, c)):
        raise ValueError("leaf_update needs 3-D lo, linv, b and c")
    p, n0, _ = lo.shape
    k = b.shape[1]
    if (lo.shape != (p, n0, n0) or linv.shape != (p, n0, n0)
            or b.shape != (p, k, n0) or c.shape != (p, k, k)):
        raise ValueError(
            "leaf_update needs lo and linv (P, n0, n0), b (P, k, n0) and c "
            f"(P, k, k); got {tuple(lo.shape)}, {tuple(linv.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}")
    dev = _build.cuda_device("leaf_update", lo, linv, b, c)
    if dev is None:
        return leaf_update_ref(lo, linv, b, c)
    _build.check_smem("leaf_update", update_smem(n0, k, lo.element_size()),
                      f"n0={n0}, k={k}")
    ne = n0 + k
    lo_ext = torch.empty((p, ne, ne), dtype=lo.dtype, device=dev)
    linv_ext = torch.empty_like(lo_ext)
    if p == 0:
        return lo_ext, linv_ext
    _build.launch("leaf_update", f"leaf_update_{_build.SUFFIX[lo.dtype]}",
                  dev, lo, linv, b, c, lo_ext, linv_ext, p, n0, k)
    leaf_update.launches += 1
    return lo_ext, linv_ext


leaf_update.launches = 0
