"""Plain PyTorch version of the fused exact-kernel matvec stage
(counterpart of ``repro.kernels.matvec_stage.ref``).

Dtype-preserving, unlike :func:`repro_torch.kernels.kernel_tile.ref.
pairwise_kernel_ref`: float64 inputs run the distances, the epilogue and
the contraction in float64, because the exact-kernel operator is the
accuracy ceiling the iterative solvers are gated against.  The kernel
values are :mod:`repro_torch.core.kernels_fn`'s, so in float64 it agrees
with the reference's to round-off.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import get_kernel


def kernel_matvec_ref(
    xc: torch.Tensor, y: torch.Tensor, v: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """z = K(Xc, Y) V: (b, d), (m, d), (m, k) -> (b, k).

    The (b, m) kernel tile is transient; callers chunk over the rows so
    that it stays O(b m), never O(n^2).
    """
    kernel_matvec_ref.calls += 1
    return get_kernel(name)(xc, y, sigma=sigma) @ v


kernel_matvec_ref.calls = 0
