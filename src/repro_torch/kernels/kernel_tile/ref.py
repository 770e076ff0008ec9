"""Plain PyTorch version of the pairwise kernel tile (counterpart of
``repro.kernels.kernel_tile.ref``): K(X, Y) computed in float32, the
deployment dtype the reference pins, with the clamped norm identity for
the squared-Euclidean kernels and a broadcast for laplace."""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import kernel_epilogue


def pairwise_kernel_ref(
    x: torch.Tensor, y: torch.Tensor, *, name: str = "gaussian",
    sigma: float = 1.0,
) -> torch.Tensor:
    """K(X, Y) for X (n, d), Y (m, d) -> (n, m), computed in float32."""
    pairwise_kernel_ref.calls += 1
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if name == "laplace":
        dist = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    else:
        xx = torch.sum(x * x, dim=-1)[:, None]
        yy = torch.sum(y * y, dim=-1)[None, :]
        dist = torch.clamp(xx + yy - 2.0 * (x @ y.T), min=0.0)
    return kernel_epilogue(name, sigma)(dist)


pairwise_kernel_ref.calls = 0
