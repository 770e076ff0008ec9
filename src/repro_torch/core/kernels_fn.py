"""Base kernel functions k(x, x') (counterpart of ``repro.core.kernels_fn``).

Gaussian, Laplace and inverse multiquadric, with cross-evaluation
``K(X, Y)`` of (n, d), (m, d) -> (n, m) that also maps a leading batch
dimension, (B, n, d), (B, m, d) -> (B, n, m).  The squared Euclidean distance uses the same
||x||^2 + ||y||^2 - 2 x.y identity, clamped at 0, as the reference, so the
plain PyTorch path agrees with it to round-off in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

# name -> cross-kernel fn K(X, Y) of shapes (n, d), (m, d) -> (n, m)
_KERNELS: dict[str, Callable[..., Tensor]] = {}

#: metric each kernel's nonlinearity consumes ("l2" = SQUARED Euclidean)
KERNEL_METRIC = {"gaussian": "l2", "imq": "l2", "laplace": "l1"}


def register_kernel(name: str):
    """Decorator: register a cross-kernel fn K(X, Y) under ``name``."""
    def deco(fn):
        _KERNELS[name] = fn
        return fn

    return deco


def get_kernel(name: str) -> Callable[..., Tensor]:
    """Look up a registered base kernel by name (KeyError if unknown)."""
    if name not in _KERNELS:
        raise KeyError(f"unknown base kernel {name!r}; have {sorted(_KERNELS)}")
    return _KERNELS[name]


def _sqdist(x: Tensor, y: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances via the matmul identity,
    clamped at 0 to absorb cancellation error: (..., n, d), (..., m, d) ->
    (..., n, m)."""
    xn = torch.sum(x * x, dim=-1, keepdim=True)           # (..., n, 1)
    yn = torch.sum(y * y, dim=-1)[..., None, :]           # (..., 1, m)
    return torch.clamp(xn + yn - 2.0 * (x @ y.mT), min=0.0)


def kernel_epilogue(name: str, sigma: float) -> Callable[[Tensor], Tensor]:
    """Distance -> kernel value of base kernel ``name``.

    The distance is the squared Euclidean one for the "l2" kernels of
    :data:`KERNEL_METRIC` and the Manhattan one for "l1".
    """
    if name == "gaussian":
        return lambda d2: torch.exp(d2 * (-0.5 / (sigma * sigma)))
    if name == "imq":
        return lambda d2: sigma / torch.sqrt(d2 + sigma * sigma)
    if name == "laplace":
        return lambda d1: torch.exp(-d1 / sigma)
    raise KeyError(f"unknown base kernel {name!r}; have {sorted(KERNEL_METRIC)}")


@register_kernel("gaussian")
def gaussian_kernel(x: Tensor, y: Tensor, *, sigma: float = 1.0) -> Tensor:
    """k(x,y) = exp(-||x-y||^2 / (2 sigma^2))."""
    return kernel_epilogue("gaussian", sigma)(_sqdist(x, y))


@register_kernel("laplace")
def laplace_kernel(x: Tensor, y: Tensor, *, sigma: float = 1.0) -> Tensor:
    """k(x,y) = exp(-||x-y||_1 / sigma)."""
    d1 = torch.sum(torch.abs(x[..., :, None, :] - y[..., None, :, :]), dim=-1)
    return kernel_epilogue("laplace", sigma)(d1)


@register_kernel("imq")
def imq_kernel(x: Tensor, y: Tensor, *, sigma: float = 1.0) -> Tensor:
    """Inverse multiquadric k(x,y) = sigma / sqrt(||x-y||^2 + sigma^2)."""
    return kernel_epilogue("imq", sigma)(_sqdist(x, y))


@dataclasses.dataclass(frozen=True)
class BaseKernel:
    """A base kernel closed over its hyper-parameters.

    ``jitter`` is the lambda'-splitting rate: self blocks K(Z, Z) get
    + jitter * n * I, cross blocks never do.
    """

    name: str = "gaussian"
    sigma: float = 1.0
    jitter: float = 1e-5

    def cross(self, x: Tensor, y: Tensor) -> Tensor:
        """K(X, Y) with NO diagonal jitter (x and y are distinct sets)."""
        return get_kernel(self.name)(x, y, sigma=self.sigma)

    def gram(self, x: Tensor) -> Tensor:
        """K(X, X) + jitter * n * I."""
        k = self.cross(x, x)
        n = x.shape[0]
        return k + (self.jitter * n) * torch.eye(n, dtype=k.dtype,
                                                 device=k.device)

    def __call__(self, x: Tensor, y: Tensor) -> Tensor:
        return self.cross(x, y)
