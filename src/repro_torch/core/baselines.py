"""Approximate-kernel baselines the paper compares against (counterpart of
``repro.core.baselines``; paper sections 1.2 and 5).

  * Nystrom low-rank kernel (Eq. 6)         -- landmark features
  * random Fourier features (Eq. 7)         -- stationary kernels only
  * cross-domain independent kernel (Eq. 8) -- block-diagonal over the
                                               flattened tree
  * dense exact KRR                         -- the O(n^3) oracle

Each has the same O(n r^2) budget as HCK, so the Fig. 3/5/6 comparisons
compare like with like.  Plain torch throughout; every random draw can
be injected (randomness does not cross frameworks), else it comes from a
``torch.Generator``.  ``device`` None is the card, as for every entry
point of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import PartitionTree, build_partition, route

Tensor = torch.Tensor


def _inputs(x, y, device, generator):
    """x, y on the resolved device and a generator there (default seed 0)."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return x, (y if y.ndim > 1 else y[:, None]).to(x.dtype), generator


# ---------------------------------------------------------------------------
# Nystrom (Eq. 6): k(x, Xl) K(Xl, Xl)^-1 k(Xl, x')
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NystromModel:
    """Fitted Nystrom regressor (Eq. 6): explicit landmark feature map."""

    kernel: BaseKernel
    landmarks: Tensor          # (r, d)
    beta: Tensor               # (r, k): predict = k(x, Xl) @ beta

    def predict(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q, k) through the landmark cross kernel."""
        return self.kernel.cross(queries, self.landmarks) @ self.beta


def fit_nystrom(x, y, *, kernel: BaseKernel, lam: float, rank: int,
                landmark_index=None, generator: torch.Generator | None = None,
                device=None) -> NystromModel:
    """Primal ridge in the Nystrom feature space.

    With Phi = K(X, Xl) L^-T (L = chol K(Xl, Xl)), beta = L^-T (Phi^T Phi +
    lam I)^-1 Phi^T y, so that predict(x) = k(x, Xl) beta is the dual KRR
    fit (K_nys + lam I)^-1 y with the same, unscaled, lam as the HCK and
    dense solves.  The landmarks are rows ``landmark_index`` (r,), else
    the first r of a random permutation from ``generator``.  O(n r^2).
    """
    x, yk, generator = _inputs(x, y, device, generator)
    n = x.shape[0]
    if landmark_index is None:
        landmark_index = torch.randperm(n, generator=generator,
                                        device=x.device)[:rank]
    lm = x[torch.as_tensor(landmark_index, device=x.device)]
    lo = torch.linalg.cholesky(kernel.gram(lm))           # (r, r), jittered
    knm = kernel.cross(x, lm)                             # (n, r)
    phi = torch.linalg.solve_triangular(lo, knm.T, upper=False).T
    gram = phi.T @ phi + lam * torch.eye(rank, dtype=x.dtype, device=x.device)
    coef = torch.linalg.solve(gram, phi.T @ yk)           # (r, k)
    beta = torch.linalg.solve_triangular(lo.T, coef, upper=True)
    return NystromModel(kernel, lm, beta)


# ---------------------------------------------------------------------------
# Random Fourier features (Eq. 7): Gaussian and Laplace spectral densities
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RFFModel:
    """Fitted random-Fourier-features regressor (Eq. 7)."""

    omega: Tensor              # (d, r)
    bias: Tensor               # (r,)
    beta: Tensor               # (r, k)

    def features(self, x: Tensor) -> Tensor:
        """(n, d) -> (n, r) cosine features sqrt(2 / r) cos(x w + b)."""
        r = self.omega.shape[1]
        return math.sqrt(2.0 / r) * torch.cos(x @ self.omega + self.bias)

    def predict(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q, k) predictions in feature space."""
        return self.features(queries) @ self.beta


def _sample_spectral(name: str, sigma: float, d: int, r: int, *,
                     dtype: torch.dtype, device,
                     generator: torch.Generator | None = None) -> Tensor:
    """(d, r) frequencies from the spectral density of base kernel
    ``name``: N(0, 1/sigma^2) for gaussian, iid Cauchy(0, 1/sigma) for
    laplace (a product of 1-d exponential kernels)."""
    if name == "gaussian":
        return torch.randn((d, r), generator=generator, dtype=dtype,
                           device=device) / sigma
    if name == "laplace":
        u = torch.rand((d, r), generator=generator, dtype=dtype,
                       device=device)
        return torch.tan(math.pi * (u - 0.5)) / sigma
    raise ValueError(f"no spectral density registered for kernel {name!r} "
                     "(paper: IMQ transform 'little known', not compared)")


def fit_rff(x, y, *, kernel: BaseKernel, lam: float, rank: int, omega=None,
            bias=None, generator: torch.Generator | None = None,
            device=None) -> RFFModel:
    """Ridge regression on r random Fourier features (the paper's RF
    baseline).  ``omega`` (d, r) and ``bias`` (r,) replace the draws from
    ``generator``: frequencies from the kernel's spectral density, biases
    uniform on [0, 2 pi)."""
    x, yk, generator = _inputs(x, y, device, generator)
    opts = dict(dtype=x.dtype, device=x.device)
    if omega is None:
        omega = _sample_spectral(kernel.name, kernel.sigma, x.shape[1], rank,
                                 generator=generator, **opts)
    if bias is None:
        bias = 2.0 * math.pi * torch.rand((rank,), generator=generator,
                                          **opts)
    model = RFFModel(torch.as_tensor(omega).to(**opts),
                     torch.as_tensor(bias).to(**opts), None)
    phi = model.features(x)
    gram = phi.T @ phi + lam * torch.eye(rank, **opts)
    return dataclasses.replace(model, beta=torch.linalg.solve(gram,
                                                              phi.T @ yk))


# ---------------------------------------------------------------------------
# Cross-domain independent kernel (Eq. 8): block-diagonal over a flat tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IndependentModel:
    """Block-diagonal ("independent") kernel baseline: one KRR per leaf."""

    kernel: BaseKernel
    tree: PartitionTree
    x_sorted: Tensor           # (n, d)
    alpha: Tensor              # (2**L, n0, k) per-block dual coefficients

    def predict(self, queries: Tensor) -> Tensor:
        """Route each query to its leaf and apply that block's KRR:
        (q, d) -> (q,) for one target column, else (q, k)."""
        leaf = route(self.tree, queries)
        n0 = self.alpha.shape[1]
        xl = self.x_sorted.reshape(-1, n0, self.x_sorted.shape[-1])[leaf]
        kv = self.kernel.cross(xl, queries[:, None, :])[:, :, 0]   # (q, n0)
        out = torch.einsum("qnk,qn->qk", self.alpha[leaf], kv)
        return out[:, 0] if out.shape[1] == 1 else out


def fit_independent(x, y, *, kernel: BaseKernel, lam: float, levels: int,
                    method: str = "rp", directions=None,
                    generator: torch.Generator | None = None,
                    device=None) -> IndependentModel:
    """Per-block exact KRR on the leaves of the HCK partition, flattened
    (section 5.1).  ``directions`` replace the tree's random draws from
    ``generator``; ``method`` "rp" (random projections) or "pca"
    (principal directions, no draw)."""
    x, yk, generator = _inputs(x, y, device, generator)
    n = x.shape[0]
    x_sorted, tree = build_partition(x, levels, directions=directions,
                                     generator=generator, method=method)
    n0 = n >> levels
    blocks = x_sorted.reshape(1 << levels, n0, -1)
    eye = torch.eye(n0, dtype=x.dtype, device=x.device)
    grams = (kernel.cross(blocks, blocks)
             + (kernel.jitter * n0 + lam) * eye)         # gram + lam I
    alpha = torch.linalg.solve(grams,
                               yk[tree.perm].reshape(1 << levels, n0, -1))
    return IndependentModel(kernel, tree, x_sorted, alpha)


# ---------------------------------------------------------------------------
# Dense (exact) KRR: the non-approximate reference for small n
# ---------------------------------------------------------------------------

def fit_exact(x, y, *, kernel: BaseKernel, lam: float,
              device=None) -> Callable[[Tensor], Tensor]:
    """Dense-kernel KRR (the O(n^3) oracle); returns a predict closure
    (q, d) -> (q,) for one target column, else (q, k)."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    kxx = kernel.gram(x) + lam * torch.eye(x.shape[0], dtype=x.dtype,
                                           device=dev)
    alpha = torch.linalg.solve(kxx, (y if y.ndim > 1 else y[:, None])
                               .to(x.dtype))

    def predict(queries: Tensor) -> Tensor:
        out = kernel.cross(torch.as_tensor(queries, device=dev), x) @ alpha
        return out[:, 0] if out.shape[1] == 1 else out

    return predict
