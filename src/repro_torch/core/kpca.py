"""Kernel PCA with the HCK kernel (counterpart of ``repro.core.kpca``;
paper section 5.6).

The embedding comes from the top eigenpairs of the centered kernel matrix

    Kc = (I - 1 1^T / n) K (I - 1 1^T / n),

applied through the O(n r) hierarchical matvec and found by subspace
(block power) iteration, so the O(n^2) matrix never exists.
:func:`kpca_fit` wraps the embedding into a :class:`KPCAModel` whose
``transform`` maps new points into the same principal subspace through
the Algorithm-3 prediction engine: the centered projection needs only
``w^T k_hck(X, x)`` products with ``w = [V, 1/n]``, so a query costs
O((n0 + r) d) like any prediction.  On the card every matvec is the
``leaf_matvec`` kernel and every prediction the ``oos_contract`` kernel.

Also the dense oracles :func:`kpca_embed_dense` and :func:`center`, and
the embedding-alignment metric of Fig. 8, :func:`alignment_difference`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.core import hmatrix
from repro_torch.core.hck import HCKFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels.registry import SolveConfig
from repro_torch.precision import entry_point

Tensor = torch.Tensor


def _centered_matvec(f: HCKFactors, b: Tensor,
                     config: SolveConfig | None = None) -> Tensor:
    b = b - torch.mean(b, dim=0, keepdim=True)
    y = hmatrix.matvec(f, b, config)
    return y - torch.mean(y, dim=0, keepdim=True)


def kpca_embed(
    f: HCKFactors, dim: int, *, iters: int = 50, v0: Tensor | None = None,
    generator: torch.Generator | None = None,
    solve_config: SolveConfig | None = None,
) -> tuple[Tensor, Tensor]:
    """Top-``dim`` kernel-PCA embedding by subspace iteration.

    The block has q = min(dim + 4, n) columns (oversampling): ``v0``
    (n, q), or standard normal draws from ``generator`` (default seeded
    0).  Every sweep is one (n, q) hierarchical matvec.  Returns
    (embedding (n, dim) = eigenvectors * sqrt(eigenvalues), eigenvalues).
    """
    n = f.n
    q = min(dim + 4, n)
    if v0 is None:
        if generator is None:
            generator = torch.Generator(
                device=f.x_sorted.device).manual_seed(0)
        v0 = torch.randn((n, q), dtype=f.x_sorted.dtype,
                         device=f.x_sorted.device, generator=generator)
    elif v0.shape != (n, q):
        raise ValueError(f"v0 must be (n, q) = {(n, q)}; got "
                         f"{tuple(v0.shape)}")
    v, _ = torch.linalg.qr(v0.to(f.x_sorted))
    for _ in range(iters):
        v, _ = torch.linalg.qr(_centered_matvec(f, v, solve_config))
    # Rayleigh-Ritz on the converged subspace
    t = v.T @ _centered_matvec(f, v, solve_config)
    evals, evecs = torch.linalg.eigh(0.5 * (t + t.T))
    order = torch.argsort(evals, descending=True)[:dim]
    evals = evals[order]
    u = (v @ evecs)[:, order]
    return u * torch.sqrt(torch.clamp(evals, min=0.0)), evals


@dataclasses.dataclass
class KPCAModel:
    """Kernel-PCA embedding plus its out-of-sample transform.

    ``embedding`` rows are in tree order (aligned with
    ``factors.x_sorted``).  ``transform`` projects new points on the same
    eigenbasis:

        psi(x) = Lambda^-1/2 (V^T k_vec - (1^T k_vec / n) V^T 1 - V^T g),
        g = H K 1 / n,

    where every query-dependent term is a ``w^T k_hck(X, x)`` product
    served by the prediction engine with the stacked weights
    ``w = [V, 1/n]`` (dim + 1 columns of one plan).
    """

    kernel: BaseKernel
    factors: HCKFactors
    embedding: Tensor          # (n, dim) = V sqrt(Lambda), tree order
    evals: Tensor              # (dim,)
    v1: Tensor                 # (dim,)  V^T 1
    a0: Tensor                 # (dim,)  V^T (H K 1 / n)
    solve_config: SolveConfig | None = None

    def __post_init__(self):
        self._engine = None

    @property
    def engine(self):
        """Prediction engine over the stacked weights [V, 1/n]."""
        from repro_torch.serving.predict_service import PredictEngine

        if self._engine is None:
            n = self.embedding.shape[0]
            v = self.embedding / self._scale()              # eigenvectors
            w = torch.cat([v, torch.full((n, 1), 1.0 / n, dtype=v.dtype,
                                         device=v.device)], dim=1)
            PredictEngine.attach(self, weights=w)
        return self._engine

    def _scale(self) -> Tensor:
        return torch.sqrt(torch.clamp(self.evals, min=1e-30))

    @entry_point
    def transform(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q, dim) coordinates in the principal subspace."""
        dim = self.embedding.shape[1]
        z = self.engine(queries)                            # (q, dim + 1)
        proj = z[:, :dim] - z[:, dim:] * self.v1[None] - self.a0[None]
        return proj / self._scale()[None]


@entry_point
def kpca_fit(
    f: HCKFactors, kernel: BaseKernel, dim: int, *, iters: int = 50,
    v0: Tensor | None = None, generator: torch.Generator | None = None,
    solve_config: SolveConfig | None = None, device=None,
) -> KPCAModel:
    """Embed the training set and package the out-of-sample transform.

    ``f`` is a fitted :class:`HCKFactors` on ``device`` (None is the CUDA
    card, raising without one; "cpu" the plain path); ``v0`` or
    ``generator`` give the start block of :func:`kpca_embed`.  Returns a
    :class:`KPCAModel` whose ``embedding`` is (n, dim) in tree order and
    whose ``transform`` maps (q, d) queries to (q, dim).
    """
    dev = _device.resolve(device)
    if f.x_sorted.device.type != dev.type:
        raise ValueError(f"factors on {f.x_sorted.device}, device {dev}; "
                         "build them on the device the fit runs on")
    emb, evals = kpca_embed(f, dim, iters=iters, v0=v0, generator=generator,
                            solve_config=solve_config)
    v = emb / torch.sqrt(torch.clamp(evals, min=1e-30))
    k1 = hmatrix.matvec(f, torch.full((f.n,), 1.0 / f.n, dtype=emb.dtype,
                                      device=emb.device), solve_config)
    g = k1 - torch.mean(k1)                                  # H K 1 / n
    return KPCAModel(kernel, f, emb, evals, v1=torch.sum(v, dim=0),
                     a0=v.T @ g, solve_config=solve_config)


def kpca_embed_dense(k_centered: Tensor, dim: int) -> tuple[Tensor, Tensor]:
    """Dense oracle: eigendecomposition of an explicitly centered matrix."""
    evals, evecs = torch.linalg.eigh(k_centered)
    order = torch.argsort(evals, descending=True)[:dim]
    evals = evals[order]
    return (evecs[:, order] * torch.sqrt(torch.clamp(evals, min=0.0)),
            evals)


def center(k: Tensor) -> Tensor:
    """Dense double-centering (I - 1 1^T / n) K (I - 1 1^T / n) (oracle)."""
    n = k.shape[0]
    h = (torch.eye(n, dtype=k.dtype, device=k.device)
         - torch.full((n, n), 1.0 / n, dtype=k.dtype, device=k.device))
    return h @ k @ h


def alignment_difference(u: Tensor, u_tilde: Tensor) -> Tensor:
    """Fig. 8 metric: min_M ||U - U~ M||_F / ||U||_F, with M the
    unconstrained least-squares aligner, as in the paper."""
    m = torch.linalg.lstsq(u_tilde, u).solution
    return (torch.linalg.vector_norm(u - u_tilde @ m)
            / torch.linalg.vector_norm(u))
