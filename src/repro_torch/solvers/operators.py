"""Matvec-free linear operators of the iterative solvers (counterpart of
``repro.solvers.operators``).

Two operators behind one small interface (``shape``, ``dtype``,
``matvec(v)``):

  * :class:`ExactKernelOp` -- the EXACT kernel matrix ``K(X, X)`` applied
    through the ``kernel_matvec`` registry stage, so that K is never
    formed: O(n^2 d) flops per matvec.  CG on this operator,
    preconditioned by the HCK structured inverse, trains exact-kernel KRR
    (:func:`repro_torch.core.krr.fit_exact`), the accuracy ceiling of the
    paper's Fig. 5/6.
  * :class:`HCKOp` -- the O(n r) Algorithm-1 matvec of an HCK hierarchy
    behind the same interface, so that solvers and SLQ probes are generic
    over which kernel matrix they touch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hck import HCKFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels.registry import (DEFAULT_CONFIG, SolveConfig,
                                          get_impl, resolve_backend)

Tensor = torch.Tensor


def _as_batch(b: Tensor) -> tuple[Tensor, bool]:
    """(n,) or (n, k) -> ((n, k), squeeze_flag)."""
    if b.ndim == 1:
        return b[:, None], True
    return b, False


def _chunked_kernel_matvec(x: Tensor, y: Tensor, v: Tensor, *,
                           kernel: BaseKernel, config: SolveConfig,
                           row_chunk: int) -> Tensor:
    """z = K(X, Y) @ V: x (n, d), y (m, d), v (m, k) -> (n, k) in v's dtype.

    The computation runs in the promoted dtype of x and v, as the
    reference's does.  The plain version goes by row chunks of
    ``row_chunk``, so its transient (chunk, m) kernel tile bounds the
    memory; the CUDA kernel never forms the tile and takes all n rows in
    one launch (rows are independent, so the result is the same).
    """
    ct = torch.promote_types(x.dtype, v.dtype)
    x, y, v = (t.to(ct).contiguous() for t in (x, y, v))
    backend = resolve_backend(config, "kernel_matvec", x, y, v)
    impl = get_impl("kernel_matvec", backend)
    opts = dict(name=kernel.name, sigma=kernel.sigma)
    n = x.shape[0]
    if backend == "cuda" or n == 0:
        out = impl(x, y, v, **opts)
    else:
        chunk = min(row_chunk, n)
        out = torch.cat([impl(x[i:i + chunk], y, v, **opts)
                         for i in range(0, n, chunk)])
    return out.to(v.dtype)


@dataclasses.dataclass(frozen=True)
class ExactKernelOp:
    """The exact kernel matrix ``K(X, X) (+ jitter n I)`` as a matvec.

    ``include_jitter=True`` (default) reproduces
    :meth:`repro_torch.core.kernels_fn.BaseKernel.gram` -- the diagonal
    ``jitter * n`` is added outside the kernel -- so a CG solve on this
    operator at ridge lam matches the dense ``kernel.gram(x) + lam I``
    oracle to solver tolerance.  On CPU tensors ``row_chunk`` bounds the
    plain version's transient kernel tile to O(row_chunk n); on the card
    the ``kernel_matvec`` kernel keeps its tiles on the chip and covers
    all rows in one launch, so ``row_chunk`` is not read there.
    """

    x: Tensor
    kernel: BaseKernel
    config: SolveConfig | None = None
    row_chunk: int = 1024
    include_jitter: bool = True

    @property
    def shape(self) -> tuple[int, int]:
        """Operator shape (n, n)."""
        n = self.x.shape[0]
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        """Dtype of the point set (kept end to end)."""
        return self.x.dtype

    def matvec(self, v: Tensor) -> Tensor:
        """y = (K(X, X) [+ jitter n I]) @ v for v of shape (n,) or (n, k)."""
        config = self.config if self.config is not None else DEFAULT_CONFIG
        vb, squeeze = _as_batch(v)
        out = _chunked_kernel_matvec(self.x, self.x, vb, kernel=self.kernel,
                                     config=config, row_chunk=self.row_chunk)
        if self.include_jitter:
            out = out + (self.kernel.jitter * self.x.shape[0]) * vb
        return out[:, 0] if squeeze else out

    def cross_matvec(self, queries: Tensor, w: Tensor) -> Tensor:
        """z = K(queries, X) @ w: (q, d), (n,) or (n, k) -> (q,) or (q, k).

        The predict path of exact-kernel KRR; the cross block never gets
        the jitter (distinct sets).
        """
        config = self.config if self.config is not None else DEFAULT_CONFIG
        wb, squeeze = _as_batch(w)
        out = _chunked_kernel_matvec(queries, self.x, wb, kernel=self.kernel,
                                     config=config, row_chunk=self.row_chunk)
        return out[:, 0] if squeeze else out

    def sharded(self, mesh, axis: str = "dev") -> "ExactKernelOp":
        """Row-sharded copy of the operator: comes with the distributed
        port, ROADMAP item A14."""
        del mesh, axis
        raise NotImplementedError(
            "ExactKernelOp.sharded comes with the distributed port, ROADMAP "
            "item A14")

    def __call__(self, v: Tensor) -> Tensor:
        """Alias of :meth:`matvec` (operators are callables to solvers)."""
        return self.matvec(v)


@dataclasses.dataclass(frozen=True)
class HCKOp:
    """The O(n r) Algorithm-1 HCK matvec behind the operator interface
    (:func:`repro_torch.core.hmatrix.matvec`)."""

    factors: HCKFactors
    config: SolveConfig | None = None

    @property
    def shape(self) -> tuple[int, int]:
        """Operator shape (n, n)."""
        n = self.factors.n
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        """Dtype of the hierarchy factors."""
        return self.factors.adiag.dtype

    def matvec(self, v: Tensor) -> Tensor:
        """y = K_hck @ v through the level-synchronous Algorithm-1 sweeps."""
        from repro_torch.core import hmatrix

        return hmatrix.matvec(self.factors, v, self.config)

    def sharded(self, mesh, axis: str = "dev") -> "HCKOp":
        """Subtree-sharded copy of the operator: comes with the distributed
        port, ROADMAP item A14."""
        del mesh, axis
        raise NotImplementedError(
            "HCKOp.sharded comes with the distributed port, ROADMAP item A14")

    def __call__(self, v: Tensor) -> Tensor:
        """Alias of :meth:`matvec` (operators are callables to solvers)."""
        return self.matvec(v)
