"""Matvec-free iterative solvers (counterpart of ``repro.solvers``).

  * :mod:`repro_torch.solvers.operators` -- the exact-kernel operator
    (the ``kernel_matvec`` stage, a CUDA kernel on the card; K is never
    formed) and the O(n r) HCK matvec behind the same ``matvec(v)``.
  * :mod:`repro_torch.solvers.cg` -- batched preconditioned CG with an
    injectable inner product; the HCK structured inverse is the intended
    preconditioner, and :func:`repro_torch.core.krr.fit_exact` the entry
    point.  :mod:`repro_torch.solvers.eigenpro` is the
    truncated-eigenspectrum rival.
  * :mod:`repro_torch.solvers.slq` -- stochastic Lanczos quadrature of
    logdet and traces through any matvec; one Lanczos pass serves a whole
    ridge grid (``gp.mle_grid(..., logdet="slq")``).
"""
from repro_torch.solvers.cg import CGResult, pcg
from repro_torch.solvers.eigenpro import (EigenProPrecond, build_precond,
                                          eigenpro_solve)
from repro_torch.solvers.operators import ExactKernelOp, HCKOp
from repro_torch.solvers.slq import lanczos, slq_logdet, slq_quadrature

__all__ = [
    "CGResult", "pcg",
    "EigenProPrecond", "build_precond", "eigenpro_solve",
    "ExactKernelOp", "HCKOp",
    "lanczos", "slq_logdet", "slq_quadrature",
]
