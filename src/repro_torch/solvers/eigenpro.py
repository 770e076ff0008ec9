"""EigenPro-style preconditioned Richardson iteration for exact-kernel KRR
(counterpart of ``repro.solvers.eigenpro``).

The rival to HCK-preconditioned CG (Ma and Belkin, "Diving into the
shallows", NIPS 2017): the preconditioner flattens the TOP of the kernel
spectrum,

  P = I - U diag(1 - tau / lam_i) U^T,   tau = lam_{q+1},

with (lam_i, U) the top-q eigenpairs of K estimated from a Nystrom
subsample, so Richardson iteration x <- x + eta P (b - (K + ridge) x)
converges at the rate of the truncated spectral radius.  K is touched
only through :class:`repro_torch.solvers.operators.ExactKernelOp`: the
eigenvector extension is one ``cross_matvec`` and the Rayleigh-Ritz
polish one multi-column ``matvec`` (q = ``n_components`` columns, which
on the card is one ``kernel_matvec`` launch each).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.solvers.cg import CGResult, run_traced_iteration
from repro_torch.solvers.operators import ExactKernelOp

Tensor = torch.Tensor


@dataclasses.dataclass
class EigenProPrecond:
    """Truncated-top-spectrum preconditioner P = I - U diag(w) U^T.

    ``u`` (n, q) approximate top eigenvectors of K (orthonormal),
    ``weights`` (q,) = 1 - (tau / lam_i)^alpha (discarded components
    weigh 0), ``tail`` = tau, the smallest kept eigenvalue, and ``rho`` =
    tau^alpha lam_1^(1 - alpha), the spectral radius after
    preconditioning that sets the Richardson step.
    """

    u: Tensor
    weights: Tensor
    tail: Tensor
    rho: Tensor

    def apply(self, g: Tensor) -> Tensor:
        """P g: damp the top-q eigendirections of the gradient."""
        return g - self.u @ (self.weights[:, None] * (self.u.T @ g))


def build_precond(
    op: ExactKernelOp,
    generator: torch.Generator | None = None,
    *,
    permutation: Tensor | None = None,
    n_components: int = 64,
    subsample: int = 1024,
    alpha: float = 0.9,
    rel_floor: float = 1e-5,
) -> EigenProPrecond:
    """Estimate the top-q eigensystem of K by Nystrom subsampling.

    The subsample is the first s = min(``subsample``, n) entries of
    ``permutation`` (an (n,) permutation of the rows, e.g. the
    reference's draw), else of ``torch.randperm`` from ``generator``.
    Eigendecompose the (s, s) subsample kernel, extend q =
    min(``n_components``, s - 1) eigenvectors to all n points by one
    cross matvec, orthonormalise them and polish by one Rayleigh-Ritz
    step (one exact q-column matvec), discard Ritz values below
    ``rel_floor`` times the largest and damp the rest with exponent
    ``alpha``, as the reference does.
    """
    x = op.x
    n = x.shape[0]
    s = min(subsample, n)
    q = min(n_components, s - 1)
    if permutation is None:
        permutation = torch.randperm(n, generator=generator, device=x.device)
    idx = torch.as_tensor(permutation, device=x.device)[:s]
    xs = x[idx]
    ks = op.kernel.cross(xs, xs)                       # (s, s), no jitter
    mu, v = torch.linalg.eigh(ks)                      # ascending
    mu = torch.clamp(mu.flip(0), min=1e-30)            # descending
    v = v.flip(1)
    # Nystrom extension U = K(X, Xs) V diag(sqrt(s / n) / mu): an operator
    # over the subsample, applied to all points as queries
    scale = (s / n) ** 0.5 / mu[:q]
    sub_op = dataclasses.replace(op, x=xs)
    u = sub_op.cross_matvec(x, v[:, :q] * scale[None, :])          # (n, q)
    # Rayleigh-Ritz: orthonormal basis, one exact multi-column matvec,
    # rediagonalise the (q, q) projection
    qmat, _ = torch.linalg.qr(u)
    bmat = qmat.T @ op.matvec(qmat)
    lam, y = torch.linalg.eigh((bmat + bmat.T) / 2)   # ascending
    lam = torch.clamp(lam.flip(0), min=1e-30)         # descending Ritz values
    vecs = qmat @ y.flip(1)
    kept = lam > rel_floor * lam[0]                   # a prefix
    tail = lam[int(kept.sum()) - 1]                   # smallest kept
    weights = torch.where(kept, 1.0 - (tail / lam) ** alpha,
                          torch.zeros_like(lam))
    rho = tail ** alpha * lam[0] ** (1.0 - alpha)
    return EigenProPrecond(vecs, weights, tail, rho)


def eigenpro_solve(
    op: ExactKernelOp,
    b: Tensor,
    *,
    ridge: Tensor | float,
    generator: torch.Generator | None = None,
    permutation: Tensor | None = None,
    n_components: int = 64,
    subsample: int = 1024,
    tol: float = 1e-6,
    maxiter: int = 300,
    precond: EigenProPrecond | None = None,
) -> CGResult:
    """Solve (K + ridge I) x = b by EigenPro-preconditioned Richardson.

    The contract of :func:`repro_torch.solvers.cg.pcg` (multi-RHS,
    relative-residual trace, :class:`CGResult`).  ``precond`` may be
    passed prebuilt; otherwise :func:`build_precond` draws its subsample
    from ``permutation`` or ``generator``.
    """
    pc = precond if precond is not None else build_precond(
        op, generator, permutation=permutation, n_components=n_components,
        subsample=subsample)
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    eta = 1.0 / (pc.rho + ridge + 1e-12)              # post-precond radius

    def amv(v):
        return op.matvec(v) + ridge * v

    def step(x, r, it):
        del it
        x = x + eta * pc.apply(r)
        return x, bb - amv(x)

    x, it, trace, converged = run_traced_iteration(
        step, torch.zeros_like(bb), bb, bb, tol=tol, maxiter=maxiter)
    return CGResult(x[:, 0] if squeeze else x, it, trace, converged)
