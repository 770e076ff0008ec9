"""Batched preconditioned conjugate gradients on any matvec-free operator
(counterpart of ``repro.solvers.cg``).

Multi-RHS PCG on ``(A + ridge I) x = b``, where ``A`` is anything with a
matvec: the exact-kernel operator, the O(n r) HCK matvec.  The HCK
structured inverse (:func:`repro_torch.core.hmatrix.apply_inverse`) is the
intended preconditioner.  Every right-hand-side column runs its own
scalar recurrence (per-column alpha and beta), so one operator sweep
serves the whole block.  The inner product is injectable (``dot=``).

The reference's ``lax.while_loop`` is a Python loop here, with one host
read of the residual per iteration; the residual trace and the
``iterations`` / ``converged`` contract are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

#: denominator guard: a converged direction gives alpha = rz / eps-ish
#: instead of a 0/0 NaN that would poison the whole batch.  True curvature
#: breakdowns (p^T A p ~ 0 with rz large: a singular operator fed an
#: inconsistent right-hand side) are handled by the per-column freeze in
#: :func:`pcg`'s step, because this clamp alone turns them into a runaway
#: alpha that overflows the iterate.
_EPS = 1e-30


@dataclasses.dataclass
class CGResult:
    """Outcome of one :func:`pcg` (or EigenPro) call.

    ``x`` keeps the right-hand side's shape ((n,) or (n, k));
    ``residuals[i]`` is the max-over-columns RELATIVE residual after i
    iterations (entry 0 the initial one; entries past ``iterations``
    repeat the final value); ``iterations`` is the count actually run and
    ``converged`` whether every column met ``tol`` within ``maxiter``.
    """

    x: Tensor
    iterations: int
    residuals: Tensor          # (maxiter + 1,) relative residual trace
    converged: bool


def column_dot(u: Tensor, v: Tensor) -> Tensor:
    """Column-wise inner products: (n, k), (n, k) -> (k,)."""
    return torch.sum(u * v, dim=0)


def axis_dot(axis: str) -> Callable[[Tensor, Tensor], Tensor]:
    """Mesh-wide :func:`column_dot`: comes with the distributed port,
    ROADMAP item A14."""
    del axis
    raise NotImplementedError(
        "axis_dot (mesh-wide inner products) comes with the distributed "
        "port, ROADMAP item A14")


def run_traced_iteration(step, state0, r0: Tensor, bb: Tensor, *, tol: float,
                         maxiter: int, dot=column_dot) -> tuple:
    """Shared loop of the residual-traced iterative solvers.

    Runs ``state, r = step(state, r, it)`` until the max-over-columns
    relative residual ||r|| / ||b|| drops to ``tol`` or ``maxiter``
    iterations have run, and records the trace as :class:`CGResult`
    documents.  :func:`pcg` and the EigenPro Richardson loop both run on
    it.  Returns ``(state, iterations, trace, converged)``.
    """
    bnorm = torch.sqrt(torch.clamp(dot(bb, bb), min=_EPS))      # (k,)

    def rel_of(r):
        return torch.max(torch.sqrt(torch.clamp(dot(r, r), min=0.0)) / bnorm)

    trace = [rel_of(r0)]
    rel = float(trace[0])
    state, r, it = state0, r0, 0
    while it < maxiter and rel > tol:
        state, r = step(state, r, it)
        it += 1
        trace.append(rel_of(r))
        rel = float(trace[-1])
    # freeze the trace past the exit point, so it plots without masking
    trace = torch.stack(trace + [trace[-1]] * (maxiter - it))
    return state, it, trace, rel <= tol


def pcg(
    matvec: Callable[[Tensor], Tensor],
    b: Tensor,
    *,
    ridge: Tensor | float = 0.0,
    precond: Callable[[Tensor], Tensor] | None = None,
    tol: float = 1e-6,
    maxiter: int = 100,
    dot: Callable[[Tensor, Tensor], Tensor] | None = None,
    x0: Tensor | None = None,
    flexible: bool = True,
) -> CGResult:
    """Preconditioned CG on ``(A + ridge I) x = b``, batched over columns.

    matvec:   v -> A v for v of the shape of ``b`` (it must take the
              batched (n, k) form; both operators and ``hmatrix.matvec``
              do).
    b:        (n,) or (n, k) right-hand sides; the result matches.
    ridge:    lam added to the operator's diagonal.
    precond:  r -> M^-1 r, an SPD approximation of (A + ridge I)^-1, e.g.
              ``lambda r: hmatrix.apply_inverse(inv, r)``.  None = identity.
    tol:      relative-residual target ||b - A x|| / ||b|| per column;
              ``tol=0`` runs exactly ``maxiter`` iterations.
    maxiter:  iteration cap (sizes the residual trace).
    dot:      column-wise inner product (u, v) -> (k,).
    x0:       warm start (default zeros).
    flexible: the Polak-Ribiere beta (flexible PCG, default) instead of
              Fletcher-Reeves: identical in exact arithmetic, but it stays
              convergent when the preconditioner is inexact, as the f32
              Algorithm-2 inverse is.
    """
    dot = dot if dot is not None else column_dot
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b

    def _col(u):
        return u if u.ndim == 2 else u[:, None]

    def amv(v):
        # 1-D callers get 1-D vectors back
        av = matvec(v[:, 0]) if squeeze else matvec(v)
        return _col(av) + ridge * v

    def psolve(r):
        if precond is None:
            return r
        return _col(precond(r[:, 0])) if squeeze else precond(r)

    x = torch.zeros_like(bb) if x0 is None else (
        x0[:, None] if squeeze else x0)
    r0 = bb - amv(x)
    z = psolve(r0)

    def step(state, r, it):
        del it
        x, z, p, rz = state
        ap = amv(p)
        pap = dot(p, ap)                                  # (k,) curvature
        # breakdown freeze: on a singular (or indefinite) operator the
        # direction collapses into the near-null space, where alpha =
        # rz / p^T A p compounds and overflows the iterate.  A column whose
        # Rayleigh quotient p^T A p / p^T p falls below a few ulps is frozen
        # for this step (alpha = beta = 0): it keeps its iterate and
        # restarts from steepest descent, while healthy columns never trip
        # the test and see the same arithmetic.
        eps = torch.finfo(pap.dtype).eps
        broken = pap <= 8.0 * eps * torch.clamp(dot(p, p), min=_EPS)
        zero = torch.zeros_like(pap)
        alpha = torch.where(broken, zero, rz / torch.clamp(pap, min=_EPS))
        x = x + alpha[None, :] * p
        r_new = r - alpha[None, :] * ap
        z_new = psolve(r_new)
        rz_new = dot(r_new, z_new)
        if flexible:                     # Polak-Ribiere: robust to an
            num = dot(r_new - r, z_new)  # inexact (f32) preconditioner
        else:                            # Fletcher-Reeves (textbook PCG)
            num = rz_new
        beta = torch.where(broken, zero, num / torch.clamp(rz, min=_EPS))
        p = z_new + beta[None, :] * p
        return (x, z_new, p, rz_new), r_new

    state, it, trace, converged = run_traced_iteration(
        step, (x, z, z, dot(r0, z)), r0, bb, tol=tol, maxiter=maxiter,
        dot=dot)
    x = state[0]
    return CGResult(x[:, 0] if squeeze else x, it, trace, converged)
