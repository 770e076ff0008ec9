"""Stochastic Lanczos quadrature: logdet and traces through any matvec
(counterpart of ``repro.solvers.slq``).

Estimates ``tr f(A)`` of an SPD operator reachable only through matvecs:
Hutchinson probes z give ``tr f(A) ~ mean_z z^T f(A) z``, and each
quadratic form is a Gauss quadrature read off the probe's Lanczos
tridiagonalisation, ``z^T f(A) z ~ ||z||^2 sum_i tau_i^2 f(theta_i)``.
Lanczos on ``A + lam I`` gives ``T + lam I`` on the same basis, so one
pass per probe serves a whole ridge grid (``gp.mle_grid(...,
logdet="slq")``).  Full reorthogonalisation keeps the converged Ritz
values, where log(theta) is read, from being counted twice.

Randomness does not cross frameworks: the Rademacher probes are an
optional ``(probes, n)`` argument, drawn from a ``torch.Generator``
otherwise.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import device as _device

Tensor = torch.Tensor


def lanczos(
    matvec: Callable[[Tensor], Tensor],
    v0: Tensor,
    iters: int,
    *,
    all_reduce: Callable[[Tensor], Tensor] | None = None,
) -> tuple[Tensor, Tensor]:
    """Lanczos tridiagonalisation of an SPD matvec from one start vector.

    ``v0`` (n,) is normalised here.  Returns ``(alphas (iters,), betas
    (iters - 1,))``, the diagonal and off-diagonal of T, computed with full
    reorthogonalisation against the kept basis.  ``all_reduce`` is applied
    to every inner product (alpha, the reorthogonalisation coefficients
    and the beta norms), so a caller holding a row slice of the vectors
    can make them global; None keeps local sums.  A beta below 1e-12
    (Krylov space exhausted) gives a zero basis row, whose Ritz weight is
    ~0.
    """
    reduce = all_reduce if all_reduce is not None else (lambda s: s)

    def vdot(u, w):
        return reduce(torch.dot(u, w))

    def vnorm(u):
        return torch.sqrt(reduce(torch.dot(u, u)))

    q = v0 / vnorm(v0)
    basis = [q]
    alphas, betas = [], []
    for j in range(iters):
        w = matvec(q)
        if w.ndim == 2:                       # operators may return (n, 1)
            w = w[:, 0]
        alpha = vdot(q, w)
        alphas.append(alpha)
        w = w - alpha * q
        if j > 0:
            w = w - betas[-1] * basis[-2]
        # full reorthogonalisation: converged Ritz directions reappear in
        # plain Lanczos and would count their f(theta) weight twice
        qs = torch.stack(basis)               # (j + 1, n)
        w = w - qs.T @ reduce(qs @ w)
        beta = vnorm(w)
        if j < iters - 1:
            betas.append(beta)
            q = torch.where(beta > 1e-12, w / torch.clamp(beta, min=1e-30),
                            torch.zeros_like(w))
            basis.append(q)
    return (torch.stack(alphas),
            torch.stack(betas) if betas else v0.new_zeros((0,)))


def _tridiag_eigh(alphas: Tensor, betas: Tensor) -> tuple[Tensor, Tensor]:
    """Eigenvalues and first-row eigenvector weights tau^2 of the
    tridiagonal T."""
    t = (torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1))
    theta, vecs = torch.linalg.eigh(t)
    return theta, vecs[0, :] ** 2


def rademacher_probes(probes: int, n: int, *, dtype: torch.dtype,
                      device=None,
                      generator: torch.Generator | None = None) -> Tensor:
    """(probes, n) Rademacher (+-1) probe vectors from ``generator``
    (default seeded 0 on ``device``; None is the card)."""
    dev = _device.resolve(device if device is not None else (
        generator.device if generator is not None else None))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    bits = torch.randint(0, 2, (probes, n), generator=generator, device=dev)
    return (2 * bits - 1).to(dtype)


def _slq_nodes(matvec, n: int, iters: int, probes: int, probe_vectors,
               generator, dtype, device, all_reduce) -> tuple[Tensor, Tensor]:
    """Ritz nodes and weights of every probe: ((probes, iters), (probes,
    iters)).  Each probe costs ``iters`` matvecs; the probes run one
    after another."""
    z = probe_vectors
    if z is None:
        z = rademacher_probes(probes, n, dtype=dtype, device=device,
                              generator=generator)
    elif z.ndim != 2 or z.shape[1] != n:
        raise ValueError(f"probe_vectors must be (probes, {n}); got "
                         f"{tuple(z.shape)}")
    nodes = [_tridiag_eigh(*lanczos(matvec, zp, iters,
                                    all_reduce=all_reduce)) for zp in z]
    return (torch.stack([t for t, _ in nodes]),
            torch.stack([w for _, w in nodes]))


def slq_quadrature(
    matvec: Callable[[Tensor], Tensor],
    n: int,
    f: Callable[[Tensor], Tensor],
    *,
    probes: int = 8,
    iters: int = 30,
    probe_vectors: Tensor | None = None,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    all_reduce: Callable[[Tensor], Tensor] | None = None,
    n_total: int | None = None,
) -> Tensor:
    """tr f(A) ~ n * mean over probes of sum_i tau_i^2 f(theta_i) (scalar).

    ``matvec`` is an SPD (n, n) operator on (n,) vectors; ``f`` acts on
    the Ritz values elementwise (``torch.log`` for the logdet).
    ``probe_vectors`` (probes, n) replaces the Rademacher draws, which
    otherwise come from ``generator`` on ``device`` (None: the
    generator's device, else the card).  ``n_total`` is the trace scale
    when ``n`` counts a row slice.
    """
    theta, tau2 = _slq_nodes(matvec, n, iters, probes, probe_vectors,
                             generator, dtype, device, all_reduce)
    scale = n_total if n_total is not None else n
    return scale * torch.mean(torch.sum(tau2 * f(theta), dim=-1))


def slq_logdet(
    matvec: Callable[[Tensor], Tensor],
    n: int,
    *,
    ridges=None,
    probes: int = 8,
    iters: int = 30,
    probe_vectors: Tensor | None = None,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    floor: float = 1e-12,
    all_reduce: Callable[[Tensor], Tensor] | None = None,
    n_total: int | None = None,
) -> Tensor:
    """logdet(A + lam I) over a whole ridge grid from ONE Lanczos pass.

    A scalar (logdet(A)) when ``ridges`` is None, else a (G,) vector: the
    Ritz values of A + lam I are theta + lam, so the grid costs nothing
    beyond the ``probes * iters`` matvecs.  ``floor`` clamps theta + lam
    away from 0.  The probes are those of :func:`slq_quadrature`.
    """
    theta, tau2 = _slq_nodes(matvec, n, iters, probes, probe_vectors,
                             generator, dtype, device, all_reduce)
    scale = n_total if n_total is not None else n
    if ridges is None:
        vals = torch.log(torch.clamp(theta, min=floor))
        return scale * torch.mean(torch.sum(tau2 * vals, dim=-1))
    ridges = torch.as_tensor(ridges, dtype=theta.dtype, device=theta.device)
    shifted = theta[None, :, :] + ridges[:, None, None]     # (G, probes, it)
    vals = torch.log(torch.clamp(shifted, min=floor))
    return scale * torch.mean(torch.sum(tau2[None] * vals, dim=-1), dim=-1)
