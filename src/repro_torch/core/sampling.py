"""GP sample paths from the HCK prior, without ever forming K (counterpart
of ``repro.core.sampling``; the paper's section 6 "simulation of random
processes").

z = f(A) eps with f = sqrt, approximated by a Chebyshev polynomial of A
applied through the O(n r) Algorithm-1 matvec (:func:`repro_torch.core.
hmatrix.matvec`, the ``leaf_matvec`` kernel on the card):

    A^(1/2) eps ~ sum_k c_k T_k(A~) eps,   A~ = affine map of A onto [-1, 1]

The coefficients come from the DCT of sqrt on the spectral interval
[lo, hi] (hi by power iteration, lo the ridge floor).  Cost O(degree n r).
The random draws (the power-iteration start vector, the samples' noise)
can be injected, else they come from a ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hmatrix
from repro_torch.core.hck import HCKFactors
from repro_torch.kernels.registry import SolveConfig

Tensor = torch.Tensor


def _generator(f: HCKFactors, generator):
    if generator is None:
        return torch.Generator(device=f.adiag.device).manual_seed(0)
    return generator


def estimate_spectral_range(f: HCKFactors, ridge: float, *, iters: int = 30,
                            v0: Tensor | None = None,
                            generator: torch.Generator | None = None,
                            config: SolveConfig | None = None
                            ) -> tuple[float, float]:
    """(lo, hi) bounds of eig(K_hck + ridge I): hi by ``iters`` steps of
    power iteration from ``v0`` (n,) (default a standard normal draw from
    ``generator``), with 10% headroom; lo = 0.99 ridge (K_hck is PSD)."""
    if v0 is None:
        v0 = torch.randn((f.n,), generator=_generator(f, generator),
                         dtype=f.adiag.dtype, device=f.adiag.device)
    v = torch.as_tensor(v0).to(f.adiag)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = hmatrix.matvec(f, v, config) + ridge * v
        v = w / torch.linalg.vector_norm(w)
    hi = float(v @ (hmatrix.matvec(f, v, config) + ridge * v))
    return float(ridge) * 0.99, hi * 1.1


def chebyshev_coeffs(fn, lo: float, hi: float, degree: int) -> np.ndarray:
    """Chebyshev expansion coefficients of ``fn`` on [lo, hi] (host-side)."""
    k = np.arange(degree + 1)
    nodes = np.cos(np.pi * (k + 0.5) / (degree + 1))        # in [-1, 1]
    x = 0.5 * (hi - lo) * nodes + 0.5 * (hi + lo)
    fx = fn(x)
    coeffs = np.zeros(degree + 1)
    for j in range(degree + 1):
        coeffs[j] = 2.0 / (degree + 1) * np.sum(
            fx * np.cos(np.pi * j * (k + 0.5) / (degree + 1)))
    coeffs[0] *= 0.5
    return coeffs


def _cheb_apply(f: HCKFactors, ridge: float, eps: Tensor, coeffs: Tensor,
                lo: float, hi: float, degree: int,
                config: SolveConfig | None) -> Tensor:
    """sum_k c_k T_k(A~) eps by the three-term recurrence (eps (n,) or
    (n, s)); A~ maps [lo, hi] onto [-1, 1]."""
    alpha = 2.0 / (hi - lo)
    beta = -(hi + lo) / (hi - lo)

    def amv(v):
        return alpha * (hmatrix.matvec(f, v, config) + ridge * v) + beta * v

    t_prev, t_cur = eps, amv(eps)                 # T_0 eps, T_1 eps
    acc = coeffs[0] * t_prev + coeffs[1] * t_cur
    for k in range(2, degree + 1):
        t_prev, t_cur = t_cur, 2.0 * amv(t_cur) - t_prev
        acc = acc + coeffs[k] * t_cur
    return acc


def sample_prior(f: HCKFactors, *, ridge: float, num_samples: int = 1,
                 degree: int = 64, eps: Tensor | None = None,
                 v0: Tensor | None = None,
                 generator: torch.Generator | None = None,
                 config: SolveConfig | None = None) -> Tensor:
    """Draw ``num_samples`` ~ N(0, K_hck + ridge I): (num_samples, n).

    ``eps`` (num_samples, n) replaces the standard normal draws and ``v0``
    the power iteration's start vector; both otherwise come from
    ``generator`` (the start vector first).  All samples share one
    Chebyshev recurrence, as the columns of one block.
    """
    generator = _generator(f, generator)
    lo, hi = estimate_spectral_range(f, ridge, v0=v0, generator=generator,
                                     config=config)
    dt = f.adiag.dtype
    coeffs = torch.as_tensor(chebyshev_coeffs(np.sqrt, lo, hi, degree),
                             dtype=dt, device=f.adiag.device)
    if eps is None:
        eps = torch.randn((num_samples, f.n), generator=generator, dtype=dt,
                          device=f.adiag.device)
    eps = torch.as_tensor(eps).to(f.adiag)
    return _cheb_apply(f, ridge, eps.T.contiguous(), coeffs, lo, hi, degree,
                       config).T


def sqrt_matvec(f: HCKFactors, eps: Tensor, *, ridge: float,
                degree: int = 64, v0: Tensor | None = None,
                generator: torch.Generator | None = None,
                config: SolveConfig | None = None) -> Tensor:
    """(K_hck + ridge I)^(1/2) @ eps (n,) or (n, s) by the Chebyshev
    expansion; ``v0`` / ``generator`` as for :func:`sample_prior`."""
    lo, hi = estimate_spectral_range(f, ridge, v0=v0, generator=generator,
                                     config=config)
    dt = f.adiag.dtype
    coeffs = torch.as_tensor(chebyshev_coeffs(np.sqrt, lo, hi, degree),
                             dtype=dt, device=f.adiag.device)
    return _cheb_apply(f, ridge, torch.as_tensor(eps).to(f.adiag), coeffs,
                       lo, hi, degree, config)
