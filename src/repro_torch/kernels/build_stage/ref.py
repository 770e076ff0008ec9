"""Plain PyTorch versions of the two build stages of Algorithm 2.

Both are per-node maps batched over every node of one tree level
(counterparts of ``repro.kernels.build_stage.ref``):

  * ``build_gram``:  P_b (m, d) -> G_b = K(P_b, P_b) + jitter*m I  (m, m)
                     and, with ``want_chol``, its lower Cholesky factor;
  * ``build_cross``: P_b (m, d), Z_b (r, d), Linv_b (r, r) ->
                     U_b = K(P_b, Z_b) Linv_b^T Linv_b              (m, r)
                     with ``Linv_b`` the inverse Cholesky factor of the
                     parent's middle factor (``Sigma^-1 = Linv^T Linv``).

The base kernel is evaluated through :mod:`repro_torch.core.kernels_fn`,
so in float64 both agree with the reference's ``xla`` path to round-off.
A block that is not positive definite gets a factor whose lower triangle
is NaN, the reference's failure mode, instead of an exception.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import get_kernel


def nan_failed_factors(chol: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """NaN the lower triangle of the (B, m, m) factors whose
    ``torch.linalg.cholesky_ex`` info is nonzero (the block was not
    positive definite), as the reference's Cholesky does."""
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(chol, float("nan")).tril(), chol)


def build_gram_ref(
    points: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, d) -> gram (B, m, m) [+ lower Cholesky (B, m, m) or None]."""
    build_gram_ref.calls += 1
    m = points.shape[1]
    gram = get_kernel(name)(points, points, sigma=sigma)
    gram = gram + (jitter * m) * torch.eye(m, dtype=gram.dtype,
                                           device=gram.device)
    if not want_chol:
        return gram, None
    chol, info = torch.linalg.cholesky_ex(gram)
    return gram, nan_failed_factors(chol, info)


def build_cross_ref(
    points: torch.Tensor, landmarks: torch.Tensor, linv: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """(B, m, d), (B, r, d), (B, r, r) -> U (B, m, r) = K(P, Z) Linv^T Linv."""
    build_cross_ref.calls += 1
    kxu = get_kernel(name)(points, landmarks, sigma=sigma)       # (B, m, r)
    return (kxu @ linv.mT) @ linv


build_gram_ref.calls = 0
build_cross_ref.calls = 0
