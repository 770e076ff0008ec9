"""Plain PyTorch versions of the HCK leaf stages
(counterparts of ``repro.kernels.hck_leaf.ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.build_stage.ref import nan_failed_factors


def hck_leaf_matvec_ref(adiag: torch.Tensor, u: torch.Tensor,
                        b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,n0,n0),(P,n0,r),(P,n0,k) -> y = A b (P,n0,k), c = U^T b (P,r,k)."""
    hck_leaf_matvec_ref.calls += 1
    return adiag @ b, u.mT @ b


def hck_leaf_solve_ref(
    linv: torch.Tensor, u: torch.Tensor, sig: torch.Tensor, b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused leaf inverse apply: x = Linv^T Linv b + U Sig U^T b, c = U^T b.

    (P,n0,n0),(P,n0,r),(S,r,r),(P,n0,k) -> x (P,n0,k), c (P,r,k).  ``sig``
    holds one block per leaf (S = P) or one per sibling pair (S = P/2,
    leaf p reads block p // 2).
    """
    hck_leaf_solve_ref.calls += 1
    if sig.shape[0] != linv.shape[0]:
        sig = torch.repeat_interleave(sig, 2, dim=0)
    c = u.mT @ b
    x = linv.mT @ (linv @ b) + u @ (sig @ c)
    return x, c


def hck_leaf_project_ref(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Upward projection c = U^T b: (P,n0,r),(P,n0,k) -> (P,r,k)."""
    hck_leaf_project_ref.calls += 1
    return torch.einsum("pnr,pnk->prk", u, b)


def hck_leaf_factor_ref(dleaf: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Leaf Schur-complement factorization of Algorithm 2.

    (P, n0, n0) SPD -> (lo, linv), both lower triangular, ``linv =
    lo^-1`` (so ``D^-1 = linv^T linv``).  A block that is not positive
    definite gets NaN factors.
    """
    hck_leaf_factor_ref.calls += 1
    lo, info = torch.linalg.cholesky_ex(dleaf)
    lo = nan_failed_factors(lo, info)
    eye = torch.eye(dleaf.shape[-1], dtype=dleaf.dtype, device=dleaf.device)
    return lo, torch.linalg.solve_triangular(lo, eye.expand_as(lo),
                                             upper=False)


hck_leaf_matvec_ref.calls = 0
hck_leaf_solve_ref.calls = 0
hck_leaf_project_ref.calls = 0
hck_leaf_factor_ref.calls = 0
