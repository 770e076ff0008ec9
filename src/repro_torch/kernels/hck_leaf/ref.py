"""Plain PyTorch version of the leaf projection stage."""
from __future__ import annotations

import torch


def hck_leaf_project_ref(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Upward projection c = U^T b: (P,n0,r),(P,n0,k) -> (P,r,k)."""
    hck_leaf_project_ref.calls += 1
    return torch.einsum("pnr,pnk->prk", u, b)


hck_leaf_project_ref.calls = 0
