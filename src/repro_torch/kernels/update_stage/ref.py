"""Plain PyTorch version of the bordered leaf-factor extension
(counterpart of ``repro.kernels.update_stage.ref``).

Appending ``k`` rows to a leaf whose ridged Schur complement was factored
as ``A11 = lo lo^T`` extends the factorization without retouching the old
block: with ``B (k, n0)`` the cross block against the existing rows and
``C (k, k)`` the new rows' own block,

  L21   = B lo^-T           = B linv^T
  S     = C - L21 L21^T       (the appended rows' Schur complement)
  L22   = chol(S)
  lo'   = [[lo, 0], [L21, L22]]
  linv' = [[linv, 0], [-L22^-1 L21 linv, L22^-1]]

The leading ``(n0, n0)`` blocks of ``lo'`` / ``linv'`` ARE the inputs, so
removing the same k rows again is an exact truncation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build_stage.ref import nan_failed_factors


def leaf_update_ref(lo: torch.Tensor, linv: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, n0, n0) ``lo`` / ``linv``, (P, k, n0) ``b``, (P, k, k) ``c`` ->
    ``(lo_ext, linv_ext)``, both (P, n0 + k, n0 + k).  An appended Schur
    complement that is not positive definite gives NaNs (no exception)."""
    leaf_update_ref.calls += 1
    p, n0, _ = lo.shape
    k = b.shape[1]
    l21 = b @ linv.mT                                    # B linv^T
    s = c - l21 @ l21.mT
    l22, info = torch.linalg.cholesky_ex(s)
    l22 = nan_failed_factors(l22, info)
    eye = torch.eye(k, dtype=lo.dtype, device=lo.device)
    linv22 = torch.linalg.solve_triangular(l22, eye.expand_as(l22),
                                           upper=False)
    linv21 = -(linv22 @ (l21 @ linv))
    z_tr = lo.new_zeros((p, n0, k))
    lo_ext = torch.cat([torch.cat([lo, z_tr], dim=2),
                        torch.cat([l21, l22], dim=2)], dim=1)
    linv_ext = torch.cat([torch.cat([linv, z_tr], dim=2),
                          torch.cat([linv21, linv22], dim=2)], dim=1)
    return lo_ext, linv_ext


leaf_update_ref.calls = 0
