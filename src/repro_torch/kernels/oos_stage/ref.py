"""Plain PyTorch version of the fused Algorithm-3 contraction.

Both ``oos_local`` and ``oos_walk`` are the same contraction at different
middle sizes m: query i reads point block ``P[pidx_i]`` (m, d) and weight
block ``W[widx_i]`` (m, k) and computes

    z_i = W[widx_i]^T k(P[pidx_i], x_i)

The plain version gathers the blocks and evaluates the distances as
:mod:`repro_torch.core.kernels_fn` does (the clamped norm identity for the
L2 kernels), so on gathered blocks (``pidx = widx = arange(q)``) it agrees
with the reference's ``oos_contract_ref`` to round-off.  bfloat16 inputs
(the data of a mixed-precision policy) are promoted to float32 first, as
the reference promotes them.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC, kernel_epilogue
from repro_torch.kernels.build_stage.ref import promote


def oos_contract_ref(
    points: torch.Tensor, weights: torch.Tensor, queries: torch.Tensor,
    point_index: torch.Tensor, weight_index: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """(Bp, m, d), (Bw, m, k), (q, d), (q,), (q,) -> z (q, k)."""
    oos_contract_ref.calls += 1
    points, weights, queries = map(promote, (points, weights, queries))
    pts = points[point_index]                                  # (q, m, d)
    if KERNEL_METRIC[name] == "l2":
        pn = torch.sum(pts * pts, dim=-1)                      # (q, m)
        xn = torch.sum(queries * queries, dim=-1, keepdim=True)
        px = torch.einsum("qmd,qd->qm", pts, queries)
        dist = torch.clamp(pn + xn - 2.0 * px, min=0.0)
    else:
        dist = torch.sum(torch.abs(pts - queries[:, None, :]), dim=-1)
    kv = kernel_epilogue(name, sigma)(dist)
    return torch.einsum("qm,qmk->qk", kv, weights[weight_index])


def oos_local_walk_ref(
    xl: torch.Tensor, wl: torch.Tensor, lm: torch.Tensor, ct: torch.Tensor,
    queries: torch.Tensor, leaf_index: torch.Tensor,
    parent_index: torch.Tensor, *, name: str = "gaussian",
    sigma: float = 1.0,
) -> torch.Tensor:
    """Both Algorithm-3 terms summed, the plain form of the one-launch
    kernel: the ``oos_local`` contraction at the query's leaf plus the
    ``oos_walk`` contraction at its parent's landmarks (weights at the
    leaf).  (Bl, n0, d), (Bl, n0, k), (Bp, r, d), (Bl, r, k), (q, d), (q,),
    (q,) -> (q, k)."""
    z = oos_contract_ref(xl, wl, queries, leaf_index, leaf_index, name=name,
                         sigma=sigma)
    return z + oos_contract_ref(lm, ct, queries, parent_index, leaf_index,
                                name=name, sigma=sigma)


oos_contract_ref.calls = 0
