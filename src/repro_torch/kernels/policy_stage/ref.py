"""Plain PyTorch version of the landmark-policy distance stage
(counterpart of ``repro.kernels.policy_stage.ref``).

``policy_dist``: (B, m, d) node blocks x (B, r, d) per-node centers ->
(B, m, r) bandwidth-independent distances, "l2" the SQUARED Euclidean one
and "l1" the Manhattan one: the metric contract of the sweep engine's
cached tiles (:func:`repro_torch.kernels.build_stage.ref.
pairwise_dist_ref`), so a policy's selection does not depend on sigma.
On the CPU "l2" goes through the norm identity, as the reference's does,
so float64 argmins agree with it; on the card it is the direct feature
sum, as the kernel computes it.  "l1" is always the direct sum.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build_stage.ref import pairwise_dist_ref


def policy_dist_ref(blocks: torch.Tensor, centers: torch.Tensor, *,
                    metric: str = "l2") -> torch.Tensor:
    """Batched policy distances: (B, m, d), (B, r, d) -> (B, m, r)."""
    policy_dist_ref.calls += 1
    return pairwise_dist_ref(blocks, centers, metric)


policy_dist_ref.calls = 0
