"""Wrapper of the ``policy_dist`` CUDA kernel (B12, ``csrc/policy_dist.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.policy_stage.ref.policy_dist_ref`); on CUDA
tensors it launches the kernel or raises.  ``policy_dist.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.policy_stage.ref import policy_dist_ref

#: rows of a node block (and centers) per block tile of csrc/policy_dist.cu
BM = BN = 64
#: the most row tiles and nodes one launch takes (grid y and z extents)
MAX_GRID_YZ = 65535
METRICS = ("l2", "l1")


def policy_dist(blocks: torch.Tensor, centers: torch.Tensor, *,
                metric: str = "l2") -> torch.Tensor:
    """(B, m, d), (B, r, d) -> (B, m, r) squared-L2 ("l2") or L1 ("l1")
    distances, with no kernel epilogue."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; have {METRICS}")
    if (blocks.ndim != 3 or centers.ndim != 3
            or blocks.shape[0] != centers.shape[0]
            or blocks.shape[2] != centers.shape[2]):
        raise ValueError(f"policy_dist needs blocks (B, m, d) and centers "
                         f"(B, r, d); got {tuple(blocks.shape)} and "
                         f"{tuple(centers.shape)}")
    dev = _build.cuda_device("policy_dist", blocks, centers)
    if dev is None:
        return policy_dist_ref(blocks, centers, metric=metric)
    bsz, m, d = blocks.shape
    r = centers.shape[1]
    if bsz > MAX_GRID_YZ or -(-m // BM) > MAX_GRID_YZ:
        raise ValueError(f"policy_dist: B={bsz} nodes or m={m} rows exceed "
                         f"one launch's grid ({MAX_GRID_YZ} nodes, "
                         f"{MAX_GRID_YZ * BM} rows)")
    out = torch.empty((bsz, m, r), dtype=blocks.dtype, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("policy_dist", f"policy_dist_{_build.SUFFIX[blocks.dtype]}",
                  dev, blocks, centers, out, bsz, m, r, d,
                  int(metric == "l1"))
    policy_dist.launches += 1
    return out


policy_dist.launches = 0
