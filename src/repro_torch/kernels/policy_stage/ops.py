"""Wrapper of the ``policy_dist`` CUDA kernels (B12, ``csrc/policy_dist.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.policy_stage.ref.policy_dist_ref`); on CUDA
tensors it launches the kernel that :func:`route` names or raises.
``policy_dist.launches`` counts kernel launches,
``policy_dist.tiled_launches`` those of the register-tiled kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.policy_stage.ref import policy_dist_ref

#: B12's kernels in ``csrc/policy_dist.cu``: "tiled" (persistent blocks,
#: 128-row tiles against 128 resident centers, float32 with d <=
#: TILED_MAX_D) and "pair_tile" (64 x 64 tiles, features staged 32
#: at a time, float64 and any d)
SYMBOLS = {"tiled": "policy_dist_tiled", "pair_tile": "policy_dist"}
#: the most features the tiled kernel holds in shared memory at once
TILED_MAX_D = 64
#: rows of a node block (and centers) per block tile of the pair_tile kernel
BM = BN = 64
#: the most row tiles and nodes one pair_tile launch takes (grid y and z)
MAX_GRID_YZ = 65535
METRICS = ("l2", "l1")


def route(dtype: torch.dtype, d: int) -> str:
    """The B12 kernel for points of d features: "tiled" in float32 up to
    :data:`TILED_MAX_D` (its persistent grid takes any number of nodes and
    rows), "pair_tile" for wider points and in float64 (an 8 x 8 tile of
    doubles a thread does not fit in its registers)."""
    return ("tiled" if dtype == torch.float32 and d <= TILED_MAX_D
            else "pair_tile")


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
    kind = route(blocks.dtype, d)
    if kind == "pair_tile" and (bsz > MAX_GRID_YZ
                                or -(-m // BM) > MAX_GRID_YZ):
        raise ValueError(f"policy_dist: B={bsz} nodes or m={m} rows exceed "
                         f"one launch's grid ({MAX_GRID_YZ} nodes, "
                         f"{MAX_GRID_YZ * BM} rows)")
    out = torch.empty((bsz, m, centers.shape[1]), dtype=blocks.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    launch_kernel(kind, blocks, centers, out, metric=metric)
    return out


def launch_kernel(kind: str, blocks: torch.Tensor, centers: torch.Tensor,
                  out: torch.Tensor, *, metric: str = "l2") -> None:
    """Launch kernel ``kind`` of :data:`SYMBOLS` on CUDA tensors that
    :func:`policy_dist` has checked, writing ``out``; counts the launch.
    The wrapper's path; called directly only to time one kernel against
    the other on the same inputs."""
    bsz, m, d = blocks.shape
    _build.launch("policy_dist",
                  f"{SYMBOLS[kind]}_{_build.SUFFIX[blocks.dtype]}",
                  out.device, blocks, centers, out, bsz, m,
                  centers.shape[1], d, int(metric == "l1"))
    policy_dist.launches += 1
    if kind == "tiled":
        policy_dist.tiled_launches += 1


policy_dist.launches = 0
policy_dist.tiled_launches = 0
