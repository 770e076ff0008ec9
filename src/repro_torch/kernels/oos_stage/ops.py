"""Wrapper of the ``oos_contract`` CUDA kernel (``csrc/oos_contract.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.oos_stage.ref.oos_contract_ref`); on CUDA
tensors it launches the kernel or raises.  ``oos_contract.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.oos_stage.ref import oos_contract_ref

#: dynamic shared memory per block, kept under the 48 KB a launch gets
#: without an opt-in attribute
SMEM_BUDGET = 48 * 1024


def stage_rows(m: int, d: int, itemsize: int,
               leaf_block: int | None = None) -> int:
    """Rows of a point block the kernel stages in shared memory per step.

    The query (d), the staged rows (rows x odd stride) and the m kernel
    values share :data:`SMEM_BUDGET`; ``leaf_block`` asks for fewer rows.
    Raises ``ValueError`` when not even one row fits.
    """
    stride = d | 1
    fit = (SMEM_BUDGET // itemsize - d - m) // stride
    rows = min(m, fit if leaf_block is None else min(fit, leaf_block))
    if rows < 1:
        raise ValueError(f"oos_contract: m={m}, d={d} leave no room for a "
                         f"point row in {SMEM_BUDGET} bytes of shared memory")
    return rows


def oos_contract(
    points: torch.Tensor, weights: torch.Tensor, queries: torch.Tensor,
    point_index: torch.Tensor, weight_index: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0, leaf_block: int | None = None,
) -> torch.Tensor:
    """z_i = W[widx_i]^T k(P[pidx_i], x_i).

    (Bp, m, d), (Bw, m, k), (q, d), (q,) int64, (q,) int64 -> (q, k).
    """
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")
    if (points.ndim != 3 or weights.ndim != 3 or queries.ndim != 2
            or points.shape[1] != weights.shape[1]
            or points.shape[2] != queries.shape[1]
            or point_index.shape != (queries.shape[0],)
            or weight_index.shape != (queries.shape[0],)):
        raise ValueError(
            "oos_contract needs points (Bp, m, d), weights (Bw, m, k), "
            "queries (q, d) and two (q,) indices; got "
            f"{tuple(points.shape)}, {tuple(weights.shape)}, "
            f"{tuple(queries.shape)}, {tuple(point_index.shape)}, "
            f"{tuple(weight_index.shape)}")
    tensors = (points, weights, queries, point_index, weight_index)
    if all(t.device.type == "cpu" for t in tensors):
        return oos_contract_ref(points, weights, queries, point_index,
                                weight_index, name=name, sigma=sigma)
    dev = _build.cuda_device("oos_contract", points, weights, queries)
    if any(t.device != dev for t in (point_index, weight_index)):
        raise ValueError("oos_contract needs all tensors on one CUDA device; "
                         f"got {[str(t.device) for t in tensors]}")
    if point_index.dtype != torch.int64 or weight_index.dtype != torch.int64:
        raise TypeError("oos_contract kernel takes int64 indices")
    if not (point_index.is_contiguous() and weight_index.is_contiguous()):
        raise ValueError("oos_contract kernel needs contiguous tensors")
    bp, m, d = points.shape
    bw, k = weights.shape[0], weights.shape[2]
    q = queries.shape[0]
    rows = stage_rows(m, d, points.element_size(), leaf_block)
    out = torch.empty((q, k), dtype=points.dtype, device=dev)
    if q == 0 or k == 0:
        return out
    _build.launch("oos_contract",
                  f"oos_contract_{_build.SUFFIX[points.dtype]}", dev, points,
                  weights, queries, point_index, weight_index, out,
                  ctypes.c_longlong(bp), ctypes.c_longlong(bw), q, m, d, k,
                  rows, _build.EPILOGUE_KIND[name], float(sigma))
    oos_contract.launches += 1
    return out


oos_contract.launches = 0
