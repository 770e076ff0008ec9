"""Wrapper of the ``leaf_update`` CUDA kernel (B13, ``csrc/leaf_update.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.update_stage.ref.leaf_update_ref`); on CUDA
tensors it launches the kernel or raises.  ``leaf_update.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, leaf_stream
from repro_torch.kernels.update_stage.ref import leaf_update_ref


def update_plan(n0: int, k: int, itemsize: int, lptr: int = 0,
                iptr: int = 0) -> dict:
    """How the leaf_update kernel takes a shape (csrc/leaf_update.cu, by
    :func:`repro_torch.kernels.leaf_stream.stream_plan`): the rows of its
    panels of L and Linv, the blocks an SM it is sized for, its shared
    memory (two ring slots, two B^T buffers, L21^T, the sums of T = L21
    Linv, S / L22 and X at row stride k | 1, the reciprocal pivots and the
    factor's column buffer of 32), the staged B^T's row stride (k rounded
    up to 8, as 4 x an odd number) and the copy widths of lo and linv."""
    s = itemsize
    ldk = leaf_stream.rhs_stride(k, 8)
    fixed = (3 * leaf_stream.pad16(n0 * ldk * s) + leaf_stream.pad16(k * n0 * s)
             + 2 * leaf_stream.pad16(k * (k | 1) * s)
             + leaf_stream.pad16(k * s) + 32 * s)
    plan = leaf_stream.stream_plan(
        s, lambda rows: 2 * leaf_stream.panel_bytes(rows, n0, s), fixed)
    plan.update(ldk=ldk, vl=leaf_stream.copy_width(lptr, s),
                vi=leaf_stream.copy_width(iptr, s))
    return plan


def leaf_update(lo: torch.Tensor, linv: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, n0, n0) ``lo`` / ``linv``, (P, k, n0) ``b``, (P, k, k) ``c`` ->
    the extended pair (P, n0 + k, n0 + k), leading quadrants copied."""
    if any(t.ndim != 3 for t in (lo, linv, b, c)):
        raise ValueError("leaf_update needs 3-D lo, linv, b and c")
    p, n0, _ = lo.shape
    k = b.shape[1]
    if (lo.shape != (p, n0, n0) or linv.shape != (p, n0, n0)
            or b.shape != (p, k, n0) or c.shape != (p, k, k)):
        raise ValueError(
            "leaf_update needs lo and linv (P, n0, n0), b (P, k, n0) and c "
            f"(P, k, k); got {tuple(lo.shape)}, {tuple(linv.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}")
    dev = _build.cuda_device("leaf_update", lo, linv, b, c)
    if dev is None:
        return leaf_update_ref(lo, linv, b, c)
    plan = update_plan(n0, k, lo.element_size(), lo.data_ptr(),
                       linv.data_ptr())
    _build.check_smem("leaf_update", plan["smem"], f"n0={n0}, k={k}")
    ne = n0 + k
    lo_ext = torch.empty((p, ne, ne), dtype=lo.dtype, device=dev)
    linv_ext = torch.empty_like(lo_ext)
    if p == 0 or ne == 0:
        return lo_ext, linv_ext
    _build.launch("leaf_update", f"leaf_update_{_build.SUFFIX[lo.dtype]}",
                  dev, lo, linv, b, c, lo_ext, linv_ext, p, n0, k,
                  plan["rows"], plan["ldk"], plan["vl"], plan["vi"],
                  plan["per_sm"], plan["smem"])
    leaf_update.launches += 1
    return lo_ext, linv_ext


leaf_update.launches = 0
