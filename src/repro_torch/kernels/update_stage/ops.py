"""Wrapper of the ``leaf_update`` CUDA kernel (B13, ``csrc/leaf_update.cu``,
and past its shared memory the panel form ``csrc/leaf_update_panel.cu``:
:func:`update_route`).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.update_stage.ref.leaf_update_ref`); on CUDA
tensors it launches the kernel or raises.  ``leaf_update.launches`` counts
kernel launches, ``leaf_update.panel_launches`` those of the panel form
(within them).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, leaf_stream
from repro_torch.kernels.hck_leaf.ops import PANEL_MAX_M, panel_smem
from repro_torch.kernels.update_stage.ref import leaf_update_ref

#: border rows the panel form keeps in shared memory at a time
#: (csrc/leaf_update_panel.cu KS)
PANEL_SLAB = 8


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


def update_panel_smem(n0: int, k: int, itemsize: int) -> int:
    """Shared memory of one block of the panel form: a slab of
    :data:`PANEL_SLAB` border rows of B and of L21 (n0 values each), or,
    in the same space, the panel factor's (:func:`~repro_torch.kernels.
    hck_leaf.ops.panel_smem`) of the k x k border; 139,520 bytes at k 512
    in float64."""
    slab = 2 * PANEL_SLAB * n0 * itemsize
    return max(slab, panel_smem(k, itemsize) if k else 0)


def update_route(stage: str, n0: int, k: int, itemsize: int) -> str:
    """How B13 takes a leaf of n0 rows bordered by k: "resident" where the
    resident kernel's plan (:func:`update_plan`) fits the shared memory,
    else "panel" while n0 + k stays within :data:`PANEL_MAX_M` (the leaves
    B3's panel form factors), its block (:func:`update_panel_smem`)
    checked against the shared memory; ``ValueError`` past it."""
    if update_plan(n0, k, itemsize)["smem"] <= _build.SMEM_MAX:
        return "resident"
    if n0 + k > PANEL_MAX_M:
        raise ValueError(f"{stage}: a leaf of n0={n0} bordered by k={k} is "
                         f"above n0 + k = {PANEL_MAX_M}, the largest the "
                         "panel form of the kernel takes")
    _build.check_smem(stage, update_panel_smem(n0, k, itemsize),
                      f"the panel form at n0={n0}, k={k}")
    return "panel"


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
    route = update_route("leaf_update", n0, k, lo.element_size())
    ne = n0 + k
    lo_ext = torch.empty((p, ne, ne), dtype=lo.dtype, device=dev)
    linv_ext = torch.empty_like(lo_ext)
    if p == 0 or ne == 0:
        return lo_ext, linv_ext
    sfx = _build.SUFFIX[lo.dtype]
    if route == "panel":
        work = torch.empty((p, 2, k, k), dtype=lo.dtype, device=dev)
        _build.launch("leaf_update_panel", f"leaf_update_panel_{sfx}", dev,
                      lo, linv, b, c, lo_ext, linv_ext, work, p, n0, k)
    else:
        plan = update_plan(n0, k, lo.element_size(), lo.data_ptr(),
                           linv.data_ptr())
        _build.launch("leaf_update", f"leaf_update_{sfx}", dev, lo, linv, b,
                      c, lo_ext, linv_ext, p, n0, k, plan["rows"],
                      plan["ldk"], plan["vl"], plan["vi"], plan["per_sm"],
                      plan["smem"])
    leaf_update.launches += 1
    leaf_update.panel_launches += route == "panel"
    return lo_ext, linv_ext


leaf_update.launches = 0
leaf_update.panel_launches = 0
