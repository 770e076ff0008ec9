"""Wrappers of the ``oos_contract`` CUDA kernel (``csrc/oos_contract.cu``).

``oos_contract`` launches it on one segment (the ``oos_local`` or the
``oos_walk`` stage alone), ``oos_local_walk`` on both segments of every
query at once (one launch a bucket).  On CPU tensors each wrapper computes
its plain version (:mod:`repro_torch.kernels.oos_stage.ref`); on CUDA
tensors it launches the kernel or raises.  ``oos_contract.launches``
counts the kernel's launches by either wrapper,
``oos_contract.pair_launches`` those with both segments and
``oos_contract.bf16_launches`` those of its bfloat16-data entry.

:func:`plan` is the launch's shape: how many rows of a block one slot of
shared memory holds, how many warps a block of threads has, and the slot
sizes; :func:`copy_width` and :func:`vec_width` the widths the kernel
copies and reads with.  A caller's ``leaf_block`` asks for fewer rows;
without one the autotune tile database's measured block does
(:func:`measured_block`), and on a cold, disabled or corrupt database the
plan is the largest that fits.

The kernel has a bfloat16-data entry (``oos_contract_bf16``, in the
library ``oos_contract_bf16``; a mixed-precision policy's prediction):
bfloat16 points, landmarks and queries beside float32 weights,
coefficients and output.  Its slots hold the data in bfloat16
(``data_itemsize`` 2 in :func:`plan`), and a block whose base or size is
not a multiple of 4 bytes is copied 2 bytes a piece.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.oos_stage.ref import (oos_contract_ref,
                                               oos_local_walk_ref)

#: dynamic shared memory a block can have (the kernel opts in above 48 KB)
SMEM_BUDGET = _build.SMEM_MAX
#: warps a block of threads has at most (each walks its own run of queries)
MAX_WARPS = 4


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def slot_elems(rows: int, d: int, k: int, itemsize: int,
               data_itemsize: int | None = None) -> tuple[int, int, int]:
    """Elements of one point slot (rows x d), one weight slot (rows x k)
    and one query slot (d), each rounded up to 16 bytes; the point and
    query slots hold ``data_itemsize``-byte elements (default
    ``itemsize``, the weights')."""
    ds = itemsize if data_itemsize is None else data_itemsize
    return tuple(_pad16(n * s) // s
                 for n, s in ((rows * d, ds), (rows * k, itemsize), (d, ds)))


def warp_smem(rows: int, d: int, k: int, itemsize: int,
              data_itemsize: int | None = None) -> int:
    """Shared memory one warp uses: two slots each of points, weights and
    query rows."""
    ds = itemsize if data_itemsize is None else data_itemsize
    pslot, wslot, xslot = slot_elems(rows, d, k, itemsize, ds)
    return 2 * ((pslot + xslot) * ds + wslot * itemsize)


@functools.lru_cache(maxsize=256)
def stage_rows(m: int, d: int, itemsize: int,
               leaf_block: int | None = None, *, k: int = 1,
               data_itemsize: int | None = None) -> int:
    """Rows of a block one slot holds: all m where one warp's slots fit
    :data:`SMEM_BUDGET`, else the most that fit (the kernel then takes a
    block in chunks of that many rows); ``leaf_block`` asks for fewer.
    Raises ``ValueError`` when not even one row fits."""
    lo, hi = 0, m
    while lo < hi:                       # the most rows that fit
        mid = (lo + hi + 1) // 2
        if warp_smem(mid, d, k, itemsize, data_itemsize) <= SMEM_BUDGET:
            lo = mid
        else:
            hi = mid - 1
    rows = lo if leaf_block is None else min(lo, leaf_block)
    if rows < 1:
        raise ValueError(f"oos_contract: m={m}, d={d}, k={k} leave no room "
                         f"for a point row in {SMEM_BUDGET} bytes of shared "
                         "memory")
    return rows


@functools.lru_cache(maxsize=256)
def plan(ms: tuple[int, ...], d: int, k: int, itemsize: int,
         leaf_block: int | None = None,
         data_itemsize: int | None = None) -> dict:
    """The launch's shape for segments of middle sizes ``ms``: rows a slot
    holds, warps a block (as many as fit :data:`SMEM_BUDGET`, at most
    :data:`MAX_WARPS`), the slots' elements and the block's shared
    memory.  ``itemsize`` is the weights', ``data_itemsize`` the points'
    and queries' (default ``itemsize``)."""
    rows = stage_rows(max(ms), d, itemsize, leaf_block, k=k,
                      data_itemsize=data_itemsize)
    per_warp = warp_smem(rows, d, k, itemsize, data_itemsize)
    warps = max(1, min(MAX_WARPS, SMEM_BUDGET // per_warp))
    pslot, wslot, xslot = slot_elems(rows, d, k, itemsize, data_itemsize)
    return {"rows": rows, "warps": warps, "pslot": pslot, "wslot": wslot,
            "xslot": xslot, "smem": warps * per_warp}


def copy_width(ptr: int, *sizes: int) -> int:
    """Bytes a piece of a block copy moves: the widest of 16, 8, 4 (a
    cp.async copy) or 2 (a plain load and store: bfloat16 data only) that
    divides the base address ``ptr`` and every byte size (each block's,
    each chunk's)."""
    common = math.gcd(ptr, *sizes)
    for width in (16, 8, 4, 2):
        if common % width == 0:
            return width
    raise ValueError(f"oos_contract: no copy width for address {ptr} and "
                     f"sizes {sizes}")


def vec_width(d: int, itemsize: int) -> int:
    """Features the kernel reads at once: the widest of 4, 2, 1 elements
    within 16 bytes that divides d."""
    for vw in (4, 2, 1):
        if vw * itemsize <= 16 and d % vw == 0:
            return vw
    return 1


def _check(name: str, segments, queries) -> None:
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")
    q, d = queries.shape if queries.ndim == 2 else (-1, -1)
    k = segments[0][1].shape[-1] if segments[0][1].ndim == 3 else -1
    for points, weights, pidx, widx in segments:
        if (points.ndim != 3 or weights.ndim != 3 or queries.ndim != 2
                or points.shape[1] != weights.shape[1]
                or points.shape[2] != d or weights.shape[2] != k
                or pidx.shape != (q,) or widx.shape != (q,)):
            raise ValueError(
                "oos_contract needs points (Bp, m, d), weights (Bw, m, k), "
                "queries (q, d) and two (q,) indices per segment, one d and "
                f"k for all; got {tuple(points.shape)}, "
                f"{tuple(weights.shape)}, {tuple(queries.shape)}, "
                f"{tuple(pidx.shape)}, {tuple(widx.shape)}")


def _segment_args(points, weights, pidx, widx, rows: int) -> list:
    bp, m, d = points.shape
    bw, k = weights.shape[0], weights.shape[2]
    s, ws = points.element_size(), weights.element_size()
    return [points, weights, pidx, widx, ctypes.c_longlong(bp),
            ctypes.c_longlong(bw), m,
            copy_width(points.data_ptr(), m * d * s, min(rows, m) * d * s),
            copy_width(weights.data_ptr(), m * k * ws,
                       min(rows, m) * k * ws)]


def _device(segments, queries) -> torch.device | None:
    """The CUDA device of a launch over ``segments`` ((points, weights, pidx,
    widx) each), or None when every tensor lies on the CPU (the plain
    version runs); raises on mixed devices, non-int64 indices or
    non-contiguous tensors, and unless the weights share a dtype and the
    points and queries share it too, or are bfloat16 beside float32
    weights."""
    tensors = [t for seg in segments for t in seg] + [queries]
    dev = _build.cuda_device(
        "oos_contract", *(seg[1] for seg in segments),
        data=tuple(seg[0] for seg in segments) + (queries,))
    if dev is None and all(t.device.type == "cpu" for t in tensors):
        return None
    if any(t.device != dev for t in tensors):
        raise ValueError("oos_contract needs all tensors on one CUDA device; "
                         f"got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.int64 for seg in segments for t in seg[2:]):
        raise TypeError("oos_contract kernel takes int64 indices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("oos_contract kernel needs contiguous tensors")
    return dev


def measured_block(ms: tuple[int, ...], d: int, k: int,
                   itemsize: int) -> int | None:
    """The autotune tile database's rows of a block for segments of middle
    sizes ``ms`` (keyed as the reference keys ``oos_local``: the
    contraction size, the largest m, with r 0; else ``oos_walk``'s
    record), or None; never raises (``registry.autotuned_block``)."""
    from repro_torch.kernels.registry import autotuned_block

    return autotuned_block(("oos_local", "oos_walk"), n0=max(ms), r=0, k=k,
                           d=d, itemsize=itemsize)


def _launch(dev, segments, queries, name: str, sigma: float,
            leaf_block: int | None) -> tuple[torch.Tensor, bool]:
    """One launch over ``segments`` on ``dev``; (the output, whether the
    kernel was launched: not for an empty output).  Without
    ``leaf_block`` the database's measured block steers the plan where it
    holds one (:func:`measured_block`); :func:`plan` takes no more rows than
    fit, whichever asks."""
    q, d = queries.shape
    weights = segments[0][1]
    k = weights.shape[2]
    s = queries.element_size()
    ms = tuple(seg[0].shape[1] for seg in segments)
    if leaf_block is None:
        leaf_block = measured_block(ms, d, k, weights.element_size())
    p = plan(ms, d, k, weights.element_size(), leaf_block,
             None if s == weights.element_size() else s)
    out = torch.empty((q, k), dtype=weights.dtype, device=dev)
    if q == 0 or k == 0:
        return out, False
    args = _segment_args(*segments[0], p["rows"])
    args += (_segment_args(*segments[1], p["rows"]) if len(segments) == 2
             else [None, None, None, None, ctypes.c_longlong(0),
                   ctypes.c_longlong(0), 0, 0, 0])
    _build.launch(_build.library("oos_contract", queries),
                  f"oos_contract_{_build.SUFFIX[queries.dtype]}", dev, *args,
                  len(segments), queries, out, q, d, k, p["rows"], p["warps"],
                  copy_width(queries.data_ptr(), d * s), vec_width(d, s),
                  p["pslot"], p["wslot"], p["xslot"],
                  _build.EPILOGUE_KIND[name], float(sigma))
    oos_contract.launches += 1
    oos_contract.bf16_launches += int(queries.dtype == torch.bfloat16)
    return out, True


def oos_contract(
    points: torch.Tensor, weights: torch.Tensor, queries: torch.Tensor,
    point_index: torch.Tensor, weight_index: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0, leaf_block: int | None = None,
) -> torch.Tensor:
    """z_i = W[widx_i]^T k(P[pidx_i], x_i).

    (Bp, m, d), (Bw, m, k), (q, d), (q,) int64, (q,) int64 -> (q, k).
    """
    seg = (points, weights, point_index, weight_index)
    _check(name, [seg], queries)
    dev = _device([seg], queries)
    if dev is None:
        return oos_contract_ref(points, weights, queries, point_index,
                                weight_index, name=name, sigma=sigma)
    return _launch(dev, [seg], queries, name, sigma, leaf_block)[0]


def oos_local_walk(
    xl: torch.Tensor, wl: torch.Tensor, lm: torch.Tensor, ct: torch.Tensor,
    queries: torch.Tensor, leaf_index: torch.Tensor,
    parent_index: torch.Tensor, *, name: str = "gaussian",
    sigma: float = 1.0, leaf_block: int | None = None,
) -> torch.Tensor:
    """Both Algorithm-3 terms of every query in one launch:
    z_i = wl[j]^T k(xl[j], x_i) + ct[j]^T k(lm[p], x_i), j = leaf_index[i],
    p = parent_index[i].

    xl (Bl, n0, d), wl (Bl, n0, k), lm (Bp, r, d), ct (Bl, r, k), queries
    (q, d), two (q,) int64 indices -> (q, k).
    """
    segs = [(xl, wl, leaf_index, leaf_index),
            (lm, ct, parent_index, leaf_index)]
    _check(name, segs, queries)
    dev = _device(segs, queries)
    if dev is None:
        return oos_local_walk_ref(xl, wl, lm, ct, queries, leaf_index,
                                  parent_index, name=name, sigma=sigma)
    out, launched = _launch(dev, segs, queries, name, sigma, leaf_block)
    oos_contract.pair_launches += launched
    return out


oos_contract.launches = 0
oos_contract.pair_launches = 0
oos_contract.bf16_launches = 0
