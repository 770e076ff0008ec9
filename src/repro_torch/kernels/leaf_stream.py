"""Host side of ``csrc/leaf_stream.cuh``: how the streamed leaf kernels,
``leaf_matvec`` (B5) and ``leaf_update`` (B13), lay out a block's shared
memory.  Each block of :data:`THREADS` threads streams its leaves in panels
of 32 or 16 rows through a ring of two slots, with two buffers of the
staged right-hand side (the next leaf's loads while the current one is in
use); :func:`stream_plan` picks the panel's rows and the blocks an SM.
"""
from __future__ import annotations

from repro_torch.kernels import _build

#: threads of a block of the streamed leaf kernels
THREADS = 256
#: rows a panel may hold, in order of preference (8 warps of 4 rows or 2)
PANEL_ROWS = (32, 16)
#: shared memory of one SM of the H100 (228 KB); each block holds 1 KB of
#: it for itself
SMEM_SM = 228 * 1024


def pad16(nbytes: int) -> int:
    """``nbytes`` rounded up to whole 16-byte pieces."""
    return -(-nbytes // 16) * 16


def panel_bytes(rows: int, cols: int, itemsize: int) -> int:
    """One ring slot: ``rows`` rows of ``cols`` elements and the 16 /
    itemsize - 1 a span's alignment shifts it by, in whole 16-byte pieces
    (``panel_elems``)."""
    return pad16((rows * cols + 16 // itemsize - 1) * itemsize)


def rhs_stride(k: int, kt: int) -> int:
    """Row stride (elements) of a staged right-hand side: 1 for the KT = 1
    kernel, else k rounded up to the tile of 8 and padded to 4 x an odd
    number (16-byte reads of neighbouring rows on distinct banks)."""
    return 1 if kt == 1 else 4 * ((-(-k // 8) * 2) | 1)


def copy_width(ptr: int, itemsize: int) -> int:
    """Elements a cp.async copy of a streamed matrix moves: 16 bytes where
    its base is 16-byte aligned, else one element."""
    return 16 // itemsize if ptr % 16 == 0 else 1


def stream_plan(itemsize: int, slot, fixed: int) -> dict:
    """The first of two blocks an SM (float32 only: the float64 kernels'
    launch bounds allow one), then one, then of :data:`PANEL_ROWS` whose
    shared memory -- two slots of ``slot(rows)`` bytes and ``fixed`` bytes
    of the rest -- fits.  Where nothing fits the last plan is returned and
    the wrapper's check_smem raises."""
    plan = {}
    for per_sm in (2, 1) if itemsize == 4 else (1,):
        budget = min(_build.SMEM_MAX, SMEM_SM // per_sm - 1024)
        for rows in PANEL_ROWS:
            plan = {"rows": rows, "per_sm": per_sm,
                    "smem": 2 * slot(rows) + fixed}
            if plan["smem"] <= budget:
                return plan
    return plan
