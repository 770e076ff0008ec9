"""Wrappers of the leaf-stage CUDA kernels.

``leaf_project`` (B6, ``csrc/hck_leaf_project.cu``), ``leaf_factor`` (B3,
``csrc/leaf_factor.cu``, and past its shared memory the panel form
``csrc/leaf_factor_panel.cu``: :func:`factor_route`), ``leaf_matvec`` (B5,
``csrc/leaf_matvec.cu``) and ``leaf_solve`` (B4, ``csrc/leaf_solve.cu``).
On CPU tensors each wrapper computes its plain version
(:mod:`repro_torch.kernels.hck_leaf.ref`); on CUDA tensors it launches the
kernel or raises.  Each wrapper's ``launches`` counts its kernel launches,
``leaf_factor.panel_launches`` those of the panel form (within them) and
``leaf_solve.wide_launches`` those of B4's instance for leaves past 256
rows (within them).  Every wrapper takes leaves up to :data:`PANEL_MAX_M`
= 512 rows at ranks up to 256, the leaves a ``model.update`` at leaf 256
grows.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build, leaf_stream
from repro_torch.kernels.hck_leaf.ref import (hck_leaf_factor_ref,
                                              hck_leaf_matvec_ref,
                                              hck_leaf_project_ref,
                                              hck_leaf_solve_ref)


def load_width(r: int, itemsize: int, ptr: int) -> int:
    """Columns of U that one thread of the ``leaf_project`` kernel reads per
    load: 16 bytes (4 floats, 2 doubles) where r is a multiple of that and
    u's base address ``ptr`` is 16-byte aligned (every row then starts
    aligned), else 1 (the kernel's scalar path)."""
    width = 16 // itemsize
    return width if r % width == 0 and ptr % 16 == 0 else 1


def leaf_project(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c = U^T b per leaf: (P, n0, r), (P, n0, k) -> (P, r, k)."""
    if u.ndim != 3 or b.ndim != 3 or u.shape[:2] != b.shape[:2]:
        raise ValueError(f"leaf_project needs u (P, n0, r) and b (P, n0, k); "
                         f"got {tuple(u.shape)} and {tuple(b.shape)}")
    dev = _build.cuda_device("leaf_project", u, b)
    if dev is None:
        return hck_leaf_project_ref(u, b)
    p, n0, r = u.shape
    k = b.shape[2]
    c = torch.empty((p, r, k), dtype=u.dtype, device=dev)
    if c.numel() == 0:
        return c
    _build.launch("hck_leaf_project",
                  f"hck_leaf_project_{_build.SUFFIX[u.dtype]}", dev, u, b, c,
                  p, n0, r, k, load_width(r, u.element_size(), u.data_ptr()))
    leaf_project.launches += 1
    return c


def factor_smem(n0: int, itemsize: int) -> int:
    """Shared memory of one leaf_factor block (panels of 32 columns): the
    (n0, n0) tile at row stride n0 | 1, the n0 reciprocal pivots and a
    16-byte-aligned column buffer of 32 values; so n0 <= 240 in float32
    and <= 169 in float64."""
    return -(-(n0 * (n0 | 1) + n0) * itemsize // 16) * 16 + 32 * itemsize


#: the largest tile of the panel factor (csrc/chol_panel.cuh kMaxM): a leaf
#: of 2 r at rank 256, as partition.auto_levels sizes it
PANEL_MAX_M = 512


def panel_smem(m: int, itemsize: int) -> int:
    """Shared memory of one block of the panel factor (csrc/chol_panel.cuh)
    of an (m, m) tile held in device memory: the staged panel (m rows of
    32 columns at stride 33), the m reciprocal pivots and the column buffer
    of 32 values; 139,520 bytes at m 512 in float64."""
    return -(-(m * 33 + m) * itemsize // 16) * 16 + 32 * itemsize


def factor_route(stage: str, m: int, itemsize: int, resident_smem,
                 panel=panel_smem) -> str:
    """How a Cholesky stage takes an (m, m) tile (B3 leaf_factor, B1
    gram_chol, B8 gram_chol_dist): "resident" where the resident kernel's
    block (``resident_smem(m, itemsize)`` bytes) fits the shared memory,
    else "panel" up to :data:`PANEL_MAX_M`, its block (``panel(m,
    itemsize)`` bytes) checked against the shared memory; ``ValueError``
    past it."""
    if resident_smem(m, itemsize) <= _build.SMEM_MAX:
        return "resident"
    if m > PANEL_MAX_M:
        raise ValueError(f"{stage}: an ({m}, {m}) tile is above m = "
                         f"{PANEL_MAX_M}, the largest the panel form of the "
                         "kernel takes")
    _build.check_smem(stage, panel(m, itemsize),
                      f"the panel form at an ({m}, {m}) tile")
    return "panel"


#: right-hand-side columns the leaf_solve kernel takes a group
SOLVE_GROUP = 8
#: the largest rank of the leaf_solve kernel, and the leaf rows its
#: resident instance holds (two quads of x a lane); leaves up to
#: :data:`PANEL_MAX_M` take the instance of four (csrc/leaf_solve.cu MQ)
SOLVE_MAX_RANK = 256
SOLVE_RESIDENT_ROWS = 256


def tri_size(n0: int) -> int:
    """Elements of Linv's lower triangle as the leaf_solve kernel stages
    it: quads of 4 rows, row i packed in (i // 4 + 1) chunks of 4
    elements, quad a starting at a chunk congruent to a mod 8."""
    a = -(-n0 // 4)                      # the quads; the end of the last
    return 4 * (2 * a * (a + 1) + 5 * ((a + 1) >> 1) + (a >> 1))


def u_stride(r: int) -> int:
    """Row stride (elements) of U as the leaf_solve kernel stages it: r in
    whole 4-element chunks, an odd number of them."""
    chunks = -(-r // 4)
    return 4 * (chunks | 1)


def solve_smem(n0: int, r: int, k: int, itemsize: int, *,
               stage_l: bool = True, stage_u: bool = True) -> int:
    """Shared memory of one leaf_solve block: the staged triangle and U
    (where staged; U's rows rounded up to whole quads) and three buffers of
    one group of :data:`SOLVE_GROUP` right-hand-side columns (b then Sig c,
    Linv b, U^T b then half of U Sig c).  ``k`` only names the shape: a
    group is always 8 columns wide."""
    del k
    n4, r4 = -(-n0 // 4) * 4, -(-r // 4) * 4
    return itemsize * ((tri_size(n0) if stage_l else 0)
                       + (n4 * u_stride(r) if stage_u else 0)
                       + 3 * max(n4, r4) * SOLVE_GROUP)


def solve_plan(n0: int, r: int, k: int, itemsize: int, lptr: int = 0,
               uptr: int = 0, sptr: int = 0) -> dict:
    """How the leaf_solve kernel takes a shape: whether Linv's triangle and
    U are staged in shared memory (both where they fit, else the triangle
    alone, else U alone, else neither: read in place; leaves past 256 rows
    read both in place), the block's shared memory, the quads of x a lane
    holds (``mq``: 2 up to 256 rows, else 4; the kernel picks the instance
    from n0), and where 16-byte copies and loads of Linv, U and Sig rows
    are legal (row bytes a multiple of 16, base aligned)."""
    choices = ((True, True), (True, False), (False, True), (False, False))
    if n0 > SOLVE_RESIDENT_ROWS:
        # Linv's triangle alone (>= 132 KB in f32) would leave one block of
        # four warps an SM; tools/leaf_solve_staging.py times each staging
        # on the card (PERF.md section 6)
        choices = choices[3:]
    for stage_l, stage_u in choices:
        smem = solve_smem(n0, r, k, itemsize, stage_l=stage_l,
                          stage_u=stage_u)
        if smem <= _build.SMEM_MAX:
            break

    def wide(cols, ptr):
        return (cols * itemsize) % 16 == 0 and ptr % 16 == 0

    return {"stage_l": stage_l, "stage_u": stage_u, "smem": smem,
            "mq": 2 if n0 <= SOLVE_RESIDENT_ROWS else 4,
            "lw": 16 if wide(n0, lptr) else itemsize,
            "uw": 16 if wide(r, uptr) else itemsize,
            "sw": 16 if wide(r, sptr) else itemsize,
            "ldu": u_stride(r), "lsize": tri_size(n0)}


def leaf_factor(dleaf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, n0, n0) SPD -> (L, L^-1), both (P, n0, n0) lower triangular."""
    if dleaf.ndim != 3 or dleaf.shape[1] != dleaf.shape[2]:
        raise ValueError(f"leaf_factor needs dleaf (P, n0, n0); got "
                         f"{tuple(dleaf.shape)}")
    dev = _build.cuda_device("leaf_factor", dleaf)
    if dev is None:
        return hck_leaf_factor_ref(dleaf)
    p, n0, _ = dleaf.shape
    route = factor_route("leaf_factor", n0, dleaf.element_size(),
                         factor_smem)
    lo, linv = torch.empty_like(dleaf), torch.empty_like(dleaf)
    if lo.numel() == 0:
        return lo, linv
    lib = "leaf_factor" if route == "resident" else "leaf_factor_panel"
    _build.launch(lib, f"{lib}_{_build.SUFFIX[dleaf.dtype]}", dev, dleaf, lo,
                  linv, p, n0)
    leaf_factor.launches += 1
    leaf_factor.panel_launches += route == "panel"
    return lo, linv


def matvec_plan(n0: int, r: int, k: int, itemsize: int, aptr: int = 0,
                uptr: int = 0) -> dict:
    """How the leaf_matvec kernel takes a shape (:func:`repro_torch.kernels.
    leaf_stream.stream_plan`): the rows of its panels of A and of U, the
    blocks an SM it is sized for, its shared memory (two ring slots, two b
    buffers, two row groups of the c sums), its register tile (KT = 1 for
    k = 1, a Lanczos step; else 8, in tiles for any k), staged b's row
    stride and the copy widths of A and U."""
    kt = 1 if k == 1 else 8
    ldb = leaf_stream.rhs_stride(k, kt)
    plan = leaf_stream.stream_plan(
        itemsize, lambda rows: (leaf_stream.panel_bytes(rows, n0, itemsize)
                                + leaf_stream.panel_bytes(rows, r, itemsize)),
        2 * leaf_stream.pad16(n0 * ldb * itemsize)
        + leaf_stream.pad16(2 * k * r * itemsize))
    plan.update(kt=kt, ldb=ldb, va=leaf_stream.copy_width(aptr, itemsize),
                vu=leaf_stream.copy_width(uptr, itemsize))
    return plan


def matvec_max_rhs(n0: int, r: int, itemsize: int) -> int:
    """The most right-hand-side columns one leaf_matvec launch takes at
    (n0, r): a multiple of 8 or, where a tile of 8 columns does not fit
    (float64 past n0 299 at r 256), the most below 8 that do, down to 1
    (the KT = 1 instance, whose b buffers hold one column); wider b goes
    in chunks of it, a launch each."""
    if matvec_plan(n0, r, 8, itemsize)["smem"] > _build.SMEM_MAX:
        return next((k for k in range(7, 1, -1) if matvec_plan(
            n0, r, k, itemsize)["smem"] <= _build.SMEM_MAX), 1)
    k = 8
    while matvec_plan(n0, r, k + 8, itemsize)["smem"] <= _build.SMEM_MAX:
        k += 8
    return k


def leaf_matvec(adiag: torch.Tensor, u: torch.Tensor,
                b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """y = A b, c = U^T b per leaf: (P,n0,n0),(P,n0,r),(P,n0,k) ->
    (P,n0,k),(P,r,k).  ``leaf_matvec.shapes`` counts the launches by (n0,
    r, k)."""
    if (adiag.ndim != 3 or u.ndim != 3 or b.ndim != 3
            or adiag.shape != (b.shape[0], b.shape[1], b.shape[1])
            or u.shape[:2] != b.shape[:2]):
        raise ValueError(
            "leaf_matvec needs adiag (P, n0, n0), u (P, n0, r) and b "
            f"(P, n0, k); got {tuple(adiag.shape)}, {tuple(u.shape)}, "
            f"{tuple(b.shape)}")
    dev = _build.cuda_device("leaf_matvec", adiag, u, b)
    if dev is None:
        return hck_leaf_matvec_ref(adiag, u, b)
    p, n0, k = b.shape
    r = u.shape[2]
    plan = matvec_plan(n0, r, k, b.element_size(), adiag.data_ptr(),
                       u.data_ptr())
    if k > 1 and plan["smem"] > _build.SMEM_MAX:
        w = matvec_max_rhs(n0, r, b.element_size())
        parts = [leaf_matvec(adiag, u, b[:, :, q:q + w].contiguous())
                 for q in range(0, k, w)]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([c for _, c in parts], dim=2))
    _build.check_smem("leaf_matvec", plan["smem"],
                      f"an ({n0}, {n0}) leaf with r={r}, k={k}")
    y = torch.empty_like(b)
    c = torch.empty((p, r, k), dtype=b.dtype, device=dev)
    if y.numel() == 0:
        return y, c.zero_()
    _build.launch("leaf_matvec", f"leaf_matvec_{_build.SUFFIX[b.dtype]}", dev,
                  adiag, u, b, y, c, p, n0, r, k, plan["rows"], plan["kt"],
                  plan["ldb"], plan["va"], plan["vu"], plan["per_sm"],
                  plan["smem"])
    leaf_matvec.launches += 1
    leaf_matvec.shapes[(n0, r, k)] += 1
    return y, c


def leaf_solve(linv: torch.Tensor, u: torch.Tensor, sig: torch.Tensor,
               b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = Linv^T Linv b + U Sig U^T b, c = U^T b per leaf.

    (P,n0,n0),(P,n0,r),(S,r,r),(P,n0,k) -> (P,n0,k),(P,r,k); ``sig`` has
    one block per leaf (S = P) or one per sibling pair (S = P/2, read in
    place by both leaves).  n0 up to :data:`PANEL_MAX_M`, r up to
    :data:`SOLVE_MAX_RANK`; leaves past 256 rows take the kernel's wide
    instance (``wide_launches``).  ``linv`` is lower triangular: the kernel never
    reads above its diagonal (the plain version does, and agrees only
    where those entries are zero, as every producer in the port writes
    them).
    """
    if any(t.ndim != 3 for t in (linv, u, sig, b)):
        raise ValueError("leaf_solve needs 3-D linv, u, sig and b")
    p, n0, k = b.shape
    r = u.shape[2]
    if (linv.shape != (p, n0, n0) or u.shape[:2] != (p, n0)
            or sig.shape[1:] != (r, r) or p not in (sig.shape[0],
                                                    2 * sig.shape[0])):
        raise ValueError(
            "leaf_solve needs linv (P, n0, n0), u (P, n0, r), sig (P or "
            "P/2, r, r) and b (P, n0, k); got "
            f"{tuple(linv.shape)}, {tuple(u.shape)}, {tuple(sig.shape)}, "
            f"{tuple(b.shape)}")
    dev = _build.cuda_device("leaf_solve", linv, u, sig, b)
    if dev is None:
        return hck_leaf_solve_ref(linv, u, sig, b)
    if n0 > PANEL_MAX_M or r > SOLVE_MAX_RANK:
        raise ValueError(f"leaf_solve: n0={n0}, r={r} above the kernel's "
                         f"{PANEL_MAX_M} rows and rank {SOLVE_MAX_RANK}")
    plan = solve_plan(n0, r, k, b.element_size(), linv.data_ptr(),
                      u.data_ptr(), sig.data_ptr())
    _build.check_smem("leaf_solve", plan["smem"], f"n0={n0}, r={r}")
    x = torch.empty_like(b)
    c = torch.empty((p, r, k), dtype=b.dtype, device=dev)
    if x.numel() == 0:
        return x, c.zero_()
    shift = 0 if sig.shape[0] == p else 1
    _build.launch("leaf_solve", f"leaf_solve_{_build.SUFFIX[b.dtype]}", dev,
                  linv, u, sig, b, x, c, p, n0, r, k, shift,
                  int(plan["stage_l"]), int(plan["stage_u"]), plan["lw"],
                  plan["uw"], plan["sw"], plan["ldu"], plan["lsize"])
    leaf_solve.launches += 1
    leaf_solve.wide_launches += plan["mq"] == 4
    return x, c


leaf_project.launches = 0
leaf_factor.launches = 0
leaf_factor.panel_launches = 0
leaf_matvec.launches = 0
leaf_matvec.shapes = Counter()
leaf_solve.launches = 0
leaf_solve.wide_launches = 0
