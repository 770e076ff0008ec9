"""Wrappers of the build-stage CUDA kernels (``csrc/build_stage.cu`` and
``csrc/build_dist.cu``).

Every launch is grouped: one launch covers a list of tree levels, each a
group of the launch's table (:func:`level_table`).  The build engine's
``build_gram_levels`` launches ``gram_chol_levels`` (B1: every level's
Sigma and its factor, or, in a launch without factors, Gram blocks) and
``build_cross_levels`` launches ``cross_solve_levels`` (B2: U and every
level's W; split TF32 on the tensor cores in float32); the sweep engine's
``build_gram_dist_levels`` launches ``gram_chol_dist_levels`` (B8) and
``build_cross_dist_levels`` launches ``cross_solve_dist_levels`` (B9).
The single-level wrappers ``build_gram``, ``build_cross``,
``build_gram_dist`` (with a factor) and ``build_cross_dist`` are one-group
launches of the same kernels; ``build_gram_dist`` without a factor
launches ``gram_dist`` (the sweep's leaf Adiag).  On CPU tensors each
wrapper computes its plain version
(:mod:`repro_torch.kernels.build_stage.ref`); on CUDA tensors it launches
the kernel or raises.  Each wrapper's ``launches`` counts its own
launches.

Past the resident kernels' shared memory each stage takes its panel form
(``csrc/build_stage_panel.cu``, ``csrc/build_dist_panel.cu``, libraries of
their own), chosen before the launch from dtype and shape: a factored
tile past m 235 (B1) or 240 (B8) in float32, 163 or 169 in float64, up to
:data:`~repro_torch.kernels.hck_leaf.ops.PANEL_MAX_M` = 512, in
device memory (``csrc/chol_panel.cuh``; :func:`gram_route`), and a rank
past :data:`RESIDENT_CROSS_RANK` = 128 up to :data:`MAX_CROSS_RANK` = 256,
Linv streamed through shared memory (``csrc/cross_panel.cuh``;
:func:`cross_route`).  A grouped launch whose levels take both forms of
B1 or B8 is two launches, one a form.  Each wrapper's ``panel_launches``
counts the panel form's launches (within ``launches``).

Each kernel, in both forms, has a bfloat16-data entry (a mixed-precision
policy's build and sweep, ``SolveConfig.precision="bf16"``): bfloat16
points, landmarks or cached distance tiles beside float32 Linv, every
output float32 (:func:`factor_dtype`); a wrapper takes the data group's
dtype from its data and the symbol from it (``..._bf16``, in the
libraries ``build_stage_bf16`` and ``build_dist_bf16``, and for the panel
forms ``build_stage_panel_bf16`` and ``build_dist_panel_bf16``).  Their
routes and limits are float32's.  Each wrapper's ``bf16_launches`` counts
the launches of its bfloat16-data entries (within ``launches``).
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.build_stage.ref import (
    build_cross_dist_levels_ref, build_cross_dist_ref, build_cross_levels_ref,
    build_cross_ref, build_gram_dist_levels_ref, build_gram_dist_ref,
    build_gram_levels_ref, build_gram_ref)
from repro_torch.kernels.hck_leaf.ops import (factor_route, factor_smem,
                                              panel_smem)

#: feature columns the float64 cross_solve_levels tile stages per chunk
DC = 32
#: the float64 cross tiles' row heights (multiples of its 16 thread rows),
#: largest first, and the largest rank of the resident cross kernels (16
#: thread columns of 8 outputs; 16 tiles of 8 columns in float32)
_ROW_TILES = (128, 64, 32, 16)
RESIDENT_CROSS_RANK = 128
#: the largest rank of the panel cross kernels (csrc/cross_panel.cuh
#: kMaxRank), and the rows of their tiles by itemsize (four warps of 16 in
#: float32, 32 rows of 256 threads in float64)
MAX_CROSS_RANK = 256
PANEL_ROWS = {4: 64, 8: 32}
#: groups (tree levels) one grouped launch takes (csrc/level_groups.cuh
#: kMaxGroups): 32 levels is 2**32 leaves
MAX_GROUPS = 32
#: values of gram_chol_levels' staging: two chunks of 8 features of 64 row
#: and 64 column points, 132 values a feature (build_stage.cu gram::)
_GRAM_STAGE = 2 * 8 * 132


def factor_dtype(data: torch.Tensor) -> torch.dtype:
    """The dtype a kernel computes and writes in for ``data`` of this
    dtype: float32 for bfloat16 data (the bfloat16-data entries), else the
    data's own."""
    return torch.float32 if data.dtype == torch.bfloat16 else data.dtype


def _bf16(data: torch.Tensor) -> int:
    """1 for the data of a bfloat16-data entry, else 0."""
    return int(data.dtype == torch.bfloat16)


def gram_smem(m: int, itemsize: int) -> int:
    """Shared memory of one gram_chol_levels block that factors an (m, m)
    tile: the tile at row stride m | 1, the pivots and the column buffer
    (as leaf_factor's), then the staged point chunks; so m <= 235 in
    float32 and <= 163 in float64.  A launch without factors needs the
    staging alone."""
    return factor_smem(m, itemsize) + _GRAM_STAGE * itemsize


def cross_smem(bm: int, r: int, itemsize: int) -> int:
    """Shared memory of one float64 cross_solve_levels block of ``bm``
    rows: Linv (r, r + 1), a (bm, r + 1) tile and the point and landmark
    chunks."""
    return ((r + bm) * (r + 1) + (bm + r) * (DC + 1)) * itemsize


def gram_dist_smem(m: int, itemsize: int) -> int:
    """Shared memory of one gram_chol_dist_levels block: the factor's
    (as leaf_factor's), so m <= 240 in f32 and m <= 169 in f64."""
    return factor_smem(m, itemsize)


def cross_dist_smem(bm: int, r: int, itemsize: int) -> int:
    """Shared memory of one float64 cross_solve_dist_levels block of
    ``bm`` rows: Linv (r, r + 1) and a (bm, r + 1) tile."""
    return (r + bm) * (r + 1) * itemsize


def gram_panel_smem(m: int, itemsize: int) -> int:
    """Shared memory of one gram_chol_levels_panel block: the panel
    factor's (:func:`~repro_torch.kernels.hck_leaf.ops.panel_smem`), then
    the staged point chunks; 156,416 bytes at m 512 in float64."""
    return panel_smem(m, itemsize) + _GRAM_STAGE * itemsize


def cross_panel_smem(itemsize: int) -> int:
    """Shared memory of one panel cross block (csrc/cross_panel.cuh), the
    same at every rank it takes: in float32 the (64, 260) K / Y tile and
    two Y slabs of (16, 260) floats; in float64 the (32, 257) tile and one
    slab of (16, 257) doubles."""
    rows, stride, slabs = (64, 260, 2) if itemsize == 4 else (32, 257, 1)
    return itemsize * (rows + 16 * slabs) * stride


def gram_route(stage: str, m: int, itemsize: int, dist: bool = False
               ) -> str:
    """How B1 (or with ``dist`` B8) factors an (m, m) tile of
    ``itemsize``-byte factors (float32 for bfloat16 data): "resident"
    where the resident kernel's block (:func:`gram_smem`,
    :func:`gram_dist_smem`) fits the shared memory, else "panel" up to m
    512, its block (:func:`gram_panel_smem`, the factor's alone for B8)
    checked against the shared memory; ``ValueError`` past m 512."""
    if dist:
        return factor_route(stage, m, itemsize, gram_dist_smem, panel_smem)
    return factor_route(stage, m, itemsize, gram_smem, gram_panel_smem)


def cross_route(stage: str, r: int, itemsize: int) -> str:
    """How B2 and B9 take rank r with ``itemsize``-byte factors (float32
    for bfloat16 data): "resident" up to :data:`RESIDENT_CROSS_RANK`
    (Linv whole in shared memory), "panel" up to :data:`MAX_CROSS_RANK`
    (Linv streamed; its block, :func:`cross_panel_smem`, checked against
    the shared memory); ``ValueError`` past it."""
    if r > MAX_CROSS_RANK:
        raise ValueError(f"{stage}: rank r={r} is above {MAX_CROSS_RANK}, "
                         "the largest the panel form of the kernel takes")
    if r <= RESIDENT_CROSS_RANK:
        return "resident"
    _build.check_smem(stage, cross_panel_smem(itemsize),
                      f"the panel form at rank r={r}")
    return "panel"


def row_tiles(r: int, itemsize: int, smem=cross_smem) -> list[int]:
    """The row heights the float64 cross kernels take at rank r: those of
    :data:`_ROW_TILES` whose resident block (``smem``) needs at most
    :data:`repro_torch.kernels._build.SMEM_MAX` bytes, or past
    :data:`RESIDENT_CROSS_RANK` the panel form's one height
    (:data:`PANEL_ROWS`); ``ValueError`` past :data:`MAX_CROSS_RANK`."""
    if cross_route("row_tiles", r, itemsize) == "panel":
        return [PANEL_ROWS[itemsize]]
    return [bm for bm in _ROW_TILES
            if smem(bm, r, itemsize) <= _build.SMEM_MAX]


def cross_rows(m: int, r: int, itemsize: int, smem=cross_smem,
               stage: str = "build_cross", row_tile: int | None = None
               ) -> int:
    """Row-tile height of the float64 cross tiles (cross_solve_levels, or
    with ``smem=cross_dist_smem`` cross_solve_dist_levels): ``row_tile``
    where given (``ValueError`` unless it is one of :func:`row_tiles`),
    else the largest of :func:`row_tiles` that does not overshoot m by a
    whole smaller tile (past :data:`RESIDENT_CROSS_RANK` the panel form's
    one height); ``ValueError`` when r exceeds :data:`MAX_CROSS_RANK` or
    no tile fits."""
    cross_route(stage, r, itemsize)
    fits = row_tiles(r, itemsize, smem)
    if not fits:
        _build.check_smem(stage, smem(_ROW_TILES[-1], r, itemsize),
                          f"rank r={r}")
    if row_tile is not None:
        if row_tile not in fits:
            raise ValueError(f"{stage}: row tile {row_tile} is not one of "
                             f"{fits}, the tiles whose block fits at rank "
                             f"r={r}")
        return row_tile
    return next((bm for bm in fits if bm // 2 < m), fits[-1])


def measured_row_tile(stage: str, m: int, r: int, d: int, itemsize: int,
                      smem=cross_smem) -> int | None:
    """The autotune tile database's row tile for the float64 cross tiles
    (``stage`` "build_cross" or "build_cross_dist", keyed as the
    reference's wrappers key them: n0 m, k r, and d 0 for the distance
    form), where it holds one whose block fits; else None (never
    raises)."""
    from repro_torch.kernels.registry import autotuned_block

    if r > MAX_CROSS_RANK:
        return None
    tile = autotuned_block(stage, n0=m, r=r, k=r, d=d, itemsize=itemsize)
    return tile if tile in row_tiles(r, itemsize, smem) else None


def _check_row_tile(stage: str, dtype: torch.dtype,
                    row_tile: int | None) -> None:
    if row_tile is not None and dtype != torch.float64:
        raise ValueError(f"{stage}: row_tile sets the float64 tile's rows; "
                         f"the {dtype} route's tiles are fixed")


def _check_name(name: str) -> None:
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")


def level_table(stage: str, rows) -> torch.Tensor:
    """The host table of a grouped launch: one int64 row per group, (the
    data pointers of the group's tensors in the stage's order, 0 for None,
    its nodes, its m), as csrc/level_groups.cuh's read_table takes it;
    ``ValueError`` past :data:`MAX_GROUPS` groups."""
    if len(rows) > MAX_GROUPS:
        raise ValueError(f"{stage}: {len(rows)} levels, above the "
                         f"{MAX_GROUPS} one launch takes")
    return torch.tensor([[0 if t is None else t.data_ptr() for t in row[:-2]]
                         + list(row[-2:]) for row in rows], dtype=torch.int64)


# ---------------------------------------------------------------------------
# B1 and B2: the build engine's stages, from points
# ---------------------------------------------------------------------------

def _by_route(rows, route):
    """``rows`` (one a level, m last) split by ``route(m)``: [(route,
    rows)] for the routes some row takes, resident first."""
    routes = [route(row[-1]) for row in rows]
    return [(r, [row for row, rr in zip(rows, routes) if rr == r])
            for r in ("resident", "panel") if r in routes]


def _gram_levels(stage, dev, points, want_chol, name, sigma, jitter):
    """Allocate and launch gram_chol_levels over the levels ``points``
    (with or without factors), one launch a route (:func:`gram_route`):
    ([(gram, chol or None)], launches, panel launches)."""
    if len({p.shape[2] for p in points}) > 1:
        raise ValueError(f"{stage} needs one d for all levels; got "
                         f"{[tuple(p.shape) for p in points]}")
    fdt = factor_dtype(points[0])

    def route(m):
        return gram_route(stage, m, fdt.itemsize) if want_chol else "resident"

    for p in points:
        route(p.shape[1])
    out = [(p.new_empty((p.shape[0], p.shape[1], p.shape[1]), dtype=fdt),
            p.new_empty((p.shape[0], p.shape[1], p.shape[1]), dtype=fdt)
            if want_chol else None) for p in points]
    rows = [(p, g, c, p.shape[0], p.shape[1])
            for p, (g, c) in zip(points, out) if g.numel()]
    level_table(stage, rows)           # MAX_GROUPS, before any launch
    split = _by_route(rows, route)
    sfx, kind = _build.SUFFIX[points[0].dtype], _build.EPILOGUE_KIND[name]
    for r, sub in split:
        table = level_table(stage, sub)
        if r == "panel":
            _build.launch(_build.library("build_stage_panel", points[0]),
                          f"gram_chol_levels_panel_{sfx}", dev, table,
                          len(table), points[0].shape[2], kind, float(sigma),
                          float(jitter))
        else:
            _build.launch(_build.library("build_stage", points[0]),
                          f"gram_chol_levels_{sfx}", dev, table, len(table),
                          points[0].shape[2], kind, float(sigma),
                          float(jitter), int(bool(want_chol)))
    return out, len(split), sum(r == "panel" for r, _ in split)


def build_gram(
    points: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, d) -> gram (B, m, m) = K(P, P) + jitter*m I [+ lower
    Cholesky]: one level of ``gram_chol_levels``."""
    _check_name(name)
    if points.ndim != 3:
        raise ValueError(f"build_gram needs points (B, m, d); got "
                         f"{tuple(points.shape)}")
    dev = _build.cuda_device("build_gram", data=(points,))
    if dev is None:
        return build_gram_ref(points, name=name, sigma=sigma, jitter=jitter,
                              want_chol=want_chol)
    (out,), launched, panel = _gram_levels("build_gram", dev, [points],
                                           want_chol, name, sigma, jitter)
    build_gram.launches += launched
    build_gram.panel_launches += panel
    build_gram.bf16_launches += launched * _bf16(points)
    return out


def build_gram_levels(
    points, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """Every level's (B_l, m_l, d) points -> per level (gram = K(P, P) +
    jitter*m_l I, its lower Cholesky factor, or None without
    ``want_chol``), in one launch (``gram_chol_levels``)."""
    _check_name(name)
    points = list(points)
    if any(p.ndim != 3 for p in points):
        raise ValueError("build_gram_levels needs points (B, m, d) per "
                         f"level; got {[tuple(p.shape) for p in points]}")
    if not points:
        return []
    dev = _build.cuda_device("build_gram_levels", data=tuple(points))
    if dev is None:
        return build_gram_levels_ref(points, name=name, sigma=sigma,
                                     jitter=jitter, want_chol=want_chol)
    out, launched, panel = _gram_levels("build_gram_levels", dev, points,
                                        want_chol, name, sigma, jitter)
    build_gram_levels.launches += launched
    build_gram_levels.panel_launches += panel
    build_gram_levels.bf16_launches += launched * _bf16(points[0])
    return out


def _check_cross(stage, points, landmarks, linvs) -> None:
    r = landmarks[0].shape[1] if landmarks else 0
    d = points[0].shape[2] if points and points[0].ndim == 3 else 0
    if len(points) != len(landmarks) or len(points) != len(linvs) or any(
            p.ndim != 3 or z.ndim != 3 or li.ndim != 3
            or z.shape != (p.shape[0], r, d) or p.shape[2] != d
            or li.shape != (p.shape[0], r, r)
            for p, z, li in zip(points, landmarks, linvs)):
        raise ValueError(
            f"{stage} needs points (B, m, d), landmarks (B, r, d) and linv "
            f"(B, r, r) of one r and one d; got "
            f"{[tuple(p.shape) for p in points]}, "
            f"{[tuple(z.shape) for z in landmarks]}, "
            f"{[tuple(li.shape) for li in linvs]}")


def _cross_levels(stage, dev, points, landmarks, linvs, name, sigma,
                  row_tile=None):
    """Allocate and launch one cross_solve_levels (its panel form past
    :data:`RESIDENT_CROSS_RANK`): ([U], launched, panel)."""
    r, d = landmarks[0].shape[1], points[0].shape[2]
    dtype = points[0].dtype
    route = cross_route(stage, r, factor_dtype(points[0]).itemsize)
    _check_row_tile(stage, dtype, row_tile)
    bm = ()
    if dtype == torch.float64:      # the CUDA-core tile: one height for all
        m, s = max(p.shape[1] for p in points), points[0].element_size()
        if row_tile is None:
            row_tile = measured_row_tile("build_cross", m, r, d, s)
        bm = (cross_rows(m, r, s, stage=stage, row_tile=row_tile),)
    out = [p.new_empty((p.shape[0], p.shape[1], r), dtype=linvs[0].dtype)
           for p in points]
    rows = [(p, z, li, u, p.shape[0], p.shape[1])
            for p, z, li, u in zip(points, landmarks, linvs, out)
            if u.numel()]
    table = level_table(stage, rows)
    if not rows:
        return out, False, False
    sfx, kind = _build.SUFFIX[dtype], _build.EPILOGUE_KIND[name]
    if route == "panel":            # one tile height, fixed in the kernel
        _build.launch(_build.library("build_stage_panel", points[0]),
                      f"cross_solve_levels_panel_{sfx}", dev, table,
                      len(rows), r, d, kind, float(sigma))
    else:
        _build.launch(_build.library("build_stage", points[0]),
                      f"cross_solve_levels_{sfx}", dev, table, len(rows), r,
                      d, *bm, kind, float(sigma))
    return out, True, route == "panel"


def build_cross(
    points: torch.Tensor, landmarks: torch.Tensor, linv: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0, row_tile: int | None = None,
) -> torch.Tensor:
    """(B, m, d), (B, r, d), (B, r, r) -> U (B, m, r) = K(P, Z) Linv^T Linv:
    one level of ``cross_solve_levels``.  Linv must be lower triangular
    (see :func:`build_cross_levels`).  ``row_tile``: the float64 tile's
    rows (one of :func:`row_tiles`; None: the autotune database's measured
    tile, else :func:`cross_rows`' choice); other dtypes take none."""
    _check_name(name)
    _check_cross("build_cross", [points], [landmarks], [linv])
    dev = _build.cuda_device("build_cross", linv,
                             data=(points, landmarks))
    if dev is None:
        return build_cross_ref(points, landmarks, linv, name=name,
                               sigma=sigma)
    (out,), launched, panel = _cross_levels("build_cross", dev, [points],
                                            [landmarks], [linv], name, sigma,
                                            row_tile)
    build_cross.launches += launched
    build_cross.panel_launches += panel
    build_cross.bf16_launches += launched * _bf16(points)
    return out


def build_cross_levels(
    points, landmarks, linvs, *, name: str = "gaussian", sigma: float = 1.0,
) -> list[torch.Tensor]:
    """Every level's (B_l, m_l, d) points, (B_l, r, d) parent landmarks and
    (B_l, r, r) parent Linv -> per level U = K(P, Z) Linv^T Linv (B_l, m_l,
    r), in one launch (``cross_solve_levels``); one r and one d for all
    levels.

    Each Linv must be lower triangular, as ``hck.sigma_linv`` and the
    rank masks' identity padding give it: the float32 kernel skips Linv's
    8 x 8 blocks above the diagonal (it reads the diagonal blocks whole),
    while the float64 kernel and the plain version take the full r x r
    matrix."""
    _check_name(name)
    points, landmarks, linvs = list(points), list(landmarks), list(linvs)
    _check_cross("build_cross_levels", points, landmarks, linvs)
    if not points:
        return []
    dev = _build.cuda_device("build_cross_levels", *linvs,
                             data=(*points, *landmarks))
    if dev is None:
        return build_cross_levels_ref(points, landmarks, linvs, name=name,
                                      sigma=sigma)
    out, launched, panel = _cross_levels("build_cross_levels", dev, points,
                                         landmarks, linvs, name, sigma)
    build_cross_levels.launches += launched
    build_cross_levels.panel_launches += panel
    build_cross_levels.bf16_launches += launched * _bf16(points[0])
    return out


# ---------------------------------------------------------------------------
# B8 and B9: the sweep engine's stages, from cached distances
# ---------------------------------------------------------------------------

def _gram_dist_levels(stage, dev, dists, name, sigma, jitter):
    """Allocate and launch gram_chol_dist_levels, one launch a route
    (:func:`gram_route` with :func:`gram_dist_smem`): ([(gram, chol)],
    launches, panel launches)."""
    fdt = factor_dtype(dists[0])

    def route(m):
        return gram_route(stage, m, fdt.itemsize, dist=True)

    for d in dists:
        route(d.shape[1])
    out = [(torch.empty_like(d, dtype=fdt), torch.empty_like(d, dtype=fdt))
           for d in dists]
    rows = [(d, g, c, d.shape[0], d.shape[1])
            for d, (g, c) in zip(dists, out) if d.numel()]
    level_table(stage, rows)           # MAX_GROUPS, before any launch
    split = _by_route(rows, route)
    sfx, kind = _build.SUFFIX[dists[0].dtype], _build.EPILOGUE_KIND[name]
    for r, sub in split:
        base, sym = (("build_dist_panel", "gram_chol_dist_levels_panel")
                     if r == "panel" else
                     ("build_dist", "gram_chol_dist_levels"))
        _build.launch(_build.library(base, dists[0]), f"{sym}_{sfx}", dev,
                      level_table(stage, sub),
                      len(sub), kind, float(sigma), float(jitter))
    return out, len(split), sum(r == "panel" for r, _ in split)


def build_gram_dist(
    dist: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, m) cached distances -> gram (B, m, m) = kappa_sigma(D) +
    jitter*m I [+ lower Cholesky]: with the factor one level of
    ``gram_chol_dist_levels``, without it ``gram_dist``."""
    _check_name(name)
    if dist.ndim != 3 or dist.shape[1] != dist.shape[2]:
        raise ValueError(f"build_gram_dist needs dist (B, m, m); got "
                         f"{tuple(dist.shape)}")
    dev = _build.cuda_device("build_gram_dist", data=(dist,))
    if dev is None:
        return build_gram_dist_ref(dist, name=name, sigma=sigma,
                                   jitter=jitter, want_chol=want_chol)
    if want_chol:
        (out,), launched, panel = _gram_dist_levels(
            "build_gram_dist", dev, [dist], name, sigma, jitter)
        build_gram_dist.launches += launched
        build_gram_dist.panel_launches += panel
        build_gram_dist.bf16_launches += launched * _bf16(dist)
        return out
    bsz, m, _ = dist.shape
    gram = torch.empty_like(dist, dtype=factor_dtype(dist))
    if gram.numel():
        _build.launch(_build.library("build_dist", dist),
                      f"gram_dist_{_build.SUFFIX[dist.dtype]}", dev, dist,
                      gram, bsz, m, _build.EPILOGUE_KIND[name], float(sigma),
                      float(jitter * m))
        build_gram_dist.launches += 1
        build_gram_dist.bf16_launches += _bf16(dist)
    return gram, None


def build_gram_dist_levels(
    dists, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Every level's (B_l, m_l, m_l) cached distances -> per level (gram =
    kappa_sigma(D) + jitter*m_l I, its lower Cholesky factor), in one
    launch (``gram_chol_dist_levels``)."""
    _check_name(name)
    dists = list(dists)
    if any(d.ndim != 3 or d.shape[1] != d.shape[2] for d in dists):
        raise ValueError("build_gram_dist_levels needs dists (B, m, m) per "
                         f"level; got {[tuple(d.shape) for d in dists]}")
    if not dists:
        return []
    dev = _build.cuda_device("build_gram_dist_levels", data=tuple(dists))
    if dev is None:
        return build_gram_dist_levels_ref(dists, name=name, sigma=sigma,
                                          jitter=jitter)
    out, launched, panel = _gram_dist_levels("build_gram_dist_levels", dev,
                                             dists, name, sigma, jitter)
    build_gram_dist_levels.launches += launched
    build_gram_dist_levels.panel_launches += panel
    build_gram_dist_levels.bf16_launches += launched * _bf16(dists[0])
    return out


def _cross_dist_levels(stage, dev, dists, linvs, name, sigma,
                       row_tile=None):
    """Allocate and launch one cross_solve_dist_levels (its panel form past
    :data:`RESIDENT_CROSS_RANK`): ([U], launched, panel)."""
    dtype, r = dists[0].dtype, dists[0].shape[-1]
    route = cross_route(stage, r, factor_dtype(dists[0]).itemsize)
    _check_row_tile(stage, dtype, row_tile)
    bm = ()
    if dtype == torch.float64:      # the CUDA-core tile: one height for all
        m, s = max(d.shape[1] for d in dists), dists[0].element_size()
        if row_tile is None:
            row_tile = measured_row_tile("build_cross_dist", m, r, 0, s,
                                         smem=cross_dist_smem)
        bm = (cross_rows(m, r, s, smem=cross_dist_smem, stage=stage,
                         row_tile=row_tile),)
    out = [torch.empty_like(d, dtype=linvs[0].dtype) for d in dists]
    rows = [(d, li, u, d.shape[0], d.shape[1])
            for d, li, u in zip(dists, linvs, out) if d.numel()]
    table = level_table(stage, rows)
    if not rows:
        return out, False, False
    sfx, kind = _build.SUFFIX[dtype], _build.EPILOGUE_KIND[name]
    if route == "panel":            # one tile height, fixed in the kernel
        _build.launch(_build.library("build_dist_panel", dists[0]),
                      f"cross_solve_dist_levels_panel_{sfx}", dev, table,
                      len(rows), r, kind, float(sigma))
    else:
        _build.launch(_build.library("build_dist", dists[0]),
                      f"cross_solve_dist_levels_{sfx}", dev, table,
                      len(rows), r, *bm, kind, float(sigma))
    return out, True, route == "panel"


def build_cross_dist(
    dist: torch.Tensor, linv: torch.Tensor, *, name: str = "gaussian",
    sigma: float = 1.0, row_tile: int | None = None,
) -> torch.Tensor:
    """(B, m, r) cached distances, (B, r, r) -> U (B, m, r) =
    kappa_sigma(D) Linv^T Linv: one level of ``cross_solve_dist_levels``.
    Linv must be lower triangular (see :func:`build_cross_dist_levels`).
    ``row_tile`` as in :func:`build_cross`."""
    _check_name(name)
    if (dist.ndim != 3 or linv.ndim != 3
            or linv.shape != (dist.shape[0], dist.shape[2], dist.shape[2])):
        raise ValueError(
            "build_cross_dist needs dist (B, m, r) and linv (B, r, r); got "
            f"{tuple(dist.shape)}, {tuple(linv.shape)}")
    dev = _build.cuda_device("build_cross_dist", linv, data=(dist,))
    if dev is None:
        return build_cross_dist_ref(dist, linv, name=name, sigma=sigma)
    (out,), launched, panel = _cross_dist_levels(
        "build_cross_dist", dev, [dist], [linv], name, sigma, row_tile)
    build_cross_dist.launches += launched
    build_cross_dist.panel_launches += panel
    build_cross_dist.bf16_launches += launched * _bf16(dist)
    return out


def build_cross_dist_levels(
    dists, linvs, *, name: str = "gaussian", sigma: float = 1.0,
) -> list[torch.Tensor]:
    """Every level's (B_l, m_l, r) cached distances and (B_l, r, r) parent
    Linv -> per level U = kappa_sigma(D) Linv^T Linv (B_l, m_l, r), in one
    launch (``cross_solve_dist_levels``); one r for all levels.

    Each Linv must be lower triangular, as ``hck.sigma_linv`` and the
    rank masks' identity padding give it: the float32 kernel skips Linv's
    8 x 8 blocks above the diagonal (it reads the diagonal blocks whole),
    while the float64 kernel and the plain version take the full r x r
    matrix."""
    _check_name(name)
    dists, linvs = list(dists), list(linvs)
    r = dists[0].shape[-1] if dists else 0
    if len(dists) != len(linvs) or any(
            d.ndim != 3 or li.shape != (d.shape[0], r, r) or d.shape[2] != r
            for d, li in zip(dists, linvs)):
        raise ValueError(
            "build_cross_dist_levels needs per level dist (B, m, r) and linv "
            f"(B, r, r) of one r; got {[tuple(d.shape) for d in dists]}, "
            f"{[tuple(li.shape) for li in linvs]}")
    if not dists:
        return []
    dev = _build.cuda_device("build_cross_dist_levels", *linvs,
                             data=tuple(dists))
    if dev is None:
        return build_cross_dist_levels_ref(dists, linvs, name=name,
                                           sigma=sigma)
    out, launched, panel = _cross_dist_levels("build_cross_dist_levels", dev,
                                              dists, linvs, name, sigma)
    build_cross_dist_levels.launches += launched
    build_cross_dist_levels.panel_launches += panel
    build_cross_dist_levels.bf16_launches += launched * _bf16(dists[0])
    return out


build_gram.launches = 0
build_cross.launches = 0
build_gram_levels.launches = 0
build_cross_levels.launches = 0
build_gram_dist.launches = 0
build_cross_dist.launches = 0
build_gram_dist_levels.launches = 0
build_cross_dist_levels.launches = 0

for _fn in (build_gram, build_cross, build_gram_levels, build_cross_levels,
            build_gram_dist, build_cross_dist, build_gram_dist_levels,
            build_cross_dist_levels):
    _fn.bf16_launches = 0
    _fn.panel_launches = 0
