"""Wrappers of the build-stage CUDA kernels (``csrc/build_stage.cu`` and
``csrc/build_dist.cu``).

``build_gram`` launches ``gram_chol`` (B1), ``build_cross`` launches
``cross_solve`` (B2); for one tree level the sweep engine's
``build_gram_dist`` launches ``gram_chol_dist`` or, without a factor,
``gram_dist`` (B8) and ``build_cross_dist`` launches ``cross_solve_dist``
(B9).  The grouped forms cover every level of one sigma in one launch:
``build_gram_dist_levels`` (B8's Sigma levels, B3's blocked factor) and
``build_cross_dist_levels`` (B9's U and W levels; split TF32 on the tensor
cores in float32).  On CPU tensors each wrapper computes its plain version
(:mod:`repro_torch.kernels.build_stage.ref`); on CUDA tensors it launches
the kernel or raises.  Each wrapper's ``launches`` counts its kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.build_stage.ref import (
    build_cross_dist_levels_ref, build_cross_dist_ref, build_cross_ref,
    build_gram_dist_levels_ref, build_gram_dist_ref, build_gram_ref)
from repro_torch.kernels.hck_leaf.ops import factor_smem

#: feature columns staged per chunk (build_stage.cu)
DC = 32
#: cross_solve's row tiles (multiples of its 16 thread rows), largest first,
#: and its largest rank (16 thread columns of 8 outputs)
_ROW_TILES = (128, 64, 32, 16)
MAX_CROSS_RANK = 128
#: groups (tree levels) one grouped launch takes (csrc/build_dist.cu
#: kMaxGroups): 32 levels is 2**32 leaves
MAX_GROUPS = 32


def gram_smem(m: int, itemsize: int) -> int:
    """Shared memory of one gram_chol block: the (m, m + 1) tile and an
    (m, DC + 1) chunk of points."""
    return (m * (m + 1) + m * (DC + 1)) * itemsize


def cross_smem(bm: int, r: int, itemsize: int) -> int:
    """Shared memory of one cross_solve block of ``bm`` rows: Linv
    (r, r + 1), a (bm, r + 1) tile and the point and landmark chunks."""
    return ((r + bm) * (r + 1) + (bm + r) * (DC + 1)) * itemsize


def gram_dist_smem(m: int, itemsize: int) -> int:
    """Shared memory of one gram_chol_dist block: the (m, m + 1) tile."""
    return m * (m + 1) * itemsize


def cross_dist_smem(bm: int, r: int, itemsize: int) -> int:
    """Shared memory of one cross_solve_dist block of ``bm`` rows: Linv
    (r, r + 1) and a (bm, r + 1) tile."""
    return (r + bm) * (r + 1) * itemsize


def check_cross_rank(r: int, stage: str) -> None:
    """``ValueError`` when r exceeds :data:`MAX_CROSS_RANK`."""
    if r > MAX_CROSS_RANK:
        raise ValueError(f"{stage}: rank r={r} above {MAX_CROSS_RANK} "
                         "needs the panel form of the kernel, which is later "
                         "work")


def cross_rows(m: int, r: int, itemsize: int, smem=cross_smem,
               stage: str = "build_cross") -> int:
    """Row-tile height of cross_solve (or, with ``smem=cross_dist_smem``,
    of cross_solve_dist): the largest of :data:`_ROW_TILES` whose block
    needs at most :data:`repro_torch.kernels._build.SMEM_MAX` bytes and
    that does not overshoot m by a whole smaller tile; ``ValueError`` when
    r exceeds :data:`MAX_CROSS_RANK` or no tile fits."""
    check_cross_rank(r, stage)
    fits = [bm for bm in _ROW_TILES
            if smem(bm, r, itemsize) <= _build.SMEM_MAX]
    if not fits:
        _build.check_smem(stage, smem(_ROW_TILES[-1], r, itemsize),
                          f"rank r={r}")
    return next((bm for bm in fits if bm // 2 < m), fits[-1])


def _check_name(name: str) -> None:
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")


def build_gram(
    points: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, d) -> gram (B, m, m) = K(P, P) + jitter*m I [+ lower Cholesky]."""
    _check_name(name)
    if points.ndim != 3:
        raise ValueError(f"build_gram needs points (B, m, d); got "
                         f"{tuple(points.shape)}")
    dev = _build.cuda_device("build_gram", points)
    if dev is None:
        return build_gram_ref(points, name=name, sigma=sigma, jitter=jitter,
                              want_chol=want_chol)
    bsz, m, d = points.shape
    _build.check_smem("build_gram", gram_smem(m, points.element_size()),
                      f"an ({m}, {m}) tile")
    gram = torch.empty((bsz, m, m), dtype=points.dtype, device=dev)
    chol = torch.empty_like(gram) if want_chol else None
    if gram.numel() == 0:
        return gram, chol
    _build.launch("build_stage",
                  f"gram_chol_{_build.SUFFIX[points.dtype]}", dev, points,
                  gram, chol, bsz, m, d, _build.EPILOGUE_KIND[name],
                  float(sigma), float(jitter * m))
    build_gram.launches += 1
    return gram, chol


def build_cross(
    points: torch.Tensor, landmarks: torch.Tensor, linv: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """(B, m, d), (B, r, d), (B, r, r) -> U (B, m, r) = K(P, Z) Linv^T Linv."""
    _check_name(name)
    if (points.ndim != 3 or landmarks.ndim != 3 or linv.ndim != 3
            or landmarks.shape[0] != points.shape[0]
            or landmarks.shape[2] != points.shape[2]
            or linv.shape != (points.shape[0], landmarks.shape[1],
                              landmarks.shape[1])):
        raise ValueError(
            "build_cross needs points (B, m, d), landmarks (B, r, d) and "
            f"linv (B, r, r); got {tuple(points.shape)}, "
            f"{tuple(landmarks.shape)}, {tuple(linv.shape)}")
    dev = _build.cuda_device("build_cross", points, landmarks, linv)
    if dev is None:
        return build_cross_ref(points, landmarks, linv, name=name,
                               sigma=sigma)
    bsz, m, d = points.shape
    r = landmarks.shape[1]
    out = torch.empty((bsz, m, r), dtype=points.dtype, device=dev)
    if out.numel() == 0:
        return out
    bm = cross_rows(m, r, points.element_size())
    _build.launch("build_stage",
                  f"cross_solve_{_build.SUFFIX[points.dtype]}", dev, points,
                  landmarks, linv, out, bsz, m, r, d, bm,
                  _build.EPILOGUE_KIND[name], float(sigma))
    build_cross.launches += 1
    return out


def build_gram_dist(
    dist: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, m) cached distances -> gram (B, m, m) = kappa_sigma(D) +
    jitter*m I [+ lower Cholesky]."""
    _check_name(name)
    if dist.ndim != 3 or dist.shape[1] != dist.shape[2]:
        raise ValueError(f"build_gram_dist needs dist (B, m, m); got "
                         f"{tuple(dist.shape)}")
    dev = _build.cuda_device("build_gram_dist", dist)
    if dev is None:
        return build_gram_dist_ref(dist, name=name, sigma=sigma,
                                   jitter=jitter, want_chol=want_chol)
    bsz, m, _ = dist.shape
    if want_chol:
        _build.check_smem("build_gram_dist",
                          gram_dist_smem(m, dist.element_size()),
                          f"an ({m}, {m}) tile")
    gram = torch.empty_like(dist)
    chol = torch.empty_like(dist) if want_chol else None
    if gram.numel() == 0:
        return gram, chol
    sfx = _build.SUFFIX[dist.dtype]
    opts = (_build.EPILOGUE_KIND[name], float(sigma), float(jitter * m))
    if want_chol:
        _build.launch("build_dist", f"gram_chol_dist_{sfx}", dev, dist, gram,
                      chol, bsz, m, *opts)
    else:
        _build.launch("build_dist", f"gram_dist_{sfx}", dev, dist, gram, bsz,
                      m, *opts)
    build_gram_dist.launches += 1
    return gram, chol


def build_cross_dist(
    dist: torch.Tensor, linv: torch.Tensor, *, name: str = "gaussian",
    sigma: float = 1.0,
) -> torch.Tensor:
    """(B, m, r) cached distances, (B, r, r) -> U (B, m, r) =
    kappa_sigma(D) Linv^T Linv."""
    _check_name(name)
    if (dist.ndim != 3 or linv.ndim != 3
            or linv.shape != (dist.shape[0], dist.shape[2], dist.shape[2])):
        raise ValueError(
            "build_cross_dist needs dist (B, m, r) and linv (B, r, r); got "
            f"{tuple(dist.shape)}, {tuple(linv.shape)}")
    dev = _build.cuda_device("build_cross_dist", dist, linv)
    if dev is None:
        return build_cross_dist_ref(dist, linv, name=name, sigma=sigma)
    bsz, m, r = dist.shape
    out = torch.empty_like(dist)
    if out.numel() == 0:
        return out
    bm = cross_rows(m, r, dist.element_size(), smem=cross_dist_smem,
                    stage="build_cross_dist")
    _build.launch("build_dist",
                  f"cross_solve_dist_{_build.SUFFIX[dist.dtype]}", dev, dist,
                  linv, out, bsz, m, r, bm, _build.EPILOGUE_KIND[name],
                  float(sigma))
    build_cross_dist.launches += 1
    return out


def level_table(stage: str, rows) -> torch.Tensor:
    """The host table of a grouped launch: one int64 row per group, (the
    group's three tensors' data pointers, nodes, m), as
    csrc/build_dist.cu's read_table takes it; ``ValueError`` past
    :data:`MAX_GROUPS` groups."""
    if len(rows) > MAX_GROUPS:
        raise ValueError(f"{stage}: {len(rows)} levels, above the "
                         f"{MAX_GROUPS} one launch takes")
    return torch.tensor([[a.data_ptr(), b.data_ptr(), c.data_ptr(), nodes, m]
                         for a, b, c, nodes, m in rows], dtype=torch.int64)


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
    dev = _build.cuda_device("build_gram_dist_levels", *dists)
    if dev is None:
        return build_gram_dist_levels_ref(dists, name=name, sigma=sigma,
                                          jitter=jitter)
    for d in dists:
        m = d.shape[1]
        _build.check_smem("build_gram_dist_levels",
                          factor_smem(m, d.element_size()),
                          f"an ({m}, {m}) tile")
    out = [(torch.empty_like(d), torch.empty_like(d)) for d in dists]
    rows = [(d, g, c, d.shape[0], d.shape[1])
            for d, (g, c) in zip(dists, out) if d.numel()]
    table = level_table("build_gram_dist_levels", rows)
    if rows:
        _build.launch("build_dist",
                      f"gram_chol_dist_levels_{_build.SUFFIX[dists[0].dtype]}",
                      dev, table, len(rows), _build.EPILOGUE_KIND[name],
                      float(sigma), float(jitter))
        build_gram_dist_levels.launches += 1
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
    dev = _build.cuda_device("build_cross_dist_levels", *dists, *linvs)
    if dev is None:
        return build_cross_dist_levels_ref(dists, linvs, name=name,
                                           sigma=sigma)
    dtype = dists[0].dtype
    stage = "build_cross_dist_levels"
    check_cross_rank(r, stage)
    if dtype == torch.float64:      # the CUDA-core tile: one height for all
        bm = (cross_rows(max(d.shape[1] for d in dists), r,
                         dists[0].element_size(),
                         smem=cross_dist_smem, stage=stage),)
    else:
        bm = ()
    out = [torch.empty_like(d) for d in dists]
    rows = [(d, li, u, d.shape[0], d.shape[1])
            for d, li, u in zip(dists, linvs, out) if d.numel()]
    table = level_table(stage, rows)
    if rows:
        _build.launch("build_dist",
                      f"cross_solve_dist_levels_{_build.SUFFIX[dtype]}", dev,
                      table, len(rows), r, *bm, _build.EPILOGUE_KIND[name],
                      float(sigma))
        build_cross_dist_levels.launches += 1
    return out


build_gram.launches = 0
build_cross.launches = 0
build_gram_dist.launches = 0
build_cross_dist.launches = 0
build_gram_dist_levels.launches = 0
build_cross_dist_levels.launches = 0
