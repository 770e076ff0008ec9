"""Hierarchical domain partitioning (counterpart of ``repro.core.partition``).

A balanced binary tree built level-synchronously: at level ``l`` the
permuted points are viewed as ``(2**l, m, d)`` and every block is split at
the median of its projection on one direction.  The tree is recorded as
per-level directions and thresholds, so out-of-sample points are routed to
their leaf with one gather per level.

Randomness does not cross frameworks, so the random draws (the projection
directions, the padding rows and their noise) can be passed in; the port's
own draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class PartitionTree:
    """Balanced binary partition of n = n_leaves * leaf_size points.

    perm:        (n,) int64 -- sorted position -> original index.
    directions:  tuple over levels 0..L-1 of (2**l, d) float tensors.
    thresholds:  tuple over levels 0..L-1 of (2**l,) median split points.
    """

    perm: Tensor
    directions: tuple
    thresholds: tuple

    @property
    def levels(self) -> int:
        """Tree depth L (number of split levels)."""
        return len(self.directions)

    @property
    def num_leaves(self) -> int:
        """Leaf count 2**L."""
        return 1 << self.levels


def project_rows(x: Tensor, direction: Tensor) -> Tensor:
    """Projections ``sum_k x[..., k] * direction[..., k]`` of rows ``x``
    (..., d) on directions broadcast against them: (...).

    The products, zero-padded to a power of two of features, are summed as
    a pairwise tree of elementwise adds (the first half plus the second,
    ceil(log2 d) launches), so a row's projection depends on that row and
    its direction alone, the same on the CPU and on the card, whether the
    rows come as a level's node blocks (:func:`build_partition`) or in
    chunks of any size (:func:`repro_torch.data.pipeline.stream_partition`);
    a reduction or a product library call sums in an order that can change
    with the number of rows, and a near-tie at a median then moves a
    point.
    """
    prod = x * direction
    d = prod.shape[-1]
    width = 1 << max(d - 1, 0).bit_length()
    if width != d:
        prod = torch.nn.functional.pad(prod, (0, width - d))
    while width > 1:
        width //= 2
        prod = prod[..., :width] + prod[..., width:]
    return prod[..., 0]


def _split_level(x: Tensor, perm: Tensor, direction: Tensor):
    """Split every block of ``x`` (B, m, d) at its projected median."""
    bsz, m, d = x.shape
    proj = project_rows(x, direction[:, None, :])
    order = torch.argsort(proj, dim=1, stable=True)
    x = torch.gather(x, 1, order[:, :, None].expand(bsz, m, d))
    perm = torch.gather(perm.reshape(bsz, m), 1, order)
    sorted_proj = torch.gather(proj, 1, order)
    thr = 0.5 * (sorted_proj[:, m // 2 - 1] + sorted_proj[:, m // 2])
    return x.reshape(bsz * 2, m // 2, d), perm.reshape(-1), thr


def rp_directions(bsz: int, d: int, *, dtype: torch.dtype,
                  device: torch.device,
                  generator: torch.Generator | None = None) -> Tensor:
    """Random unit directions for one level: (B, d)."""
    v = torch.randn((bsz, d), dtype=dtype, device=device, generator=generator)
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def _pca_direction(blocks: Tensor) -> Tensor:
    """Dominant right singular vector of each centered block (B, m, d) ->
    (B, d): 16 power-iteration steps from the normalized all-ones vector,
    deterministic, as the reference's ``_pca_direction``."""
    xc = blocks - torch.mean(blocks, dim=1, keepdim=True)
    cov = torch.einsum("bmd,bme->bde", xc, xc)
    v = torch.ones((blocks.shape[0], blocks.shape[-1]), dtype=blocks.dtype,
                   device=blocks.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(16):
        v = torch.einsum("bde,be->bd", cov, v)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
    return v


def build_partition(
    x: Tensor, levels: int, *, directions=None,
    generator: torch.Generator | None = None, method: str = "rp",
) -> tuple[Tensor, PartitionTree]:
    """Partition ``x`` (n, d) into 2**levels balanced leaves.

    ``method`` "rp" splits on random projections (the paper's choice),
    "pca" on each block's dominant principal direction (the paper's
    Fig. 4 / Table 2 comparison; no random draw).  ``directions`` (a
    sequence of ``levels`` tensors (2**l, d)) replaces the directions, so
    a tree can be rebuilt from the reference's; without it each "rp" level
    draws unit normals from ``generator``.  Returns the points in tree
    order (leaf blocks contiguous) and the routing record.
    """
    n, d = x.shape
    if method not in ("rp", "pca"):
        raise ValueError(f"unknown partition method {method!r}; use 'rp' "
                         "or 'pca'")
    if n % (1 << levels) != 0:
        raise ValueError(f"n={n} not divisible by 2**levels={1 << levels}")
    if directions is not None and len(directions) != levels:
        raise ValueError(f"{len(directions)} directions for {levels} levels")
    perm = torch.arange(n, device=x.device)
    blocks = x.reshape(1, n, d)
    dirs, thrs = [], []
    for lvl in range(levels):
        if directions is None and method == "pca":
            direction = _pca_direction(blocks)
        elif directions is None:
            direction = rp_directions(1 << lvl, d, dtype=x.dtype,
                                      device=x.device, generator=generator)
        else:
            direction = directions[lvl].to(dtype=x.dtype, device=x.device)
            if direction.shape != (1 << lvl, d):
                raise ValueError(f"level {lvl} direction shape "
                                 f"{tuple(direction.shape)} != {(1 << lvl, d)}")
        blocks, perm, thr = _split_level(blocks, perm, direction)
        dirs.append(direction)
        thrs.append(thr)
    return blocks.reshape(n, d), PartitionTree(perm, tuple(dirs), tuple(thrs))


def route(tree: PartitionTree, queries: Tensor) -> Tensor:
    """Leaf index of each query: (q, d) -> (q,) int64.

    Descends the recorded hyperplanes; a projection strictly above the
    node's threshold goes right (``t > thr``), as in the reference.
    """
    node = torch.zeros((queries.shape[0],), dtype=torch.int64,
                       device=queries.device)
    for lvl in range(tree.levels):
        dirs = tree.directions[lvl][node]                  # (q, d)
        thr = tree.thresholds[lvl][node]                   # (q,)
        t = torch.einsum("qd,qd->q", queries, dirs)
        node = 2 * node + (t > thr).to(torch.int64)
    return node


def group_by_leaf(leaf: Tensor, num_leaves: int):
    """Segment a routed batch by leaf: (q,) -> (order, counts, starts).

    ``order`` is a STABLE sort permutation putting queries of one leaf
    next to each other; ``counts[p]`` counts the queries of leaf ``p``;
    ``starts[p]`` is its segment offset (``cumsum(counts) - counts``).
    """
    order = torch.argsort(leaf, stable=True)
    counts = torch.bincount(leaf, minlength=num_leaves)
    starts = torch.cumsum(counts, dim=0) - counts
    return order, counts, starts


def pad_points(x: Tensor, y: Tensor | None, leaf_size: int, levels: int, *,
               generator: torch.Generator | None = None,
               index: Tensor | None = None, noise: Tensor | None = None):
    """Pad (x, y) so that n == leaf_size * 2**levels.

    Padding rows repeat existing points (``index``, default uniform draws)
    plus ``noise`` (default 1e-4 * standard normal) and COPY their targets.
    Returns (x_pad, y_pad, mask); ``mask`` marks the real rows and y_pad
    is None iff y is None.  Exact-size inputs round-trip unchanged.
    """
    if levels < 1:
        raise ValueError(f"pad_points needs levels >= 1, got {levels}")
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be >= 1, got {leaf_size}")
    n = x.shape[0]
    target = leaf_size * (1 << levels)
    if n > target:
        raise ValueError(f"n={n} exceeds capacity {target}")
    if n == target:
        return x, y, torch.ones((n,), dtype=torch.bool, device=x.device)
    extra = target - n
    if index is None:
        index = torch.randint(0, n, (extra,), device=x.device,
                              generator=generator)
    if noise is None:
        noise = 1e-4 * torch.randn((extra, x.shape[1]), dtype=x.dtype,
                                   device=x.device, generator=generator)
    if index.shape != (extra,) or noise.shape != (extra, x.shape[1]):
        raise ValueError(f"padding needs index ({extra},) and noise "
                         f"({extra}, {x.shape[1]})")
    index = index.to(device=x.device, dtype=torch.int64)
    x_pad = torch.cat([x, x[index] + noise.to(x)], dim=0)
    y_pad = None if y is None else torch.cat([y, y[index]], dim=0)
    mask = torch.cat([torch.ones((n,), dtype=torch.bool, device=x.device),
                      torch.zeros((extra,), dtype=torch.bool,
                                  device=x.device)])
    return x_pad, y_pad, mask


def auto_levels(n: int, leaf_size: int) -> int:
    """Largest L with leaf_size * 2**L <= n (paper Eq. 22 sizing)."""
    levels = 0
    while leaf_size * (1 << (levels + 1)) <= n:
        levels += 1
    return levels


def auto_levels_ceil(n: int, leaf_size: int) -> int:
    """Smallest L with leaf_size * 2**L >= n (padding-capacity sizing)."""
    levels = 0
    while leaf_size * (1 << levels) < n:
        levels += 1
    return levels
