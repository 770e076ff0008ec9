"""HCK factor container (counterpart of ``repro.core.hck.HCKFactors``).

The recursively off-diagonal low-rank factors of ``K_hck(X, X)`` on a
balanced binary tree, stacked per level:

  * ``adiag[i]``      K(X_i, X_i) (+ jitter)              (2**L, n0, n0)
  * ``u[i]``          K(X_i, Xl_p) K(Xl_p, Xl_p)^-1       (2**L, n0, r)
  * ``sigma[l]``      K(Xl_p, Xl_p) (+ jitter)            (2**l, r, r)
  * ``sigma_cho[l]``  lower Cholesky factor of sigma[l]   (2**l, r, r)
  * ``w[l-1]``        K(Xl_i, Xl_p) K(Xl_p, Xl_p)^-1      (2**l, r, r), l >= 1

:func:`build_hck` is the batched build engine: the partition, then the
factors of every level from three launches of two registry stages -- one
grouped ``build_gram_levels`` launch (every level's Sigma and its
Cholesky), one ``build_gram`` launch (the leaf Adiag blocks, no factor)
and one grouped ``build_cross_levels`` launch (the Sigma^-1-projected U
and every level's W), CUDA kernels on the card.  The hyperparameter
sweep engine splits that work: :func:`build_sweep_plan` partitions, draws
the landmarks and caches every bandwidth-independent distance tile once
(:class:`SweepPlan`), and :func:`sweep_factors` instantiates the factors
at one bandwidth from them
through the ``build_gram_dist`` stage (the leaves) and the grouped
``build_gram_dist_levels`` and ``build_cross_dist_levels`` stages (every
level in one launch each).  :func:`build_hck_streaming` builds the same factors
from host-resident data, the points staged through the device in chunks
(the partition) and in groups of leaves.
:func:`build_hck_reference` is the per-node transcription of Algorithm 2
and :func:`to_dense` the dense reconstruction, both oracles for tests.

Landmarks are r distinct rows of each node's block (paper section 4.2),
chosen by a landmark policy (:mod:`repro_torch.landmarks.policy`: uniform
by default, k-means or ridge leverage); a global rank budget
(:mod:`repro_torch.landmarks.budget`) masks each node's rank to a prefix
of the r slots.  Random draws do not cross frameworks, so the partition
directions, the per-level landmark row indices and a policy's own draws
can be passed in; the port's own draws come from an explicit
``torch.Generator``.

Under a mixed-precision policy (``SolveConfig.precision``, see
:func:`repro_torch.kernels.registry.precision_policy`) every stage
dispatcher casts its kernel-evaluation data (points, landmarks, cached
distance tiles) to the policy's GEMM dtype and Linv to its factor dtype,
and stores its outputs in the factor dtype; the partition, the landmark
draws and the distance tiles of a sweep plan stay in the input dtype, so a
bf16, f32 or f64 build of one ``x`` has one tree and one landmark set.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.kernels_fn import KERNEL_METRIC, BaseKernel
from repro_torch.core.partition import (PartitionTree, build_partition,
                                        rp_directions)
from repro_torch.data.pipeline import (draw_device, rows_to,
                                       stream_partition)
from repro_torch.kernels.registry import (DEFAULT_CONFIG, SolveConfig,
                                          get_impl, precision_policy,
                                          resolve_backend)
from repro_torch.landmarks import budget as _budget
from repro_torch.landmarks.policy import (LeveragePolicy, gather_block_rows,
                                          get_policy)

Tensor = torch.Tensor

#: min / max per-node active rank and the sum over all nodes of a factor set
RankSummary = collections.namedtuple("RankSummary", ("min", "max", "total"))


@dataclasses.dataclass
class HCKFactors:
    """Stacked factors of K_hck(X, X) plus the partition record.

    ``landmarks``, ``sigma`` and ``sigma_cho`` are tuples over levels
    0..L-1, ``w`` over levels 1..L-1.  ``rank_mask`` holds, per level, the
    (2**l, r) prefix masks of a budgeted build (1 for an active landmark
    slot, 0 for a masked one), or is None: every slot is active.
    """

    x_sorted: torch.Tensor     # (n, d) points in tree order
    tree: PartitionTree
    landmarks: tuple           # levels 0..L-1: (2**l, r, d)
    sigma: tuple               # levels 0..L-1: (2**l, r, r)
    sigma_cho: tuple           # lower Cholesky factors of sigma
    w: tuple                   # levels 1..L-1: (2**l, r, r)
    u: torch.Tensor            # (2**L, n0, r)
    adiag: torch.Tensor        # (2**L, n0, n0)
    rank_mask: tuple | None = None

    @property
    def levels(self) -> int:
        """Tree depth L."""
        return len(self.landmarks)

    @property
    def num_leaves(self) -> int:
        """Leaf count 2**L."""
        return self.adiag.shape[0]

    @property
    def leaf_size(self) -> int:
        """Points per leaf n0 = n / 2**L."""
        return self.adiag.shape[1]

    @property
    def rank(self) -> int:
        """Landmark slots per node r, the bucket every factor is shaped to
        (0 for a 0-level build); a budgeted build's active ranks are in
        :attr:`ranks`."""
        return self.landmarks[0].shape[1] if self.landmarks else 0

    @property
    def ranks(self) -> RankSummary:
        """Per-node active ranks: (min, max, sum over all nodes), host
        ints.  Without a budget every node has :attr:`rank`."""
        if not self.landmarks:
            return RankSummary(0, 0, 0)
        if self.rank_mask is None:
            nodes = (1 << self.levels) - 1
            return RankSummary(self.rank, self.rank, self.rank * nodes)
        per = torch.cat([m.sum(dim=1) for m in self.rank_mask])
        return RankSummary(int(per.min()), int(per.max()), int(per.sum()))

    @property
    def n(self) -> int:
        """Total training points."""
        return self.x_sorted.shape[0]


def landmark_indices(bsz: int, m: int, r: int, *, device: torch.device,
                     generator: torch.Generator | None = None) -> Tensor:
    """Per-node landmark row indices: (B, r) int64, r distinct positions in
    [0, m) per node, uniform without replacement."""
    keys = torch.rand((bsz, m), device=device, generator=generator)
    return torch.argsort(keys, dim=1)[:, :r]


def _draw_level_landmarks(x_sorted: Tensor, levels: int, rank: int, policy,
                          metric: str, config: SolveConfig | None, *,
                          landmark_index=None, policy_draws=None,
                          generator=None) -> tuple:
    """Landmarks of every level, (2**l, r, d), chosen by ``policy`` on the
    level's node blocks, shared by the build and the sweep engines.

    The draws of level l are ``policy_draws[l]`` (the policy's dict), else
    ``{"index": landmark_index[l]}`` ((2**l, r) row positions: the uniform
    draw, which is also k-means' start), else the policy's own draws from
    ``generator``, one level after the other.
    """
    n, d = x_sorted.shape
    for name, given in (("landmark index", landmark_index),
                        ("policy draw", policy_draws)):
        if given is not None and len(given) != levels:
            raise ValueError(f"{len(given)} {name} sets for {levels} levels")
    if (landmark_index is not None and policy_draws is None
            and isinstance(policy, LeveragePolicy)):
        raise ValueError("the leverage policy draws a pilot and Gumbel "
                         "noise: pass policy_draws, not landmark_index")
    out = []
    for lvl in range(levels):
        bsz, m = 1 << lvl, n >> lvl
        blocks = x_sorted.reshape(bsz, m, d)
        if policy_draws is not None:
            draws = policy_draws[lvl]
        elif landmark_index is not None:
            idx = torch.as_tensor(landmark_index[lvl])
            if idx.shape != (bsz, rank):
                raise ValueError(f"level {lvl} landmark indices shape "
                                 f"{tuple(idx.shape)} != {(bsz, rank)}")
            draws = {"index": idx}
        else:
            draws = policy.draws(bsz, m, rank, dtype=x_sorted.dtype,
                                 device=x_sorted.device, generator=generator)
        idx = policy.select(blocks, rank, draws=draws, metric=metric,
                            config=config)
        out.append(gather_block_rows(blocks, idx))
    return tuple(out)


def _broadcast_shared_landmarks(landmarks: tuple) -> tuple:
    """Paper section 4.2 remark: the root's landmark set at every node
    (the flat compositional kernel)."""
    root = landmarks[0]
    return tuple(root.expand(1 << lvl, *root.shape[1:]).contiguous()
                 for lvl in range(len(landmarks)))


def _apply_rank_masks(rank_mask: tuple, sigma: tuple, sigma_cho: tuple,
                      sigma_li: list):
    """Identity-pad the middle factors to their active-prefix ranks.

    For prefix masks the padded (Sigma, Cholesky, Linv) are exactly the
    factors of the truncated Gram, no refactorization.  Runs BEFORE any
    ``build_cross`` launch: U and W built against the full Linv cannot be
    column-masked after the fact, since the leading block of Sigma^-1 is
    not the inverse of Sigma's leading block.
    """
    pad = _budget.masked_identity_pad
    return (tuple(pad(s, mk) for s, mk in zip(sigma, rank_mask)),
            tuple(pad(c, mk) for c, mk in zip(sigma_cho, rank_mask)),
            [pad(li, mk) for li, mk in zip(sigma_li, rank_mask)])


def _mask_transfer_ops(w: tuple, rank_mask: tuple) -> tuple:
    """Zero the W rows and columns that touch masked slots (the child's
    rows, the parent's columns)."""
    return tuple(
        w[lvl - 1] * rank_mask[lvl][:, :, None]
        * torch.repeat_interleave(rank_mask[lvl - 1], 2, dim=0)[:, None, :]
        for lvl in range(1, len(rank_mask)))


def _policy(config: SolveConfig | None) -> tuple:
    """(GEMM dtype, factor dtype) of the config's precision policy, or
    (None, None) without one."""
    pol = precision_policy(config)
    return (None, None) if pol is None else pol


def _cast(ts, dtype) -> list:
    """The tensors ``ts`` in ``dtype`` (kept without a policy), contiguous."""
    return [(t if dtype is None else t.to(dtype)).contiguous() for t in ts]


def _stored(pair, dtype):
    """A (gram, factor or None) pair in ``dtype``."""
    gram, chol = pair
    return gram.to(dtype), None if chol is None else chol.to(dtype)


def _stage_build_gram(blocks: Tensor, kernel: BaseKernel,
                      config: SolveConfig, *, want_chol: bool = True):
    """One level's node blocks (B, m, d) through the ``build_gram`` stage:
    (gram (B, m, m), lower Cholesky or None).  Under a policy the blocks
    are cast to its GEMM dtype and the outputs stored in its factor
    dtype."""
    gemm, fac = _policy(config)
    out_dt = fac or blocks.dtype
    (blocks,) = _cast([blocks], gemm)
    backend = resolve_backend(config, "build_gram", blocks)
    return _stored(get_impl("build_gram", backend)(
        blocks, name=kernel.name, sigma=kernel.sigma, jitter=kernel.jitter,
        want_chol=want_chol), out_dt)


def _stage_build_gram_levels(blocks, kernel: BaseKernel,
                             config: SolveConfig) -> list:
    """Every level's node blocks (B, m, d) through the grouped
    ``build_gram_levels`` stage, one launch: per level (gram, lower
    Cholesky), under a policy as :func:`_stage_build_gram`."""
    gemm, fac = _policy(config)
    out_dt = fac or blocks[0].dtype
    blocks = _cast(blocks, gemm)
    backend = resolve_backend(config, "build_gram_levels", *blocks)
    return [_stored(pair, out_dt) for pair in get_impl(
        "build_gram_levels", backend)(
        blocks, name=kernel.name, sigma=kernel.sigma, jitter=kernel.jitter)]


def sigma_linv(chol: Tensor) -> Tensor:
    """Explicit inverse Cholesky factors ``Linv = L^-1`` per node.

    (B, r, r) lower factors -> (B, r, r) lower ``Linv``, computed once per
    node so that every ``build_cross`` launch applies ``Sigma^-1 = Linv^T
    Linv`` as two products.  The factored (not squared) form keeps
    cho_solve-grade accuracy.  Plain torch, as the reference computes it
    in jnp outside any kernel.
    """
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                         upper=False)


def _stage_build_cross(blocks: Tensor, lm_parent: Tensor, linv_parent: Tensor,
                       kernel: BaseKernel, config: SolveConfig) -> Tensor:
    """One level's cross blocks through the ``build_cross`` stage:
    (B, m, d), (B, r, d), (B, r, r) -> K(P, Z) Linv^T Linv (B, m, r).
    Under a policy the points and landmarks are cast to its GEMM dtype,
    Linv (a factor) to its factor dtype, and U is stored in the factor
    dtype."""
    gemm, fac = _policy(config)
    out_dt = fac or blocks.dtype
    blocks, lm_parent = _cast([blocks, lm_parent], gemm)
    (linv_parent,) = _cast([linv_parent], fac)
    backend = resolve_backend(config, "build_cross", blocks, lm_parent,
                              linv_parent)
    return get_impl("build_cross", backend)(
        blocks, lm_parent, linv_parent, name=kernel.name,
        sigma=kernel.sigma).to(out_dt)


def _stage_build_cross_levels(blocks, lm_parents, linv_parents,
                              kernel: BaseKernel, config: SolveConfig) -> list:
    """Every level's cross blocks through the grouped ``build_cross_levels``
    stage, one launch: per level (B, m, d), (B, r, d), (B, r, r) -> K(P, Z)
    Linv^T Linv (B, m, r), under a policy as :func:`_stage_build_cross`."""
    gemm, fac = _policy(config)
    out_dt = fac or blocks[0].dtype
    blocks, lm_parents = _cast(blocks, gemm), _cast(lm_parents, gemm)
    linv_parents = _cast(linv_parents, fac)
    backend = resolve_backend(config, "build_cross_levels", *blocks,
                              *lm_parents, *linv_parents)
    return [u.to(out_dt) for u in get_impl("build_cross_levels", backend)(
        blocks, lm_parents, linv_parents, name=kernel.name,
        sigma=kernel.sigma)]


def leaf_stage_factors(blocks: Tensor, lm_parent: Tensor, linv_parent: Tensor,
                       kernel: BaseKernel, config: SolveConfig | None = None):
    """Adiag and U of a group of leaf blocks (B, n0, d), with the PER-LEAF
    parent landmarks (B, r, d) and inverse Cholesky factors (B, r, r)
    (already repeated to leaf granularity): one ``build_gram`` launch
    without a factor and one ``build_cross`` launch (one-group launches of
    B1's and B2's grouped kernels).  Every row of a stage is independent,
    so these launches give what :func:`build_hck`'s paired-sibling
    launches give.  Returns (adiag (B, n0, n0), u (B, n0, r))."""
    config = config if config is not None else DEFAULT_CONFIG
    adiag, _ = _stage_build_gram(blocks, kernel, config, want_chol=False)
    u = _stage_build_cross(blocks, lm_parent, linv_parent, kernel, config)
    return adiag, u


def _middle_factors(landmarks: tuple, kernel: BaseKernel,
                    config: SolveConfig):
    """Sigma, its Cholesky factor and Linv for every level: one grouped
    ``build_gram_levels`` launch plus :func:`sigma_linv` per level (no
    launch for a 0-level build)."""
    if not landmarks:
        return (), (), []
    grams = _stage_build_gram_levels(landmarks, kernel, config)
    sigma_cho = tuple(c for _, c in grams)
    return (tuple(s for s, _ in grams), sigma_cho,
            [sigma_linv(c) for c in sigma_cho])


def _cross_factors(paired: Tensor, landmarks: tuple, sigma_li: list,
                   kernel: BaseKernel, config: SolveConfig):
    """U and the W factors of levels 1..L-1 in one grouped
    ``build_cross_levels`` launch, at parent granularity: sibling leaves
    (``paired``, (2**(L-1), 2 n0, d)) and sibling landmark blocks are
    paired, since they share their parent's landmarks and Linv.  Returns
    (u (2**L, n0, r), w)."""
    rank, d = landmarks[0].shape[1], landmarks[0].shape[2]
    levels = len(landmarks)
    blocks = [paired] + [landmarks[lvl].reshape(1 << (lvl - 1), 2 * rank, d)
                         for lvl in range(1, levels)]
    out = _stage_build_cross_levels(blocks, [landmarks[-1]] + list(
        landmarks[:-1]), [sigma_li[-1]] + sigma_li[:-1], kernel, config)
    n_leaves, n0 = 2 * paired.shape[0], paired.shape[1] // 2
    return (out[0].reshape(n_leaves, n0, rank),
            tuple(out[lvl].reshape(1 << lvl, rank, rank)
                  for lvl in range(1, levels)))


def _transfer_ops(landmarks: tuple, sigma_li: list, kernel: BaseKernel,
                  config: SolveConfig) -> tuple:
    """The W factors of levels 1..L-1 alone (paired sibling landmark
    blocks), in one grouped ``build_cross_levels`` launch: the middle
    rebuild of :func:`repro_torch.runtime.recover.repair_factors`, which
    keeps the leaves' U."""
    if len(landmarks) < 2:
        return ()
    rank, d = landmarks[0].shape[1], landmarks[0].shape[2]
    levels = range(1, len(landmarks))
    out = _stage_build_cross_levels(
        [landmarks[lvl].reshape(1 << (lvl - 1), 2 * rank, d)
         for lvl in levels], list(landmarks[:-1]), sigma_li[:-1], kernel,
        config)
    return tuple(o.reshape(1 << lvl, rank, rank)
                 for o, lvl in zip(out, levels))


def build_hck(
    x: Tensor, *, levels: int, rank: int, kernel: BaseKernel,
    method: str = "rp", shared_landmarks: bool = False,
    config: SolveConfig | None = None, policy=None,
    rank_budget: int | None = None, directions=None, landmark_index=None,
    policy_draws=None, generator: torch.Generator | None = None,
) -> HCKFactors:
    """Partition ``x`` and instantiate all HCK factors (batched engine).

    Algorithm 2 in three launches: one grouped ``build_gram_levels``
    launch for every level's Sigma and its Cholesky factor; after the rank
    masks one ``build_gram`` launch for the leaf Adiag blocks and one
    grouped ``build_cross_levels`` launch for U (paired sibling leaves)
    and every level's W.  On the card every launch is a CUDA kernel; on
    the CPU the plain versions run.

    ``x`` (n, d) with n divisible by 2**levels (``partition.pad_points``
    pads); ``rank`` <= n / 2**levels.  ``method`` "rp" (random
    projections) or "pca" (principal directions).  ``policy`` selects the
    landmarks: None / "uniform", "kmeans", "leverage" or a
    :class:`~repro_torch.landmarks.policy.LandmarkPolicy`; the tree is
    drawn first, so all policies share it.  ``shared_landmarks`` puts the
    root's landmarks at every node (the flat compositional kernel).
    ``rank_budget`` caps the sum of the per-node ranks, split by spectral
    mass and realized as prefix masks (``rank_mask``) applied to the
    middle factors before any cross launch.  ``directions`` ((2**l, d)
    per level), ``landmark_index`` ((2**l, r) row positions per level:
    the uniform draw and k-means' start) and ``policy_draws`` (a policy's
    dict per level) replace the random draws, which otherwise come from
    ``generator``.  ``levels == 0`` gives one dense leaf block.
    ``config.precision`` sets the mixed-precision policy of every stage
    (the tree and the landmarks are drawn in the dtype of ``x`` first).
    """
    config = config if config is not None else DEFAULT_CONFIG
    policy = get_policy(policy)
    n, d = x.shape
    n_leaves = 1 << levels
    if n % n_leaves != 0:
        raise ValueError(f"n={n} not divisible by 2**levels={n_leaves}")
    n0 = n // n_leaves
    if rank > n0:
        raise ValueError(f"rank {rank} exceeds leaf size {n0} (paper 4.4)")
    if rank_budget is not None and levels == 0:
        raise ValueError("rank_budget needs levels >= 1 (a 0-level build "
                         "has no low-rank factors)")

    x_sorted, tree = build_partition(x, levels, directions=directions,
                                     generator=generator, method=method)
    landmarks = _draw_level_landmarks(
        x_sorted, levels, rank, policy, KERNEL_METRIC.get(kernel.name, "l2"),
        config, landmark_index=landmark_index, policy_draws=policy_draws,
        generator=generator)
    if shared_landmarks and levels > 0:
        landmarks = _broadcast_shared_landmarks(landmarks)
    sigma, sigma_cho, sigma_li = _middle_factors(landmarks, kernel, config)
    rank_mask = None
    if rank_budget is not None:
        rank_mask = _budget.allocate_rank_masks(sigma, rank_budget, rank)
        sigma, sigma_cho, sigma_li = _apply_rank_masks(
            rank_mask, sigma, sigma_cho, sigma_li)

    leaves = x_sorted.reshape(n_leaves, n0, d)
    adiag, _ = _stage_build_gram(leaves, kernel, config, want_chol=False)
    if levels == 0:
        return HCKFactors(x_sorted, tree, (), (), (), (),
                          adiag.new_zeros((1, n0, 0)), adiag)
    u, w = _cross_factors(leaves.reshape(n_leaves // 2, 2 * n0, d),
                          landmarks, sigma_li, kernel, config)
    if rank_mask is not None:
        u = u * torch.repeat_interleave(rank_mask[-1], 2, dim=0)[:, None, :]
        w = _mask_transfer_ops(w, rank_mask)
    return HCKFactors(x_sorted, tree, landmarks, sigma, sigma_cho, w, u,
                      adiag, rank_mask)


def _streamed_landmarks(source, perm, lvl: int, rank: int,
                        dev: torch.device, generator, index=None) -> Tensor:
    """Level ``lvl``'s landmarks (2**lvl, r, d), gathered from the host
    ``source`` by index: :func:`landmark_indices` positions (or ``index``)
    inside each node's block of the host permutation ``perm``."""
    bsz, m = 1 << lvl, perm.shape[0] >> lvl
    if index is None:
        index = landmark_indices(bsz, m, rank, device=dev,
                                 generator=generator)
    index = torch.as_tensor(index)
    if index.shape != (bsz, rank):
        raise ValueError(f"level {lvl} landmark indices shape "
                         f"{tuple(index.shape)} != {(bsz, rank)}")
    pos = index.cpu().numpy() + np.arange(bsz)[:, None] * m
    return rows_to(source, perm[pos.reshape(-1)], dev).reshape(
        bsz, rank, source.dim)


def _streamed_leaves(source, perm, lm_last: Tensor, linv_last: Tensor,
                     n0: int, kernel: BaseKernel, config: SolveConfig,
                     leaf_batch: int, dev: torch.device):
    """The leaves' points in tree order, Adiag and U, ``leaf_batch``
    leaves at a time through :func:`leaf_stage_factors` (the last level's
    landmarks and Linv repeated to leaf granularity, since a group need
    not hold whole sibling pairs)."""
    n, d = perm.shape[0], source.dim
    n_leaves, dtype = n // n0, linv_last.dtype
    lm_parent = torch.repeat_interleave(lm_last, 2, dim=0)
    linv_parent = torch.repeat_interleave(linv_last, 2, dim=0)
    x_sorted = torch.empty((n, d), dtype=lm_last.dtype, device=dev)
    adiag = torch.empty((n_leaves, n0, n0), dtype=dtype, device=dev)
    u = torch.empty((n_leaves, n0, lm_last.shape[1]), dtype=dtype,
                    device=dev)
    for start in range(0, n_leaves, leaf_batch):
        stop = min(start + leaf_batch, n_leaves)
        blk = rows_to(source, perm[start * n0:stop * n0], dev)
        x_sorted[start * n0:stop * n0] = blk
        adiag[start:stop], u[start:stop] = leaf_stage_factors(
            blk.reshape(stop - start, n0, d), lm_parent[start:stop],
            linv_parent[start:stop], kernel, config)
    return x_sorted, adiag, u


def build_hck_streaming(
    source, *, levels: int, rank: int, kernel: BaseKernel,
    method: str = "rp", shared_landmarks: bool = False,
    config: SolveConfig | None = None, leaf_batch: int = 64,
    chunk_rows: int = 1 << 16, policy=None, rank_budget: int | None = None,
    directions=None, landmark_index=None,
    generator: torch.Generator | None = None, device=None,
    timings: dict | None = None,
) -> HCKFactors:
    """Build HCK factors from a host-resident
    :class:`repro_torch.data.pipeline.ChunkSource`.

    The raw (n, d) data is never on the device in one piece: the
    partition streams chunks of ``chunk_rows`` rows
    (:func:`repro_torch.data.pipeline.stream_partition`), the landmark
    rows are gathered from the source by index, and the leaves pass
    through :func:`leaf_stage_factors` ``leaf_batch`` at a time (one
    ``build_gram`` and one ``build_cross`` launch a group, the parents'
    landmarks and Linv repeated per leaf).  Sigma of every level is one
    grouped ``build_gram_levels`` launch and W one grouped
    ``build_cross_levels`` launch, as in :func:`build_hck`.  The factors
    are the usual O(n (n0 + r)) device arrays.

    The draws are :func:`build_hck`'s, in its order, from ``generator``
    (on its device, else on ``device``, None = the card: the device the
    factors live on): the directions level by level, then one landmark
    draw a level; ``directions`` and ``landmark_index`` replace them.  A
    source that wraps an in-memory array therefore gives
    :func:`build_hck`'s tree and landmarks exactly, and its factors up to
    the stages' launch shapes.  ``timings``, a dict, receives the wall
    seconds of each partition level, the landmarks, the middle factors,
    the leaf groups and W (the device synchronised).

    Only the uniform landmark policy streams (the node blocks are never on
    the device for a clustered or leverage selection to scan), and there
    is no rank budget: both raise ``ValueError``, as does ``levels < 1``
    (a 0-level build is one dense block), as in the reference.
    ``config.precision`` is :func:`build_hck`'s policy.
    """
    from repro_torch.landmarks.policy import UniformPolicy

    config = config if config is not None else DEFAULT_CONFIG
    if levels < 1:
        raise ValueError("build_hck_streaming needs levels >= 1 "
                         "(a 0-level build is one dense block)")
    if not isinstance(get_policy(policy), UniformPolicy):
        raise ValueError(
            "build_hck_streaming supports the uniform landmark policy "
            "only: node blocks are never device-resident, so clustered/"
            "leverage selection has nothing to scan -- build in memory "
            "instead")
    if rank_budget is not None:
        raise ValueError(
            "build_hck_streaming does not support rank_budget; use "
            "build_hck for budgeted adaptive rank")
    if leaf_batch < 1:
        raise ValueError(f"leaf_batch must be >= 1, got {leaf_batch}")
    n, n_leaves = source.n, 1 << levels
    if n % n_leaves != 0:
        raise ValueError(f"n={n} not divisible by 2**levels={n_leaves}")
    n0 = n // n_leaves
    if rank > n0:
        raise ValueError(f"rank {rank} exceeds leaf size {n0} (paper 4.4)")
    if landmark_index is not None and len(landmark_index) != levels:
        raise ValueError(f"{len(landmark_index)} landmark index sets for "
                         f"{levels} levels")
    dev = draw_device(generator, device)
    perm, tree = stream_partition(
        source, levels, generator=generator, device=dev,
        directions=directions, method=method, chunk_rows=chunk_rows,
        timings=timings)
    landmarks = _device.timed(timings, "landmarks", dev, lambda: tuple(
        _streamed_landmarks(source, perm, lvl, rank, dev, generator,
                            None if landmark_index is None
                            else landmark_index[lvl])
        for lvl in range(levels)))
    if shared_landmarks:
        landmarks = _broadcast_shared_landmarks(landmarks)
    sigma, sigma_cho, sigma_li = _device.timed(
        timings, "middle factors", dev,
        lambda: _middle_factors(landmarks, kernel, config))
    x_sorted, adiag, u = _device.timed(
        timings, "leaf groups", dev, lambda: _streamed_leaves(
            source, perm, landmarks[-1], sigma_li[-1], n0, kernel, config,
            leaf_batch, dev))
    w = _device.timed(timings, "transfer W", dev, lambda: _transfer_ops(
        landmarks, sigma_li, kernel, config))
    return HCKFactors(x_sorted, tree, landmarks, sigma, sigma_cho, w, u,
                      adiag)


# ---------------------------------------------------------------------------
# Hyperparameter sweep engine: partition and draw once, cache the distance
# tiles, re-instantiate the factors for every bandwidth.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepPlan:
    """Bandwidth-independent precomputation for a (sigma, lambda) grid.

    Every base kernel of :data:`repro_torch.core.kernels_fn.KERNEL_METRIC`
    is an elementwise function of a bandwidth-independent metric distance,
    and the tree and the landmarks do not depend on the bandwidth, so a
    grid needs one partition, one landmark draw and one distance pass:

      * ``x_sorted`` / ``tree`` / ``landmarks`` -- the hierarchy
      * ``lm_self[l]``    (2**l, r, r)       landmark self distances
      * ``lm_cross[l-1]`` (2**(l-1), 2r, r)  sibling landmarks -> parent's
      * ``leaf_self``     (2**L, n0, n0)     leaf self distances
      * ``leaf_cross``    (2**(L-1), 2n0, r) sibling leaves -> parent's
                                             landmarks

    ``metric`` is "l2" (squared Euclidean: gaussian, imq) or "l1"
    (laplace).
    """

    x_sorted: Tensor
    tree: PartitionTree
    landmarks: tuple           # levels 0..L-1: (2**l, r, d)
    lm_self: tuple             # levels 0..L-1: (2**l, r, r)
    lm_cross: tuple            # levels 1..L-1: (2**(l-1), 2r, r)
    leaf_self: Tensor          # (2**L, n0, n0)
    leaf_cross: Tensor         # (2**(L-1), 2 n0, r)
    metric: str = "l2"

    @property
    def levels(self) -> int:
        """Tree depth L."""
        return len(self.landmarks)

    @property
    def num_leaves(self) -> int:
        """Leaf count 2**L."""
        return self.leaf_self.shape[0]

    @property
    def leaf_size(self) -> int:
        """Points per leaf n0."""
        return self.leaf_self.shape[1]

    @property
    def rank(self) -> int:
        """Landmarks per node r."""
        return self.landmarks[0].shape[1]


def _plan_tiles(x_sorted: Tensor, tree: PartitionTree, landmarks: tuple,
                metric: str, levels: int, rank: int, n0: int) -> SweepPlan:
    """The distance tiles of a fixed hierarchy and landmark set."""
    from repro_torch.kernels.build_stage.ref import pairwise_dist_ref

    n_leaves, d = 1 << levels, x_sorted.shape[1]
    lm_self = tuple(pairwise_dist_ref(lm, lm, metric) for lm in landmarks)
    lm_cross = tuple(
        pairwise_dist_ref(landmarks[lvl].reshape(1 << (lvl - 1), 2 * rank, d),
                          landmarks[lvl - 1], metric)
        for lvl in range(1, levels))
    leaves = x_sorted.reshape(n_leaves, n0, d)
    leaf_self = pairwise_dist_ref(leaves, leaves, metric)
    leaf_cross = pairwise_dist_ref(leaves.reshape(n_leaves // 2, 2 * n0, d),
                                   landmarks[-1], metric)
    return SweepPlan(x_sorted, tree, landmarks, lm_self, lm_cross,
                     leaf_self, leaf_cross, metric=metric)


def build_sweep_plan(
    x, *, levels: int, rank: int, name: str = "gaussian", method: str = "rp",
    shared_landmarks: bool = False, policy=None,
    config: SolveConfig | None = None, directions=None, landmark_index=None,
    policy_draws=None, generator: torch.Generator | None = None,
    device=None,
) -> SweepPlan:
    """Partition once and cache every bandwidth-independent distance tile.

    Draws the tree and the landmarks exactly as :func:`build_hck` does
    (directions, then one landmark draw per level, from ``generator``, or
    the injected ``directions``, ``landmark_index`` and ``policy_draws``),
    so ``sweep_factors(plan, kernel)`` reproduces ``build_hck(x, ...,
    kernel=kernel)`` for every kernel of ``name``'s metric.  The distance
    pass is plain torch, once per grid (see
    :func:`repro_torch.kernels.build_stage.ref.pairwise_dist_ref`).

    ``policy`` is the sweep's landmark-policy axis: selection does not
    depend on sigma, so one plan per policy serves the whole sigma grid,
    and :func:`replan_policy` redraws an existing plan's landmarks without
    partitioning again; ``config`` steers only the policy's
    ``policy_dist`` stage.  ``x`` (n, d), n divisible by 2**levels,
    levels >= 1.  ``device``: None is the CUDA card (raises without one),
    "cpu" the plain path.  The plan is in the dtype of ``x`` whatever
    ``config.precision`` says: :func:`sweep_factors` applies a policy.
    """
    config = config if config is not None else DEFAULT_CONFIG
    if name not in KERNEL_METRIC:
        raise ValueError(
            f"kernel {name!r} has no registered bandwidth-independent "
            f"metric; sweepable kernels: {sorted(KERNEL_METRIC)}")
    if levels < 1:
        raise ValueError("build_sweep_plan needs levels >= 1 (a 0-level "
                         "build is one dense block)")
    x = torch.as_tensor(x).to(_device.resolve(device))
    n, _ = x.shape
    if n % (1 << levels) != 0:
        raise ValueError(f"n={n} not divisible by 2**levels={1 << levels}")
    n0 = n >> levels
    if rank > n0:
        raise ValueError(f"rank {rank} exceeds leaf size {n0} (paper 4.4)")
    x_sorted, tree = build_partition(x, levels, directions=directions,
                                     generator=generator, method=method)
    metric = KERNEL_METRIC[name]
    landmarks = _draw_level_landmarks(
        x_sorted, levels, rank, get_policy(policy), metric, config,
        landmark_index=landmark_index, policy_draws=policy_draws,
        generator=generator)
    if shared_landmarks:
        landmarks = _broadcast_shared_landmarks(landmarks)
    return _plan_tiles(x_sorted, tree, landmarks, metric, levels, rank, n0)


def replan_policy(
    plan: SweepPlan, *, rank: int, policy, config: SolveConfig | None = None,
    landmark_index=None, policy_draws=None,
    generator: torch.Generator | None = None,
) -> SweepPlan:
    """Redraw an existing plan's landmarks under another landmark policy.

    The policy axis of a sweep: ``plan.x_sorted`` and ``plan.tree`` are
    reused (no partition), and the draws are consumed as
    :func:`build_sweep_plan` consumes them: from ``generator``, the
    random-projection directions of every level are drawn and discarded
    first, then one landmark draw per level; or the injected
    ``landmark_index`` / ``policy_draws``.  So ``replan_policy(
    build_sweep_plan(x, ..., generator=g0), ..., generator=g1,
    policy=p)``, with g1 in g0's starting state, equals
    ``build_sweep_plan(x, ..., generator=g1, policy=p)`` for a
    random-projection plan.  ``rank`` may differ from the plan's
    (accuracy against rank on one hierarchy).
    """
    config = config if config is not None else DEFAULT_CONFIG
    levels = plan.levels
    n, d = plan.x_sorted.shape
    n0 = n >> levels
    if rank > n0:
        raise ValueError(f"rank {rank} exceeds leaf size {n0} (paper 4.4)")
    if generator is not None and landmark_index is None and policy_draws is None:
        for lvl in range(levels):         # the partition's draws, discarded
            rp_directions(1 << lvl, d, dtype=plan.x_sorted.dtype,
                          device=plan.x_sorted.device, generator=generator)
    landmarks = _draw_level_landmarks(
        plan.x_sorted, levels, rank, get_policy(policy), plan.metric, config,
        landmark_index=landmark_index, policy_draws=policy_draws,
        generator=generator)
    return _plan_tiles(plan.x_sorted, plan.tree, landmarks, plan.metric,
                       levels, rank, n0)


def _stage_gram_dist(dist: Tensor, kernel: BaseKernel, config: SolveConfig):
    """Cached (B, m, m) tiles through the ``build_gram_dist`` stage
    without a factor: gram (B, m, m) (the leaf Adiag blocks).  Under a
    policy the tiles (the kernel-evaluation data) are cast to its GEMM
    dtype and the Gram stored in its factor dtype."""
    gemm, fac = _policy(config)
    out_dt = fac or dist.dtype
    (dist,) = _cast([dist], gemm)
    backend = resolve_backend(config, "build_gram_dist", dist)
    return get_impl("build_gram_dist", backend)(
        dist, name=kernel.name, sigma=kernel.sigma, jitter=kernel.jitter,
        want_chol=False)[0].to(out_dt)


def _stage_gram_dist_levels(dists, kernel: BaseKernel,
                            config: SolveConfig) -> list:
    """Every level's cached (B, m, m) tiles through the grouped
    ``build_gram_dist_levels`` stage, one launch: per level (gram, lower
    Cholesky), under a policy as :func:`_stage_gram_dist`."""
    gemm, fac = _policy(config)
    out_dt = fac or dists[0].dtype
    dists = _cast(dists, gemm)
    backend = resolve_backend(config, "build_gram_dist_levels", *dists)
    return [_stored(pair, out_dt) for pair in get_impl(
        "build_gram_dist_levels", backend)(
        dists, name=kernel.name, sigma=kernel.sigma, jitter=kernel.jitter)]


def _stage_cross_dist_levels(dists, linvs, kernel: BaseKernel,
                             config: SolveConfig) -> list:
    """Cached (B, m, r) tiles of every level with their parents' Linv
    through the grouped ``build_cross_dist_levels`` stage, one launch: per
    level kappa(D) Linv^T Linv (B, m, r).  Under a policy the tiles are
    cast to its GEMM dtype, Linv to its factor dtype, and U is stored in
    the factor dtype."""
    gemm, fac = _policy(config)
    out_dt = fac or dists[0].dtype
    dists, linvs = _cast(dists, gemm), _cast(linvs, fac)
    backend = resolve_backend(config, "build_cross_dist_levels", *dists,
                              *linvs)
    return [u.to(out_dt) for u in get_impl(
        "build_cross_dist_levels", backend)(
        dists, linvs, name=kernel.name, sigma=kernel.sigma)]


def sweep_factors(plan: SweepPlan, kernel: BaseKernel,
                  config: SolveConfig | None = None, *,
                  rank_budget: int | None = None) -> HCKFactors:
    """:class:`HCKFactors` at one bandwidth from a :class:`SweepPlan`: the
    per-sigma pass of the sweep engine.

    One grouped ``build_gram_dist_levels`` launch for every level's Sigma
    and its Cholesky factor (then :func:`sigma_linv` per level, recomputed
    at every sigma), one ``build_gram_dist`` launch for the leaf Adiag
    blocks, and one grouped ``build_cross_dist_levels`` launch for U and
    every level's W: the kernel nonlinearity and the factorization only,
    no partition, no landmark draw, no distance work.  With the plan drawn
    as a ``build_hck`` call draws, the result matches that call for any
    ``kernel`` of the plan's metric.  ``rank_budget`` is
    :func:`build_hck`'s, its masks recomputed at every sigma (the landmark
    Gram, hence the spectral mass, depends on it).  ``config.precision``
    is :func:`build_hck`'s policy: the cached tiles are the GEMM data.
    """
    config = config if config is not None else DEFAULT_CONFIG
    if KERNEL_METRIC.get(kernel.name) != plan.metric:
        raise ValueError(
            f"kernel {kernel.name!r} (metric "
            f"{KERNEL_METRIC.get(kernel.name)!r}) does not match the plan's "
            f"cached metric {plan.metric!r}; rebuild the plan with "
            f"name={kernel.name!r}")
    levels, rank = plan.levels, plan.rank
    n_leaves, n0 = plan.num_leaves, plan.leaf_size
    grams = _stage_gram_dist_levels(plan.lm_self, kernel, config)
    sigma = tuple(s for s, _ in grams)
    sigma_cho = tuple(c for _, c in grams)
    sigma_li = [sigma_linv(c) for c in sigma_cho]
    rank_mask = None
    if rank_budget is not None:
        rank_mask = _budget.allocate_rank_masks(sigma, rank_budget, rank)
        sigma, sigma_cho, sigma_li = _apply_rank_masks(
            rank_mask, sigma, sigma_cho, sigma_li)
    adiag = _stage_gram_dist(plan.leaf_self, kernel, config)
    cross = _stage_cross_dist_levels(
        (plan.leaf_cross,) + plan.lm_cross, [sigma_li[-1]] + sigma_li[:-1],
        kernel, config)
    u = cross[0].reshape(n_leaves, n0, rank)
    w = tuple(cross[lvl].reshape(1 << lvl, rank, rank)
              for lvl in range(1, levels))
    if rank_mask is not None:
        u = u * torch.repeat_interleave(rank_mask[-1], 2, dim=0)[:, None, :]
        w = _mask_transfer_ops(w, rank_mask)
    return HCKFactors(plan.x_sorted, plan.tree, plan.landmarks, sigma,
                      sigma_cho, w, u, adiag, rank_mask)


# ---------------------------------------------------------------------------
# Oracles for tests: the per-node Algorithm 2 and the dense reconstruction.
# ---------------------------------------------------------------------------

def build_hck_reference(
    x: Tensor, *, levels: int, rank: int, kernel: BaseKernel,
    directions=None, landmark_index=None,
    generator: torch.Generator | None = None,
) -> HCKFactors:
    """Per-node transcription of Algorithm 2 (host loop, test oracle).

    Each node gets one Gram, one Cholesky factor and one cross solve
    through :class:`BaseKernel` and ``torch.linalg``, no registry stage.
    With the same ``directions`` and ``landmark_index`` it agrees with
    :func:`build_hck` to factorization round-off.
    """
    n, d = x.shape
    n_leaves = 1 << levels
    if n % n_leaves != 0:
        raise ValueError(f"n={n} not divisible by 2**levels={n_leaves}")
    n0 = n // n_leaves
    if rank > n0:
        raise ValueError(f"rank {rank} exceeds leaf size {n0} (paper 4.4)")
    x_sorted, tree = build_partition(x, levels, directions=directions,
                                     generator=generator)
    landmarks = _draw_level_landmarks(
        x_sorted, levels, rank, get_policy(None), "l2", None,
        landmark_index=landmark_index, generator=generator)
    sigma = tuple(torch.stack([kernel.gram(z) for z in lm])
                  for lm in landmarks)
    sigma_cho = tuple(torch.stack([torch.linalg.cholesky(s) for s in sg])
                      for sg in sigma)
    leaves = x_sorted.reshape(n_leaves, n0, d)
    adiag = torch.stack([kernel.gram(leaf) for leaf in leaves])
    if levels == 0:
        return HCKFactors(x_sorted, tree, (), (), (), (),
                          x.new_zeros((1, n0, 0)), adiag)

    def cross_node(pts, lm_p, cho_p):
        kxu = kernel.cross(pts, lm_p)
        return torch.cholesky_solve(kxu.T, cho_p, upper=False).T

    u = torch.stack([cross_node(leaves[i], landmarks[-1][i >> 1],
                                sigma_cho[-1][i >> 1])
                     for i in range(n_leaves)])
    w = tuple(
        torch.stack([cross_node(landmarks[lvl][i], landmarks[lvl - 1][i >> 1],
                                sigma_cho[lvl - 1][i >> 1])
                     for i in range(1 << lvl)])
        for lvl in range(1, levels))
    return HCKFactors(x_sorted, tree, landmarks, sigma, sigma_cho, w, u,
                      adiag)


def to_dense(f: HCKFactors) -> Tensor:
    """Materialize K_hck(X, X) (n, n) from the factors (test oracle)."""
    n0, levels, n = f.leaf_size, f.levels, f.n
    if levels == 0:
        return f.adiag[0]
    a = f.adiag.new_zeros((n, n))
    for i in range(f.num_leaves):
        a[i * n0:(i + 1) * n0, i * n0:(i + 1) * n0] = f.adiag[i]
    # effective bases: ubig[l][i] spans node i's whole block
    ubig = {levels: list(f.u)}
    for lvl in range(levels - 1, 0, -1):
        ubig[lvl] = [torch.cat([ubig[lvl + 1][2 * p], ubig[lvl + 1][2 * p + 1]])
                     @ f.w[lvl - 1][p] for p in range(1 << lvl)]
    for lvl in range(levels, 0, -1):
        block = n >> lvl
        for p in range(1 << (lvl - 1)):
            i, j = 2 * p, 2 * p + 1
            cross = ubig[lvl][i] @ f.sigma[lvl - 1][p] @ ubig[lvl][j].T
            ri = slice(i * block, (i + 1) * block)
            rj = slice(j * block, (j + 1) * block)
            a[ri, rj] = cross
            a[rj, ri] = cross.T
    return a
