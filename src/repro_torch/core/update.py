"""Online updates of a frozen HCK hierarchy (counterpart of
``repro.core.update``).

New points are absorbed without the Algorithm-2 rebuild: the partition
tree, the landmark sets, the middle factors Sigma and the transfer
operators W stay FROZEN.  The arrivals are routed down the recorded
hyperplanes (:func:`repro_torch.core.partition.route`, a projection on a
threshold goes left), appended to their leaves, and only the leaf factors
change:

  * ``adiag`` grows by a cross row block and an appended diagonal block
    (plain kernel evaluations, O(k n0 d) per leaf);
  * ``u`` grows by the appended rows' Nystrom projection against the
    frozen parent landmarks: one ``build_cross`` launch (B2 on the card)
    at leaf granularity;
  * the leaf Schur Cholesky factors of an existing structured inverse are
    extended by the bordered ``leaf_update`` stage (B13 on the card, see
    :func:`repro_torch.core.hmatrix.invert_extend`).

The lambda' diagonal (``kernel.jitter``, scaled by the leaf size in
``BaseKernel.gram``) is FROZEN AT FIT TIME: the fit added ``jitter *
n0_base`` to each leaf diagonal, and online growth puts that absolute
value on the appended rows too, since rescaling it with the growing leaf
would change the old diagonal and break the exact bordered extension.
:func:`refit_frozen` is the from-scratch oracle under the same convention.

Every leaf's slab is padded to the batch's largest per-leaf count ``k``
with duplicate-and-jitter rows of the leaf's own block (the
``pad_points`` rule; duplicated rows copy their source's targets).  That
keeps the leaves uniform and makes :func:`downdate` an exact truncation.
Random draws do not cross frameworks, so the padding rows (``pad_index``)
and their noise (``pad_noise``) can be passed in.

:class:`RebuildPolicy` bounds the drift: when leaf growth, warm-start
iterations or the update's residual pass its thresholds, the caller should
schedule a full :func:`repro_torch.core.krr.fit`
(``krr.fit_incremental`` reports the flag).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hck import (HCKFactors, _stage_build_cross,
                                  leaf_stage_factors, sigma_linv)
from repro_torch.core.hmatrix import _rep2
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import PartitionTree, group_by_leaf, route
from repro_torch.kernels.registry import DEFAULT_CONFIG, SolveConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RebuildPolicy:
    """Thresholds that call for a full rebuild of an updated model.

    max_leaf_growth   appended rows per leaf as a fraction of the fit-time
                      leaf size; past it the O(k n0^2) update nears the
                      O(n0^3) refactorization and the frozen tree's
                      balance degrades.
    max_warm_iters    warm-started CG iterations of the last re-solve
                      (``refresh="stale"``); None disables the check.
    max_update_error  relative residual of the last re-solve; None
                      disables the check.
    """

    max_leaf_growth: float = 0.5
    max_warm_iters: int | None = None
    max_update_error: float | None = None

    def should_rebuild(self, *, base_leaf_size: int, leaf_size: int,
                       warm_iters: int | None = None,
                       update_error: float | None = None) -> bool:
        """Whether the accumulated updates call for a full rebuild."""
        growth = (leaf_size - base_leaf_size) / max(base_leaf_size, 1)
        if growth > self.max_leaf_growth:
            return True
        if (self.max_warm_iters is not None and warm_iters is not None
                and warm_iters > self.max_warm_iters):
            return True
        return (self.max_update_error is not None and update_error is not None
                and update_error > self.max_update_error)


@dataclasses.dataclass(frozen=True)
class InsertRecord:
    """Host record of one insert: ``k`` rows appended per leaf (0 = no-op),
    ``base_leaf_size`` the leaf size before it, ``counts[p]`` the real
    arrivals of leaf p, ``real_rows`` the (P, k) mask of the appended slots
    that hold an arrival (the rest are padding)."""

    k: int
    base_leaf_size: int
    counts: np.ndarray
    real_rows: np.ndarray


def insert(
    factors: HCKFactors, x_new: Tensor, kernel: BaseKernel, *,
    config: SolveConfig | None = None, y_new: Tensor | None = None,
    y_sorted: Tensor | None = None, jitter_rows: int | None = None,
    linv_leaf: Tensor | None = None, pad_index: Tensor | None = None,
    pad_noise: Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[HCKFactors, Tensor | None, "InsertRecord"]:
    """Append ``x_new`` (q, d) to the leaves of the frozen hierarchy.

    Routes the batch down the recorded tree, pads every leaf's slab to
    the batch's largest per-leaf count ``k`` and extends ``adiag``, ``u``,
    ``x_sorted`` and ``perm``; landmarks, Sigma, W and the rank masks are
    untouched.  q == 0 is an exact no-op.

    kernel:      the fit's kernel; its jitter is read at ``jitter_rows``
                 rows (default: the current leaf size, right for the first
                 insert after a fit; later ones pass the fit's leaf size).
    config:      backends and precision policy of the appended rows'
                 ``build_cross`` launch.
    y_new:       (q,) or (q, k) encoded targets of the arrivals; needs
                 ``y_sorted``, the (n,) or (n, k) current targets in tree
                 order (padding rows copy their source's targets).
    linv_leaf:   the (P, r, r) leaf-granularity Linv of the last level's
                 Sigma (``HCKRegressor.leaf_linv``); None computes it.
    pad_index:   (P, k) rows of each leaf's block that the padding
                 duplicates, ``pad_noise`` (P, k, d) the noise added to
                 them (default 1e-4 standard normal); both default to
                 draws from ``generator``.  A slot that an arrival takes
                 keeps the arrival.

    Returns ``(factors_new, y_sorted_new, record)``; appended rows get the
    virtual input indices ``n_old + leaf * k + slot`` in ``perm``.
    """
    config = config if config is not None else DEFAULT_CONFIG
    if factors.levels < 1:
        raise ValueError("insert needs a real hierarchy (levels >= 1); "
                         "rebuild the dense 0-level block directly")
    n0, p_leaves = factors.leaf_size, factors.num_leaves
    q = x_new.shape[0]
    if q == 0:
        return factors, y_sorted, InsertRecord(
            0, n0, np.zeros((p_leaves,), np.int64),
            np.zeros((p_leaves, 0), bool))
    if y_new is not None and y_sorted is None:
        raise ValueError("y_new requires y_sorted (current tree-order "
                         "targets) so padding rows can copy their source "
                         "targets")
    jitter_rows = n0 if jitter_rows is None else jitter_rows
    x_sorted = factors.x_sorted
    dev, dt = x_sorted.device, x_sorted.dtype
    d = x_sorted.shape[1]

    leaf = route(factors.tree, x_new)
    order, counts, starts = group_by_leaf(leaf, p_leaves)
    counts_np = counts.cpu().numpy()
    k = int(counts_np.max())                         # the one host read
    leaf_sorted = leaf[order]
    pos = torch.arange(q, device=dev) - starts[leaf_sorted]

    if pad_index is None:
        pad_index = torch.randint(0, n0, (p_leaves, k), device=dev,
                                  generator=generator)
    if pad_noise is None:
        pad_noise = 1e-4 * torch.randn((p_leaves, k, d), dtype=dt,
                                       device=dev, generator=generator)
    pad_index = torch.as_tensor(pad_index, device=dev).to(torch.int64)
    pad_noise = torch.as_tensor(pad_noise, device=dev).to(dt)
    if pad_index.shape != (p_leaves, k) or pad_noise.shape != (p_leaves, k,
                                                               d):
        raise ValueError(f"padding needs pad_index ({p_leaves}, {k}) and "
                         f"pad_noise ({p_leaves}, {k}, {d})")

    # the padding rows, overwritten by the arrivals where they land
    x_leaves = x_sorted.reshape(p_leaves, n0, d)
    x_app = torch.gather(x_leaves, 1, pad_index[..., None].expand(
        p_leaves, k, d)) + pad_noise
    x_app[leaf_sorted, pos] = x_new[order].to(dt)

    # Adiag: cross block and appended block, the frozen lambda' diagonal
    # (jitter * jitter_rows) on the appended rows only
    # (in the factors' dtype: a mixed-precision policy's factor dtype)
    fdt = factors.adiag.dtype
    kcross = kernel.cross(x_app, x_leaves).to(fdt)             # (P, k, n0)
    kdiag = (kernel.cross(x_app, x_app) + (kernel.jitter * jitter_rows)
             * torch.eye(k, dtype=dt, device=dev)).to(fdt)
    adiag_new = torch.cat([
        torch.cat([factors.adiag, kcross.mT], dim=2),
        torch.cat([kcross, kdiag], dim=2)], dim=1)

    # U: one build_cross launch against the frozen parent landmarks and
    # Linv at leaf granularity.  A budgeted model's frozen Linv is
    # identity-padded on its masked slots, so those columns are zeroed as
    # the build zeroed them.
    if linv_leaf is None:
        linv_leaf = _rep2(sigma_linv(factors.sigma_cho[-1]))
    u_app = _stage_build_cross(x_app, _rep2(factors.landmarks[-1]),
                               linv_leaf, kernel, config)
    if factors.rank_mask is not None:
        u_app = u_app * _rep2(factors.rank_mask[-1])[:, None, :]
    u_new = torch.cat([factors.u, u_app.to(factors.u.dtype)], dim=1)

    n_old = factors.n
    x_sorted_new = torch.cat([x_leaves, x_app], dim=1).reshape(-1, d)
    perm = factors.tree.perm
    perm_app = (n_old + torch.arange(p_leaves * k, dtype=perm.dtype,
                                     device=dev)).reshape(p_leaves, k)
    perm_new = torch.cat([perm.reshape(p_leaves, n0), perm_app],
                         dim=1).reshape(-1)

    y_sorted_new = None
    if y_sorted is not None:
        yk = y_sorted if y_sorted.ndim > 1 else y_sorted[:, None]
        y_leaves = yk.reshape(p_leaves, n0, -1)
        y_app = torch.gather(y_leaves, 1, pad_index[..., None].expand(
            p_leaves, k, y_leaves.shape[-1]))
        if y_new is not None:
            yn = y_new if y_new.ndim > 1 else y_new[:, None]
            y_app[leaf_sorted, pos] = yn[order].to(y_app.dtype)
        y_sorted_new = torch.cat([y_leaves, y_app], dim=1).reshape(
            -1, yk.shape[-1])
        if y_sorted.ndim == 1:
            y_sorted_new = y_sorted_new[:, 0]

    # the arrivals of leaf p take its first counts[p] slots
    real = np.arange(k)[None, :] < counts_np[:, None]
    tree = PartitionTree(perm_new, factors.tree.directions,
                         factors.tree.thresholds)
    factors_new = HCKFactors(
        x_sorted_new, tree, factors.landmarks, factors.sigma,
        factors.sigma_cho, factors.w, u_new, adiag_new, factors.rank_mask)
    return factors_new, y_sorted_new, InsertRecord(k, n0, counts_np, real)


def downdate(factors: HCKFactors, k: int) -> HCKFactors:
    """Remove the last ``k`` appended rows of every leaf: an exact
    truncation, so ``downdate(insert(f), k)`` equals ``f`` bit for bit."""
    if k == 0:
        return factors
    n0 = factors.leaf_size - k
    if n0 < 1:
        raise ValueError(f"cannot remove {k} rows from leaves of size "
                         f"{factors.leaf_size}")
    p_leaves, d = factors.num_leaves, factors.x_sorted.shape[1]
    x_sorted = factors.x_sorted.reshape(p_leaves, -1, d)[:, :n0].reshape(-1, d)
    perm = factors.tree.perm.reshape(p_leaves, -1)[:, :n0].reshape(-1)
    tree = PartitionTree(perm, factors.tree.directions,
                         factors.tree.thresholds)
    return HCKFactors(
        x_sorted, tree, factors.landmarks, factors.sigma, factors.sigma_cho,
        factors.w, factors.u[:, :n0].contiguous(),
        factors.adiag[:, :n0, :n0].contiguous(), factors.rank_mask)


def refit_frozen(factors: HCKFactors, kernel: BaseKernel,
                 config: SolveConfig | None = None, *,
                 jitter_rows: int | None = None) -> HCKFactors:
    """From-scratch leaf stages on the SAME frozen hierarchy (the oracle of
    :func:`insert`).

    Recomputes ``adiag`` and ``u`` from ``x_sorted`` with the tree,
    landmarks, Sigma and W frozen (one ``build_gram`` and one
    ``build_cross`` launch at leaf granularity), with the kernel's jitter
    rescaled so that the leaf diagonal carries ``kernel.jitter *
    jitter_rows`` whatever the current leaf size (default: the current
    leaf size, a fresh build's convention).
    """
    config = config if config is not None else DEFAULT_CONFIG
    n0, p_leaves = factors.leaf_size, factors.num_leaves
    jitter_rows = n0 if jitter_rows is None else jitter_rows
    ker = dataclasses.replace(kernel,
                              jitter=kernel.jitter * jitter_rows / n0)
    leaves = factors.x_sorted.reshape(p_leaves, n0, -1)
    adiag, u = leaf_stage_factors(
        leaves, _rep2(factors.landmarks[-1]),
        _rep2(sigma_linv(factors.sigma_cho[-1])), ker, config)
    if factors.rank_mask is not None:
        u = u * _rep2(factors.rank_mask[-1])[:, None, :]
    return HCKFactors(
        factors.x_sorted, factors.tree, factors.landmarks, factors.sigma,
        factors.sigma_cho, factors.w, u.to(factors.u.dtype),
        adiag.to(factors.adiag.dtype), factors.rank_mask)
