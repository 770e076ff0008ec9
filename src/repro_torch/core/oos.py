"""Out-of-sample extension, Algorithm 3 (counterpart of ``repro.core.oos``).

Computes ``z = w^T k_hck(X, x)`` for a batch of queries without forming
the n-vector ``k_hck(X, x)``:

  phase 1 (:func:`prepare`, once per weight matrix, O(n r)): the
  common-upward pass over ``w`` -- its leaf level is the ``leaf_project``
  stage -- and a downward sweep that pushes the root path into one
  per-leaf coefficient block ``c_tilde`` (2**L, r, k);

  phase 2 (:func:`apply_plan`, per query, O((n0 + r)(d + k))): route x to
  its leaf j, then

      z = w_leaf[j]^T k(X_j, x)  +  c_tilde[j]^T k(Xl_parent(j), x)

  -- the ``oos_local`` and ``oos_walk`` stages, summed in one stage,
  ``oos_local_walk``: one launch of the ``oos_contract`` kernel on the
  card.  Queries are sorted by leaf first, so neighbouring queries read the
  same blocks.

The kernel reads each query's leaf block, leaf weights, parent landmarks
and ``c_tilde`` block in place through the query's leaf index;
:func:`apply_segments` also takes the reference's per-query gathered form.

Under a mixed-precision policy (``SolveConfig.precision``) phase 2 reads
its data (leaf points, landmarks, queries) in the policy's GEMM dtype and
its weights (``w_leaf``, ``c_tilde``) in its factor dtype.
:func:`policy_stacks` casts a model's stacks once; a caller that serves
many batches (the ``PredictEngine``) keeps them and hands them to
:func:`apply_plan`, so that only the queries are cast per batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hck import HCKFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import group_by_leaf, route
from repro_torch.kernels.registry import (DEFAULT_CONFIG, SolveConfig,
                                          get_impl, precision_policy,
                                          resolve_backend)

Tensor = torch.Tensor


@dataclasses.dataclass
class OOSPlan:
    """Query-independent precomputation (phase 1) for a weight matrix w.

    ``c[l]``     (2**(l+1), r, k) exchange coefficients of the nodes of
                 level l+1 (kept for the parity tests).
    ``w_leaf``   (2**L, n0, k) w in tree order, per leaf.
    ``c_tilde``  (2**L, r, k) pushed-down root-path coefficients with the
                 leaf parent's Sigma^{-1} folded in; None for L = 0.
    """

    c: tuple
    w_leaf: Tensor
    c_tilde: Tensor | None


def _pair_sum(x: Tensor) -> Tensor:
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:]).sum(dim=1)


def _pair_swap(x: Tensor) -> Tensor:
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:]).flip(1).reshape(x.shape)


def _rep2(x: Tensor) -> Tensor:
    return torch.repeat_interleave(x, 2, dim=0)


def prepare(f: HCKFactors, w: Tensor,
            config: SolveConfig | None = None) -> OOSPlan:
    """Phase 1: common-upward pass over w (tree order, (n,) or (n, k)) plus
    the downward root-path pushdown, O(n r).  The leaf projection U^T w is
    the ``leaf_project`` stage."""
    config = config if config is not None else DEFAULT_CONFIG
    if w.ndim == 1:
        w = w[:, None]
    levels, n0, k = f.levels, f.leaf_size, w.shape[1]
    wl = w.reshape(f.num_leaves, n0, k).contiguous()
    if levels == 0:
        return OOSPlan((), wl, None)
    u = f.u.to(wl.dtype).contiguous()
    backend = resolve_backend(config, "leaf_project", u, wl)
    e = {levels: get_impl("leaf_project", backend)(u, wl)}
    for lvl in range(levels - 1, 0, -1):
        e[lvl] = torch.einsum("pab,pak->pbk", f.w[lvl - 1],
                              _pair_sum(e[lvl + 1]))
    # c_l = Sigma_p^T e_sibling for every node of level l (Sigma symmetric)
    c = tuple(
        torch.einsum("qba,qbk->qak", _rep2(f.sigma[lvl - 1]),
                     _pair_swap(e[lvl]))
        for lvl in range(1, levels + 1))
    # h_l[node] = c_l[node] + W_{l-1}[parent] h_{l-1}[parent]; at the leaves
    # c_tilde^T d reproduces the whole walk-up accumulation of Algorithm 3
    h = c[0]
    for lvl in range(1, levels):
        h = c[lvl] + torch.einsum("pab,pbk->pak", _rep2(f.w[lvl - 1]),
                                  _rep2(h))
    # fold the leaf parent's Sigma^{-1} (Sigma SPD: h^T S^-1 kx = (S^-1 h)^T kx)
    c_tilde = torch.cholesky_solve(h, _rep2(f.sigma_cho[levels - 1]),
                                   upper=False)
    return OOSPlan(c, wl, c_tilde.to(wl.dtype).contiguous())


def apply_segments(
    xl: Tensor, wl: Tensor, lm: Tensor, ct: Tensor, qs: Tensor,
    kernel: BaseKernel, config: SolveConfig | None = None, *,
    leaf: Tensor | None = None,
) -> Tensor:
    """Phase 2's two terms, the exact-local term plus the walk term, in one
    stage (``oos_local_walk``: one kernel launch on the card).

    Without ``leaf`` the blocks are the reference's per-query gathered
    form: ``xl`` (q, n0, d) / ``wl`` (q, n0, k) each query's leaf points
    and weights, ``lm`` (q, r, d) / ``ct`` (q, r, k) its parent landmarks
    and pushed-down coefficients.  With ``leaf`` (q,) the blocks are the
    model's own stacks -- ``xl`` (2**L, n0, d), ``wl`` (2**L, n0, k),
    ``lm`` (2**(L-1), r, d), ``ct`` (2**L, r, k) -- read in place at the
    query's leaf (and its parent, ``leaf >> 1``).  Returns (q, k).
    """
    config = config if config is not None else DEFAULT_CONFIG
    pol = precision_policy(config)
    if pol is not None:
        # data in the GEMM dtype, weights and coefficients (factors) in
        # the factor dtype; a cast to the dtype a tensor has is no copy
        xl, lm, qs = (a.to(pol[0]) for a in (xl, lm, qs))
        wl, ct = wl.to(pol[1]), ct.to(pol[1])
    xl, wl, lm, ct, qs = (a.contiguous() for a in (xl, wl, lm, ct, qs))
    if leaf is None:
        leaf_idx = parent_idx = torch.arange(qs.shape[0], device=qs.device)
    else:
        leaf_idx = leaf.contiguous()
        parent_idx = leaf_idx >> 1
    backend = resolve_backend(config, "oos_local_walk", xl, wl, lm, ct, qs)
    return get_impl("oos_local_walk", backend)(
        xl, wl, lm, ct, qs, leaf_idx, parent_idx, name=kernel.name,
        sigma=kernel.sigma, leaf_block=config.leaf_block)


def policy_stacks(f: HCKFactors, plan: OOSPlan,
                  config: SolveConfig | None = None) -> tuple:
    """The stacks phase 2 reads in place -- leaf points (2**L, n0, d),
    leaf weights, the last level's landmarks and ``c_tilde`` -- in the
    dtypes of ``config``'s policy (data in its GEMM dtype, weights in its
    factor dtype), contiguous; the stored tensors themselves where they
    have those dtypes already."""
    pol = precision_policy(config)
    gemm, fac = (None, None) if pol is None else pol
    xl = f.x_sorted.reshape(f.num_leaves, f.leaf_size, -1)
    stacks = []
    for t, dt in ((xl, gemm), (plan.w_leaf, fac),
                  (f.landmarks[f.levels - 1], gemm), (plan.c_tilde, fac)):
        stacks.append((t if dt is None else t.to(dt)).contiguous())
    return tuple(stacks)


def apply_plan(
    f: HCKFactors, plan: OOSPlan, queries: Tensor, kernel: BaseKernel,
    config: SolveConfig | None = None, *, stacks: tuple | None = None,
) -> Tensor:
    """Phase 2: (q, d) -> (q, k) values of w^T k_hck(X, .).

    Route -> stable sort by leaf -> the two fused contractions -> unsort.
    ``stacks`` is :func:`policy_stacks` of the same model and config,
    computed once by the caller; without it the stacks are cast here.
    """
    levels = f.levels
    if levels == 0:
        kv = kernel.cross(f.x_sorted, queries)              # (n, q)
        return torch.einsum("nk,nq->qk", plan.w_leaf[0], kv)
    if stacks is None:
        stacks = policy_stacks(f, plan, config)
    leaf = route(f.tree, queries)
    order, _, _ = group_by_leaf(leaf, f.num_leaves)
    z = apply_segments(*stacks, queries[order], kernel, config,
                       leaf=leaf[order])
    out = torch.empty_like(z)
    out[order] = z                                        # unsort
    return out


# ---------------------------------------------------------------------------
# Oracle: k_hck(X, x) as an explicit n-vector, from the kernel definition.
# ---------------------------------------------------------------------------

def _effective_bases(f: HCKFactors) -> dict:
    """Query-independent effective bases, level -> list of node bases;
    hoisted so batched oracle evaluation builds them once."""
    levels = f.levels
    ubig = {levels: [f.u[i] for i in range(f.num_leaves)]}
    for l2 in range(levels - 1, 0, -1):
        ubig[l2] = [
            torch.cat([ubig[l2 + 1][2 * p], ubig[l2 + 1][2 * p + 1]], dim=0)
            @ f.w[l2 - 1][p]
            for p in range(1 << l2)]
    return ubig


def oos_vector_reference(f: HCKFactors, query: Tensor, kernel: BaseKernel, *,
                         _ubig: dict | None = None) -> Tensor:
    """k_hck(X, x) as an explicit n-vector in tree order (host-loop oracle)."""
    levels, n0 = f.levels, f.leaf_size
    if levels == 0:
        return kernel.cross(f.x_sorted, query[None])[:, 0]
    leaf = int(route(f.tree, query[None])[0])
    out = torch.zeros((f.n,), dtype=f.x_sorted.dtype, device=f.x_sorted.device)
    sl = slice(leaf * n0, (leaf + 1) * n0)
    out[sl] = kernel.cross(f.x_sorted[sl], query[None])[:, 0]

    node, lvl = leaf >> 1, levels - 1
    phi = kernel.cross(f.landmarks[lvl][node], query[None])        # (r, 1)
    d = torch.cholesky_solve(phi, f.sigma_cho[lvl][node], upper=False)[:, 0]
    ubig = _ubig if _ubig is not None else _effective_bases(f)
    cur_node, cur_lvl = leaf, levels
    while cur_lvl > 0:
        parent, sib = cur_node >> 1, cur_node ^ 1
        block = f.n // (1 << cur_lvl)
        out[sib * block:(sib + 1) * block] = (
            ubig[cur_lvl][sib] @ (f.sigma[cur_lvl - 1][parent] @ d))
        cur_node, cur_lvl = parent, cur_lvl - 1
        if cur_lvl > 0:
            d = f.w[cur_lvl - 1][cur_node].T @ d
    return out


def oos_reference_batch(f: HCKFactors, queries: Tensor,
                        kernel: BaseKernel) -> Tensor:
    """Stacked :func:`oos_vector_reference` rows (q, n), the effective
    bases built once: the oracle of the prediction engine."""
    ubig = _effective_bases(f) if f.levels > 0 else None
    return torch.stack([oos_vector_reference(f, q, kernel, _ubig=ubig)
                        for q in queries])
