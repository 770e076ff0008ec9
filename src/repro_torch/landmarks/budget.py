"""Budgeted adaptive per-node rank (counterpart of
``repro.landmarks.budget``).

A global rank budget N is split across ALL nodes of ALL levels in
proportion to each node's spectral mass, estimated from the r x r landmark
Gram the build already has: the stable rank ``(tr G)^2 / ||G||_F^2``.  A
node whose landmarks are highly correlated has a small stable rank and
gets few slots; a node covering spread-out geometry keeps more.

Ragged ranks are PREFIX MASKS over the common pad bucket ``r_max``: every
factor keeps its (.., r_max, ..) shape, the active slots are a prefix, and
masked slots are identity-padded (Sigma, its Cholesky factor, Linv:
diagonal 1, off-diagonal 0) or zeroed (U columns, W rows and columns).
``chol([[A, 0], [0, I]]) = [[chol A, 0], [0, I]]`` and block-triangular
inversion keeps the split, so the masked factors are exactly those of the
truncated-rank model and every engine downstream takes them unchanged.

Allocation: ``sum_nodes r_node <= N`` exactly (floor-only rounding), every
rank in ``[r_min, r_max]``, extras snapped DOWN to multiples of ``snap``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def node_mass(gram: Tensor) -> Tensor:
    """Spectral mass per node: (B, r, r) SPD blocks -> (B,) stable rank
    ``(tr G)^2 / ||G||_F^2`` in [1, r]."""
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
    fro2 = torch.sum(gram * gram, dim=(-2, -1))
    return (tr * tr) / torch.clamp(fro2, min=torch.finfo(gram.dtype).tiny)


def allocate_ranks(masses: Tensor, budget: int, r_max: int, *,
                   r_min: int = 8, snap: int = 8) -> Tensor:
    """Split a global rank budget across nodes in proportion to mass.

    (M,) masses -> (M,) int32 ranks with ``sum <= budget``: every node
    gets the floor ``r_min`` (clamped to ``budget // M`` when the budget is
    tight), the rest of the pool is shared in proportion, and each node's
    extra is floored to a multiple of ``snap``, so the rounding never
    overshoots.  ``budget`` must give at least one slot per node.
    """
    m_nodes = masses.shape[0]
    if budget < m_nodes:
        raise ValueError(f"rank budget {budget} below one landmark per node "
                         f"({m_nodes} nodes)")
    tiny = torch.finfo(masses.dtype).tiny
    r_lo = max(1, min(r_min, r_max, budget // m_nodes))
    pool = budget - r_lo * m_nodes
    share = budget * masses / torch.clamp(torch.sum(masses), min=tiny)
    raw = torch.clamp(share - r_lo, min=0.0)
    scale = torch.clamp(pool / torch.clamp(torch.sum(raw), min=tiny), max=1.0)
    extra = (torch.floor(raw * scale / snap) * snap).to(torch.int32)
    return torch.clamp(r_lo + extra, max=r_max).to(torch.int32)


def allocate_rank_masks(grams, budget: int, r_max: int, *, r_min: int = 8,
                        snap: int = 8, dtype=None) -> tuple:
    """Per-level prefix masks from the per-level landmark Gram stacks.

    ``grams``: sequence of (2**l, r_max, r_max) stacks for levels 0..L-1
    -> tuple of (2**l, r_max) masks (``dtype``, default the Grams'), the
    active slots a prefix of length r_node.  The budget holds globally:
    the masks of all levels sum to at most ``budget``.
    """
    grams = list(grams)
    sizes = [g.shape[0] for g in grams]
    masses = torch.cat([node_mass(g) for g in grams])
    ranks = allocate_ranks(masses, budget, r_max, r_min=r_min, snap=snap)
    dt = dtype if dtype is not None else grams[0].dtype
    slots = torch.arange(r_max, device=masses.device)
    masks, off = [], 0
    for b in sizes:
        masks.append((slots[None, :] < ranks[off:off + b, None]).to(dt))
        off += b
    return tuple(masks)


def masked_identity_pad(a: Tensor, mask: Tensor) -> Tensor:
    """``M A M + diag(1 - mask)`` for (B, r, r) factors and (B, r) masks:
    the active block kept, the masked diagonal set to 1, every entry that
    touches a masked slot zeroed.  For a PREFIX mask the padded Sigma,
    Cholesky factor and Linv are exactly those of the padded Gram."""
    m2 = mask[:, :, None] * mask[:, None, :]
    r = a.shape[-1]
    dpad = torch.eye(r, dtype=a.dtype, device=a.device) * (1.0 - mask)[:, None, :]
    return a * m2 + dpad
