"""Landmark-selection policies (counterpart of ``repro.landmarks.policy``):
Randomized Clustered Nystrom and ridge-leverage sampling, per node of the
hierarchy.

Every policy maps node blocks (B, m, d) and a rank r to per-node landmark
ROW INDICES (B, r): indices, not points, so every policy is gathered the
same way (:func:`gather_block_rows`).  Contract, as in the reference:

  * a policy never touches the partition: the tree is drawn first, so all
    policies share one hierarchy;
  * ``uniform`` is the plain build's draw (the same indices);
  * selection does not depend on sigma: the inner loops read only the
    bandwidth-independent distances of the ``policy_dist`` registry stage
    (B12 on the card), so a policy-drawn sweep plan serves a whole sigma
    grid;
  * every policy returns DISTINCT indices per node (k-means dedupes, the
    leverage draw is a Gumbel top-k), so the landmark Gram stays strictly
    positive definite.

Randomness does not cross frameworks, so each policy's random draws are a
dict of tensors that :meth:`draws` makes from a ``torch.Generator`` and
that a caller may pass in instead (the parity tests pass the reference's):
``uniform`` and ``kmeans`` take ``{"index": (B, r)}`` (k-means starts from
the uniform draw), ``leverage`` takes ``{"pilot_index": (B, p), "gumbel":
(B, m)}``.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.kernels.registry import (DEFAULT_CONFIG, SolveConfig,
                                          get_impl, resolve_backend)

Tensor = torch.Tensor


def stage_policy_dist(blocks: Tensor, centers: Tensor, metric: str,
                      config: SolveConfig | None) -> Tensor:
    """One batched policy-distance tile through the registry: (B, m, d),
    (B, r, d) -> (B, m, r) squared-L2 ("l2") or L1 ("l1") distances."""
    blocks, centers = blocks.contiguous(), centers.contiguous()
    backend = resolve_backend(config or DEFAULT_CONFIG, "policy_dist",
                              blocks, centers)
    return get_impl("policy_dist", backend)(blocks, centers, metric=metric)


def gather_block_rows(blocks: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` (B, r) of each node block (B, m, d) -> (B, r, d), by one
    flat take, as every policy's landmarks are gathered."""
    bsz, m, d = blocks.shape
    idx = idx.to(device=blocks.device, dtype=torch.int64)
    flat = idx + torch.arange(bsz, device=blocks.device)[:, None] * m
    return blocks.reshape(bsz * m, d)[flat.reshape(-1)].reshape(
        bsz, idx.shape[1], d)


def _dedupe_indices(idx: Tensor, m: int) -> Tensor:
    """Make each node's index row distinct: a slot whose index an earlier
    slot of its node already took falls back to the node's first unused
    row (the reference's first-free-slot scan), so the result is r
    distinct indices.  (B, r) -> (B, r) int64; a loop over the r slots,
    batched over the nodes."""
    bsz, r = idx.shape
    rows = torch.arange(bsz, device=idx.device)
    used = torch.zeros((bsz, m), dtype=torch.int32, device=idx.device)
    out = torch.empty((bsz, r), dtype=torch.int64, device=idx.device)
    for j in range(r):
        cand = idx[:, j].to(torch.int64)
        fallback = torch.argmin(used, dim=1)           # first unused row
        pick = torch.where(used[rows, cand] > 0, fallback, cand)
        used[rows, pick] = 1
        out[:, j] = pick
    return out


def _median(v: Tensor) -> Tensor:
    """Median over the last axis, the two middle values averaged for an
    even count: ``(lo + hi) * 0.5`` of the sorted values, as ``jnp.median``
    computes it (``torch.median`` would return the lower one)."""
    s = torch.sort(v, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


@runtime_checkable
class LandmarkPolicy(Protocol):
    """Per-node landmark selection."""

    name: str

    def draws(self, bsz: int, m: int, r: int, *, dtype, device,
              generator: torch.Generator | None = None) -> dict:
        """The policy's random draws for B nodes of m rows."""
        ...

    def select(self, blocks: Tensor, r: int, *, draws: dict,
               metric: str = "l2",
               config: SolveConfig | None = None) -> Tensor:
        """(B, m, d) node blocks -> (B, r) distinct row indices."""
        ...


@dataclasses.dataclass(frozen=True)
class UniformPolicy:
    """Uniform per-node subsample (paper section 4.2), the plain build's
    landmarks."""

    name: str = "uniform"

    def draws(self, bsz: int, m: int, r: int, *, dtype, device,
              generator: torch.Generator | None = None) -> dict:
        """``{"index": (B, r)}``: one uniform permutation prefix per node."""
        from repro_torch.core.hck import landmark_indices

        del dtype
        return {"index": landmark_indices(bsz, m, r, device=device,
                                          generator=generator)}

    def select(self, blocks: Tensor, r: int, *, draws: dict,
               metric: str = "l2",
               config: SolveConfig | None = None) -> Tensor:
        """The drawn indices themselves."""
        del blocks, r, metric, config
        return draws["index"]


@dataclasses.dataclass(frozen=True)
class KMeansPolicy:
    """Clustered landmarks (Randomized Clustered Nystrom,
    arXiv:1612.06470): the uniform draw as the start, ``iters`` Lloyd
    rounds with assignments from the batched ``policy_dist`` tiles, then a
    medoid snap (the nearest block row per center, so landmarks are data
    points), deduped to distinct rows.  ``iters + 1`` ``policy_dist``
    launches per level."""

    iters: int = 8
    name: str = "kmeans"

    def draws(self, bsz: int, m: int, r: int, *, dtype, device,
              generator: torch.Generator | None = None) -> dict:
        """``{"index": (B, r)}``: the uniform start."""
        return UniformPolicy().draws(bsz, m, r, dtype=dtype, device=device,
                                     generator=generator)

    def select(self, blocks: Tensor, r: int, *, draws: dict,
               metric: str = "l2",
               config: SolveConfig | None = None) -> Tensor:
        """Lloyd rounds and the medoid snap: (B, r) distinct indices."""
        bsz, m, _ = blocks.shape
        centers = gather_block_rows(blocks, draws["index"])
        for _ in range(self.iters):
            dist = stage_policy_dist(blocks, centers, metric, config)
            assign = torch.argmin(dist, dim=-1)                  # (B, m)
            onehot = torch.zeros((bsz, m, r), dtype=blocks.dtype,
                                 device=blocks.device)
            onehot.scatter_(2, assign[..., None], 1.0)
            counts = torch.sum(onehot, dim=1)                    # (B, r)
            sums = torch.einsum("bmr,bmd->brd", onehot, blocks)
            newc = sums / torch.clamp(counts, min=1.0)[..., None]
            # an empty cluster keeps its previous center
            centers = torch.where(counts[..., None] > 0, newc, centers)
            del dist, onehot
        dist = stage_policy_dist(blocks, centers, metric, config)
        medoid = torch.argmin(dist, dim=1)                       # (B, r)
        return _dedupe_indices(medoid, m)


@dataclasses.dataclass(frozen=True)
class LeveragePolicy:
    """Ridge-leverage-score sampling, one level of recursion per node.

    A uniform pilot of ``pilot_mult * r`` rows anchors a Nystrom
    surrogate; per-point scores ``l_i = k_i^T (K_pp + ridge p I)^-1 k_i``
    come from two ``policy_dist`` tiles under a sigma-independent
    surrogate kernel (per-node median pilot distance as the bandwidth),
    and ``r`` landmarks are drawn without replacement by a Gumbel top-k on
    the log scores, distinct by construction.  Two ``policy_dist``
    launches per level.
    """

    pilot_mult: int = 2
    ridge: float = 1e-6
    name: str = "leverage"

    def draws(self, bsz: int, m: int, r: int, *, dtype, device,
              generator: torch.Generator | None = None) -> dict:
        """``{"pilot_index": (B, p), "gumbel": (B, m)}``: the uniform
        pilot and standard Gumbel noise."""
        from repro_torch.core.hck import landmark_indices

        p = min(self.pilot_mult * r, m)
        pilot = landmark_indices(bsz, m, p, device=device,
                                 generator=generator)
        u = torch.rand((bsz, m), dtype=dtype, device=device,
                       generator=generator)
        tiny = torch.finfo(dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        return {"pilot_index": pilot, "gumbel": gumbel}

    def select(self, blocks: Tensor, r: int, *, draws: dict,
               metric: str = "l2",
               config: SolveConfig | None = None) -> Tensor:
        """Pilot -> ridge-leverage scores -> Gumbel top-k: (B, r)."""
        bsz, m, _ = blocks.shape
        pilot = gather_block_rows(blocks, draws["pilot_index"])
        p = pilot.shape[1]
        d_pp = stage_policy_dist(pilot, pilot, metric, config)   # (B, p, p)
        d_mp = stage_policy_dist(blocks, pilot, metric, config)  # (B, m, p)
        # sigma-independent surrogate bandwidth: median pilot distance
        med = torch.clamp(_median(d_pp.reshape(bsz, -1)), min=1e-12)
        scale = (2.0 if metric == "l2" else 1.0) * med[:, None, None]
        kpp = torch.exp(-d_pp / scale)
        kpp = kpp + (self.ridge * p) * torch.eye(p, dtype=kpp.dtype,
                                                 device=kpp.device)
        kmp = torch.exp(-d_mp / scale)
        del d_pp, d_mp
        cho = torch.linalg.cholesky(kpp)
        sol = torch.cholesky_solve(kmp.mT, cho, upper=False).mT  # (B, m, p)
        scores = torch.clamp(torch.sum(kmp * sol, dim=-1), min=1e-12)
        gumbel = draws["gumbel"].to(device=scores.device, dtype=scores.dtype)
        return torch.topk(torch.log(scores) + gumbel, r, dim=-1).indices


_POLICIES = {"uniform": UniformPolicy, "kmeans": KMeansPolicy,
             "leverage": LeveragePolicy}


def get_policy(spec) -> LandmarkPolicy:
    """None / "uniform" / "kmeans" / "leverage", or a ready
    :class:`LandmarkPolicy` instance (returned as it is)."""
    if spec is None:
        return UniformPolicy()
    if isinstance(spec, str):
        if spec not in _POLICIES:
            raise ValueError(f"unknown landmark policy {spec!r}; have "
                             f"{sorted(_POLICIES)}")
        return _POLICIES[spec]()
    return spec


def select_indices(policy, blocks: Tensor, r: int, metric: str = "l2",
                   config: SolveConfig | None = None, *,
                   draws: dict | None = None,
                   generator: torch.Generator | None = None) -> Tensor:
    """One level's landmark selection: (B, m, d) -> (B, r) indices, from
    ``draws`` or, without them, the policy's draws from ``generator``."""
    policy = get_policy(policy)
    if draws is None:
        bsz, m, _ = blocks.shape
        draws = policy.draws(bsz, m, r, dtype=blocks.dtype,
                             device=blocks.device, generator=generator)
    return policy.select(blocks, r, draws=draws, metric=metric,
                         config=config)
