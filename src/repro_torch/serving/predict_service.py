"""Shape-bucketed Algorithm-3 prediction service
(counterpart of ``repro.serving.predict_service``).

:class:`PredictEngine` pads every query batch up to a power-of-two shape
bucket (edge-replicated rows, sliced off again) and micro-batches anything
above ``max_bucket``, so the stage launches see at most
``log2(max_bucket / min_bucket) + 1`` batch shapes:

  * ``apply(queries)`` / ``__call__`` -- synchronous prediction;
  * ``warmup()`` -- runs every bucket once ahead of traffic (on the card
    this builds and loads the kernels);
  * ``stats`` -- calls, queries served, pad waste, per-bucket hit counts.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import oos
from repro_torch.core.hck import HCKFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels.registry import SolveConfig
from repro_torch.precision import entry_point

Tensor = torch.Tensor


def bucket_size(q: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two bucket >= q (floored at min_bucket, capped at
    max_bucket; q above the cap is the caller's micro-batching problem)."""
    if q < 1:
        raise ValueError(f"bucket_size needs q >= 1, got {q}")
    b = min_bucket
    while b < q:
        b <<= 1
    return min(b, max_bucket)


def validate_queries(queries: Tensor, x_sorted: Tensor) -> None:
    """Reject malformed query batches before any stage launch: (q, d) with
    the training feature dim, dtype and device."""
    if getattr(queries, "ndim", None) != 2:
        raise ValueError(
            f"queries must be a 2-D (q, d) batch, got shape "
            f"{tuple(getattr(queries, 'shape', ()))}")
    d = x_sorted.shape[1]
    if queries.shape[1] == 0:
        raise ValueError(
            f"queries have 0 features; the model was trained with d={d}")
    if queries.shape[1] != d:
        raise ValueError(
            f"query feature dim {queries.shape[1]} != training dim {d}")
    if queries.dtype != x_sorted.dtype:
        raise ValueError(
            f"query dtype {queries.dtype} != training dtype {x_sorted.dtype}; "
            f"cast the batch")
    if queries.device != x_sorted.device:
        raise ValueError(
            f"queries on {queries.device}, model on {x_sorted.device}")


@dataclasses.dataclass
class PredictEngine:
    """Bucketed Algorithm-3 inference over one prepared plan.

    ``apply`` maps (q, d) batches to (q, k), padding q up to a power-of-two
    bucket in [min_bucket, max_bucket] and micro-batching beyond it.
    ``config`` selects the ``oos_local`` / ``oos_walk`` backends.
    """

    factors: HCKFactors
    plan: oos.OOSPlan
    kernel: BaseKernel
    config: SolveConfig | None = None
    min_bucket: int = 64
    max_bucket: int = 4096

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"bad bucket range [{self.min_bucket}, {self.max_bucket}]")
        self._bucket_hits: dict[int, int] = {}
        self._calls = 0
        self._queries = 0
        self._padded = 0

    @classmethod
    def from_weights(cls, factors: HCKFactors, w: Tensor, kernel: BaseKernel,
                     *, config: SolveConfig | None = None,
                     **kwargs) -> "PredictEngine":
        """Build the phase-1 plan for ``w`` (tree order) and wrap it."""
        return cls(factors, oos.prepare(factors, w, config), kernel,
                   config=config, **kwargs)

    @classmethod
    def attach(cls, model, *, weights: Tensor | None = None,
               **kwargs) -> "PredictEngine":
        """Build-or-return the engine cached on ``model._engine`` (factors,
        kernel and solve_config are read off the model; ``weights`` goes
        through :meth:`from_weights` instead of the model's plan)."""
        if model._engine is None:
            if weights is None:
                model._engine = cls(model.factors, model.plan, model.kernel,
                                    config=model.solve_config, **kwargs)
            else:
                model._engine = cls.from_weights(
                    model.factors, weights, model.kernel,
                    config=model.solve_config, **kwargs)
        return model._engine

    @entry_point
    def apply(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q, k).  Pads to the shape bucket with copies of the
        last row (they route like real queries and are sliced off) and
        micro-batches beyond ``max_bucket``; an empty batch gives an empty
        result.  Malformed batches raise ``ValueError``."""
        validate_queries(queries, self.factors.x_sorted)
        q = queries.shape[0]
        if q == 0:
            w = self.plan.w_leaf
            return torch.zeros((0, w.shape[-1]), dtype=w.dtype,
                               device=w.device)
        if q > self.max_bucket:
            return torch.cat([self.apply(queries[i:i + self.max_bucket])
                              for i in range(0, q, self.max_bucket)], dim=0)
        b = bucket_size(q, self.min_bucket, self.max_bucket)
        padded = torch.cat([queries, queries[-1:].expand(b - q, -1)], dim=0)
        z = oos.apply_plan(self.factors, self.plan, padded, self.kernel,
                           self.config)[:q]
        self._calls += 1
        self._queries += q
        self._padded += b - q
        self._bucket_hits[b] = self._bucket_hits.get(b, 0) + 1
        return z

    __call__ = apply

    def warmup(self) -> list[int]:
        """Run every bucket once ahead of traffic; returns the bucket sizes."""
        x = self.factors.x_sorted
        buckets, b = [], self.min_bucket
        while b <= self.max_bucket:
            buckets.append(b)
            b <<= 1
        dummy = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        for b in buckets:
            self.apply(dummy.expand(b, -1))
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return buckets

    @property
    def stats(self) -> dict:
        """Serving counters (calls, queries, pad waste, bucket hits)."""
        return {
            "calls": self._calls,
            "queries": self._queries,
            "padded_queries": self._padded,
            "bucket_hits": dict(sorted(self._bucket_hits.items())),
        }
