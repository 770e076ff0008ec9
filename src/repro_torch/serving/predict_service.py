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

:class:`ModelRegistry` stacks a versioned hot-swap layer on top: each
published model gets an immutable (model, engine, version) entry, a
request reads one snapshot reference, and ``publish`` / ``rollback``
re-point it, so an online update (``krr.fit_incremental``) is built,
warmed and swapped in under a live request stream, and a bad version is
rolled back to the bitwise-identical stored entry.  A canary batch gates
every publish.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch.core import oos
from repro_torch.core.hck import HCKFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels.registry import SolveConfig
from repro_torch.precision import entry_point
from repro_torch.runtime import health

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
    ``config`` selects the ``oos_local`` / ``oos_walk`` backends and the
    precision policy: the model's stacks are cast to the policy's dtypes
    once, when the engine is built (:func:`repro_torch.core.oos.
    policy_stacks`), so a batch casts only its queries.
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
        self._stacks = (oos.policy_stacks(self.factors, self.plan,
                                          self.config)
                        if self.factors.levels > 0 else None)
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
        result.  Malformed batches raise ``ValueError``; with health checks
        on (``SolveConfig.checks`` / ``REPRO_STRICT_FINITE``) non-finite
        predictions raise ``NumericalFailure``."""
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
                           self.config, stacks=self._stacks)[:q]
        health.probe_predictions(z, self.config)
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
    def last_audit(self):
        """The :class:`repro_torch.runtime.recover.RecoveryAudit` of the
        last ``update_and_publish`` that committed (None when it was not
        guarded)."""
        return self._last_audit

    @property
    def stats(self) -> dict:
        """Serving counters (calls, queries, pad waste, bucket hits)."""
        return {
            "calls": self._calls,
            "queries": self._queries,
            "padded_queries": self._padded,
            "bucket_hits": dict(sorted(self._bucket_hits.items())),
        }


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One immutable registry entry: a model, its engine, its number.

    Entries are never mutated after publish: rolling back re-points
    serving at the same engine over the same factor tensors, so its
    predictions are bitwise what that version served before the swap.
    """

    version: int
    model: object               # the fitted model (HCKRegressor-like)
    engine: object              # PredictEngine
    tag: str = ""
    published_at: float = 0.0


class ModelRegistry:
    """Versioned hot-swap serving over the bucketed prediction engine.

    Every request reads the live :class:`ModelVersion` through one
    reference load and serves the whole batch from it; :meth:`publish` and
    :meth:`rollback` replace that reference with one store (atomic under
    the interpreter), so a request concurrent with a swap sees the old
    version or the new one, never a mix, and never waits: the incoming
    engine is built and warmed before the store.  The lock serializes the
    writers (publish, rollback, retire), not the readers.

    ``canary`` (held-back queries) arms the publish gate: the incoming
    engine serves the canary before the swap, which must be finite and,
    when a version is live, within ``canary_tol`` relative drift of the
    live version's answers.  A failing canary leaves the registry as it
    was (the swap never happens), counts the reject in ``stats`` and
    raises :class:`~repro_torch.runtime.health.NumericalFailure`.

    ``engine_kwargs`` go to every :class:`PredictEngine` (``min_bucket``,
    ``max_bucket``).  ``mesh`` (distributed serving) comes with ROADMAP
    item A14.
    """

    def __init__(self, model=None, *, tag: str = "", mesh=None,
                 warmup: bool = False, canary: Tensor | None = None,
                 canary_tol: float = 1e-3, **engine_kwargs):
        if mesh is not None:
            raise NotImplementedError(
                "a registry over a mesh (MeshPredictEngine) comes with the "
                "distributed port, ROADMAP item A14")
        self._lock = threading.Lock()
        self._versions: dict[int, ModelVersion] = {}
        self._live: ModelVersion | None = None
        self._next = 1
        self._engine_kwargs = dict(engine_kwargs)
        self._swaps = 0
        self._canary = canary
        self._canary_tol = canary_tol
        self._canary_rejects = 0
        self._last_reject: dict | None = None
        self._last_audit = None
        if model is not None:
            self.publish(model, tag=tag, warmup=warmup)

    # -- writers ----------------------------------------------------------
    def _canary_gate(self, engine, canary, tol: float) -> None:
        """Validate the incoming engine on held-back queries before the
        swap; raise NumericalFailure (and count the reject) on a
        non-finite or drifted answer."""
        if canary is None:
            return
        try:
            try:
                z_new = engine(canary)
            except health.NumericalFailure as e:
                # the engine's own probe tripped first: the gate's reject
                raise health.NumericalFailure(
                    "serving.canary", statistic=e.statistic, value=e.value,
                    leaf=e.leaf, node=e.node, dtype=e.dtype,
                    backend=e.backend,
                    detail=f"incoming engine failed the canary probe: "
                           f"{e.detail}") from e
            health.probe_predictions(z_new, force=True,
                                     stage="serving.canary")
            live = self._live
            if live is not None:
                z_old = live.engine(canary)
                scale = float(torch.linalg.vector_norm(z_old)) or 1.0
                drift = float(torch.linalg.vector_norm(z_new - z_old)) / scale
                if not drift <= tol:        # NaN drift rejects too
                    raise health.NumericalFailure(
                        "serving.canary", statistic="canary_drift",
                        value=drift, dtype=z_new.dtype,
                        detail=f"vs live version {live.version} "
                               f"(tol={tol:g})")
        except health.NumericalFailure as e:
            self._canary_rejects += 1
            self._last_reject = e.to_dict()
            raise

    def publish(self, model, *, tag: str = "", warmup: bool = False,
                canary: Tensor | None = None,
                canary_tol: float | None = None) -> int:
        """Register ``model`` and make it the live version.

        The engine is built (and with ``warmup`` run once per shape
        bucket, which on the card builds and loads the kernels, so a
        library that fails to build fails here) and passes the canary gate
        before the swap, which is one reference store.  ``canary`` /
        ``canary_tol`` override the registry's gate for this publish.
        Returns the new version number.
        """
        engine = PredictEngine(model.factors, model.plan, model.kernel,
                               config=model.solve_config,
                               **self._engine_kwargs)
        if warmup:
            engine.warmup()
        self._canary_gate(engine,
                          canary if canary is not None else self._canary,
                          canary_tol if canary_tol is not None
                          else self._canary_tol)
        with self._lock:
            v = self._next
            self._next += 1
            entry = ModelVersion(v, model, engine, tag=tag,
                                 published_at=time.monotonic())
            self._versions[v] = entry
            self._live = entry          # one reference store: the swap
            self._swaps += 1
        return v

    def rollback(self, version: int | None = None) -> int:
        """Re-point serving at a stored version (default: the newest one
        that is not live).  The entry is reused as stored, so its
        predictions are bitwise what it served before."""
        with self._lock:
            if not self._versions:
                raise ValueError("registry has no versions")
            if version is None:
                live = self._live.version if self._live else None
                older = [v for v in self._versions if v != live]
                if not older:
                    raise ValueError("no previous version to roll back to")
                version = max(older)
            if version not in self._versions:
                raise KeyError(f"version {version} not in registry "
                               f"(have {sorted(self._versions)})")
            self._live = self._versions[version]
            self._swaps += 1
        return version

    def retire(self, version: int) -> None:
        """Drop a stored version (frees its factors); the live version
        cannot be retired."""
        with self._lock:
            if self._live is not None and self._live.version == version:
                raise ValueError(f"version {version} is live; publish or "
                                 "rollback first")
            self._versions.pop(version)

    def update_and_publish(self, x_new, y_new, *, tag: str = "",
                           warmup: bool = False, guarded: bool = False,
                           **update_kwargs):
        """Online insert and hot swap: ``live.model.update``, then publish.

        The update runs on the live model's immutable state while that
        model keeps serving.  Returns ``(version, info)``, ``info`` the
        :class:`repro_torch.core.krr.UpdateInfo` (its ``needs_rebuild``
        is the cue for a full refit).  Transactional: nothing in the
        registry changes until the gated publish commits, so a failure
        anywhere leaves the live version, the version list and every
        engine as they were.  ``guarded=True`` runs the update through
        :func:`repro_torch.runtime.recover.update_guarded`.
        """
        entry = self._live
        if entry is None:
            raise ValueError("registry has no live model to update")
        if guarded:
            from repro_torch.runtime.recover import update_guarded

            model_new, info, audit = update_guarded(
                entry.model, x_new, y_new, **update_kwargs)
        else:
            model_new, info = entry.model.update(x_new, y_new,
                                                 **update_kwargs)
            audit = None
        version = self.publish(model_new, tag=tag, warmup=warmup)
        self._last_audit = audit
        return version, info

    # -- readers (lock-free) ----------------------------------------------
    def predict(self, queries: Tensor) -> tuple[Tensor, int]:
        """Serve one batch from the live version: ``(z, version)``."""
        entry = self._live
        if entry is None:
            raise ValueError("registry has no live model")
        return entry.engine(queries), entry.version

    __call__ = predict

    @property
    def live_version(self) -> int | None:
        """Version number serving now (None before the first publish)."""
        entry = self._live
        return entry.version if entry is not None else None

    @property
    def live(self) -> ModelVersion | None:
        """The live entry."""
        return self._live

    def versions(self) -> list[int]:
        """Stored version numbers, ascending."""
        with self._lock:
            return sorted(self._versions)

    def get(self, version: int) -> ModelVersion:
        """Stored entry by number (KeyError if retired or unknown)."""
        return self._versions[version]

    @property
    def last_audit(self):
        """The :class:`repro_torch.runtime.recover.RecoveryAudit` of the
        last ``update_and_publish`` that committed (None when it was not
        guarded)."""
        return self._last_audit

    @property
    def stats(self) -> dict:
        """Registry counters: live version, stored versions, swaps, canary
        rejects and the last reject's diagnostics."""
        return {
            "live_version": self.live_version,
            "versions": self.versions(),
            "swaps": self._swaps,
            "canary_rejects": self._canary_rejects,
            "last_reject": self._last_reject,
        }
