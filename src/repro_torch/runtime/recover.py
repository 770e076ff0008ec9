"""Detect-recover ladders around the numerical entry points (counterpart
of ``repro.runtime.recover``).

Every wrapper runs the operation, probes its output with the
:mod:`repro_torch.runtime.health` detectors (forced on: a guarded call
always validates, whatever ``SolveConfig.checks`` says) and, on a
:class:`~repro_torch.runtime.health.NumericalFailure`, climbs a ladder of
more and more expensive repairs, recording every attempt in a
:class:`RecoveryAudit`:

  * :func:`build_guarded`: ``build_hck`` under jitter escalation (x10 a
    rung), then precision promotion;
  * :func:`repair_factors`: a poisoned factor set repaired on its frozen
    hierarchy: the leaf stages recomputed from ``x_sorted``
    (``refit_frozen``), then the middle factors rebuilt from the stored
    landmarks as well;
  * :func:`invert_guarded`: ``invert_with_leaf`` under ridge escalation,
    then precision promotion of every factor at the original ridge, then
    a dtype-preserving ``refit_frozen``;
  * :func:`pcg_guarded`: CG with the stall and divergence detector, then
    a fresh preconditioner, a cold restart (identity preconditioner,
    twice the iterations) and an injectable exact solve;
  * :func:`update_guarded`: ``HCKRegressor.update`` with the requested
    refresh, then from a fresh base inverse, then ``refresh="inverse"``,
    then ``refresh="exact"``.

A ladder that runs dry raises :class:`RecoveryExhausted` with the whole
audit.  Precision promotion climbs the chain bf16 -> f32 -> f64 from
``config.precision`` (``SolveConfig.precision``); with no policy the
chain is empty, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.runtime import health
from repro_torch.runtime.health import NumericalFailure

Tensor = torch.Tensor

#: precision promotion chain (SolveConfig.precision values).
_PROMOTIONS = {"bf16": ("f32", "f64"), "f32": ("f64",), None: (), "f64": ()}


@dataclasses.dataclass
class Attempt:
    """One rung of a ladder: what was tried, whether it held, why not."""

    rung: str
    ok: bool
    failure: dict[str, Any] | None = None
    note: str = ""


@dataclasses.dataclass
class RecoveryAudit:
    """Ordered trail of every attempt one guarded call made."""

    op: str
    attempts: list[Attempt] = dataclasses.field(default_factory=list)

    @property
    def recovered(self) -> bool:
        """True when the op needed (and found) a repair rung."""
        return len(self.attempts) > 1 and self.attempts[-1].ok

    @property
    def ok(self) -> bool:
        """True when the final attempt held (the first one included)."""
        return bool(self.attempts) and self.attempts[-1].ok

    @property
    def rungs(self) -> list[str]:
        """Rung labels in execution order."""
        return [a.rung for a in self.attempts]

    def record(self, rung: str, ok: bool, failure=None, note: str = ""):
        """Append one attempt (``failure`` may be a NumericalFailure)."""
        fd = failure.to_dict() if isinstance(failure, NumericalFailure) else (
            {"error": str(failure)} if failure is not None else None)
        self.attempts.append(Attempt(rung, ok, fd, note))

    def to_dict(self) -> dict[str, Any]:
        """JSON-serializable form."""
        return {"op": self.op, "recovered": self.recovered,
                "attempts": [dataclasses.asdict(a) for a in self.attempts]}


class RecoveryExhausted(RuntimeError):
    """Every rung of a ladder failed; ``audit`` holds the whole trail."""

    def __init__(self, audit: RecoveryAudit, last: Exception):
        self.audit = audit
        self.last = last
        super().__init__(
            f"recovery exhausted for {audit.op!r} after rungs "
            f"{audit.rungs}: {last}")


def _promotions(config) -> tuple:
    """Promotion rungs reachable from ``config.precision``."""
    return _PROMOTIONS.get(getattr(config, "precision", None), ())


def _cast_float(factors, dtype):
    """Copy of HCK ``factors`` with every floating tensor in ``dtype``
    (the tree's permutation and the rank masks' shape untouched)."""
    from repro_torch.core.hck import HCKFactors
    from repro_torch.core.partition import PartitionTree

    def cast(ts):
        return tuple(t.to(dtype) for t in ts)

    f, tr = factors, factors.tree
    return HCKFactors(
        f.x_sorted.to(dtype),
        PartitionTree(tr.perm, cast(tr.directions), cast(tr.thresholds)),
        cast(f.landmarks), cast(f.sigma), cast(f.sigma_cho), cast(f.w),
        f.u.to(dtype), f.adiag.to(dtype),
        None if f.rank_mask is None else cast(f.rank_mask))


def _rebuilt_middle(f, kernel, config):
    """``f`` with Sigma, its Cholesky factor and W rebuilt from its stored
    landmarks under ``config`` (a budgeted model's frozen rank masks
    applied again)."""
    from repro_torch.core.hck import (_apply_rank_masks, _mask_transfer_ops,
                                      _middle_factors, _transfer_ops)

    sigma, sigma_cho, sigma_li = _middle_factors(f.landmarks, kernel, config)
    if f.rank_mask is not None:
        sigma, sigma_cho, sigma_li = _apply_rank_masks(
            f.rank_mask, sigma, sigma_cho, sigma_li)
    w = _transfer_ops(f.landmarks, sigma_li, kernel, config)
    if f.rank_mask is not None:
        w = _mask_transfer_ops(w, f.rank_mask)
    return dataclasses.replace(f, sigma=sigma, sigma_cho=sigma_cho, w=w)


def _rebuild_frozen(factors, kernel, config, base: int):
    """Every factor recomputed at ``config.precision`` on the frozen
    hierarchy: the middle Sigma, its Cholesky factor and W from the stored
    landmarks, then the leaf stages through ``refit_frozen``.

    A refit of the leaves alone is not enough for a promotion: the Schur
    complement subtracts U U^T built against the low-precision Cholesky
    factor of Sigma, whose rounding can over-subtract past Adiag however
    accurately the leaves are recomputed, so the middle factors are
    promoted with them.  A promotion to "f64" casts the whole factor set
    (points and landmarks too) to float64 first.
    """
    from repro_torch.core.update import refit_frozen

    f = factors
    if config.precision == "f64":
        f = _cast_float(f, torch.float64)
    return refit_frozen(_rebuilt_middle(f, kernel, config), kernel, config,
                        jitter_rows=base)


def _default(config):
    from repro_torch.kernels.registry import DEFAULT_CONFIG

    return config if config is not None else DEFAULT_CONFIG


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GuardedBuild:
    """:func:`build_guarded` outcome: the factors, the kernel and config
    that produced them (the kernel may carry an escalated jitter) and the
    audit trail."""

    factors: Any
    kernel: Any
    config: Any
    audit: RecoveryAudit


def build_guarded(x: Tensor, *, kernel, config=None, jitter_rungs: int = 2,
                  **build_kwargs) -> GuardedBuild:
    """``build_hck`` under the jitter-then-precision ladder.

    Attempts: the build as asked; ``jitter_rungs`` rounds of x10 jitter
    (the cheapest definiteness repair); precision promotion at the
    original jitter.  Each factor set is validated by
    :func:`~repro_torch.runtime.health.probe_factors` (forced on).
    ``build_kwargs`` pass through to ``build_hck`` (``levels``, ``rank``,
    ``directions``, ``landmark_index``, ``generator``, ...).
    """
    from repro_torch.core.hck import build_hck

    config = _default(config)
    audit = RecoveryAudit("build_hck")
    plans = [("initial", kernel, config)]
    for i in range(1, jitter_rungs + 1):
        k = dataclasses.replace(kernel, jitter=kernel.jitter * 10.0 ** i)
        plans.append((f"jitter x{10 ** i:g}", k, config))
    for p in _promotions(config):
        plans.append((f"promote:{p}", kernel,
                      dataclasses.replace(config, precision=p)))

    last: Exception | None = None
    for rung, ker, cfg in plans:
        try:
            factors = build_hck(x, kernel=ker, config=cfg, **build_kwargs)
            health.probe_factors(factors, cfg, force=True, op="build")
        except NumericalFailure as e:
            audit.record(rung, False, e)
            last = e
            continue
        audit.record(rung, True, note=f"jitter={ker.jitter:g} "
                                      f"precision={cfg.precision}")
        return GuardedBuild(factors, ker, cfg, audit)
    raise RecoveryExhausted(audit, last)


def repair_factors(factors, kernel, config=None, *,
                   base_leaf_size: int | None = None):
    """Repair a poisoned factor set on its frozen hierarchy.

    Rungs: probe as it is (clean factors come back untouched); per-leaf
    ``refit_frozen`` (``adiag`` and ``u`` recomputed from ``x_sorted``);
    the middle factors (Sigma, its Cholesky factor, W) rebuilt from the
    stored landmarks, then the leaf refit.  Every input of every rung is
    data the poison cannot reach (points and landmarks).  Returns
    ``(factors, audit)``.
    """
    from repro_torch.core.update import refit_frozen

    config = _default(config)
    base = base_leaf_size or factors.leaf_size
    audit = RecoveryAudit("repair_factors")

    def _refit(f):
        return refit_frozen(f, kernel, config, jitter_rows=base)

    def _rebuild_middle():
        mid = _rebuilt_middle(factors, kernel, config)
        return _refit(dataclasses.replace(mid, **{
            name: tuple(a.to(o.dtype) for a, o in zip(
                getattr(mid, name), getattr(factors, name)))
            for name in ("sigma", "sigma_cho", "w")}))

    plans = [("probe", lambda: factors),
             ("refit_frozen", lambda: _refit(factors)),
             ("rebuild_middle", _rebuild_middle)]
    last: Exception | None = None
    for rung, make in plans:
        try:
            f = make()
            health.probe_factors(f, config, force=True, op=rung)
        except NumericalFailure as e:
            audit.record(rung, False, e)
            last = e
            continue
        audit.record(rung, True)
        return f, audit
    raise RecoveryExhausted(audit, last)


# ---------------------------------------------------------------------------
# invert
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GuardedInvert:
    """:func:`invert_guarded` outcome: the inverse pair, the factors,
    ridge and config that produced it (follow-up solves use these, not the
    ones passed in) and the audit trail."""

    inverse: Any
    lo: Tensor
    factors: Any
    ridge: float
    config: Any
    audit: RecoveryAudit


def invert_guarded(factors, ridge, config=None, *, kernel=None,
                   jitter_rungs: int = 2,
                   base_leaf_size: int | None = None) -> GuardedInvert:
    """``invert_with_leaf`` under the ridge-precision-refit ladder.

    Rungs: the inversion as asked; ``jitter_rungs`` rounds of x10 ridge;
    with ``kernel``, precision-promoted factors at the original ridge
    (every factor rebuilt on the frozen hierarchy at each precision of
    the chain above ``config.precision``) and a dtype-preserving
    ``refit_frozen`` at the original ridge.  Each candidate is validated by
    :func:`~repro_torch.runtime.health.probe_leaf_factor` and a finiteness
    sweep over ``inv.linv``.  ``base_leaf_size`` pins the frozen jitter
    convention of the refit rungs (default the current leaf size).
    """
    from repro_torch.core import hmatrix
    from repro_torch.core.update import refit_frozen

    config = _default(config)
    base = base_leaf_size or factors.leaf_size
    audit = RecoveryAudit("invert")

    plans: list[tuple[str, Callable[[], tuple], float]] = [
        ("initial", lambda: (factors, config), float(ridge))]
    for i in range(1, jitter_rungs + 1):
        plans.append((f"ridge x{10 ** i:g}", lambda: (factors, config),
                      float(ridge) * 10.0 ** i))
    if kernel is not None:
        for p in _promotions(config):
            def _promote(p=p):
                cfg = dataclasses.replace(config, precision=p)
                return _rebuild_frozen(factors, kernel, cfg, base), cfg
            plans.append((f"promote:{p}", _promote, float(ridge)))

        def _refit_plain():
            cfg = dataclasses.replace(config, precision=None)
            return refit_frozen(factors, kernel, cfg, jitter_rows=base), cfg
        plans.append(("refit_frozen", _refit_plain, float(ridge)))

    last: Exception | None = None
    for rung, make, rho in plans:
        try:
            f, cfg = make()
            if rung != "initial":
                health.probe_factors(f, cfg, force=True, op=rung)
            inv, lo = hmatrix.invert_with_leaf(f, rho, cfg)
            health.probe_leaf_factor(lo, cfg, force=True)
            health.check_finite("leaf_factor", inv.linv, config=cfg,
                                force=True, leaf_axis=0,
                                detail="inverse Cholesky")
        except NumericalFailure as e:
            audit.record(rung, False, e)
            last = e
            continue
        audit.record(rung, True, note=f"ridge={rho:g}")
        return GuardedInvert(inv, lo, f, rho, cfg, audit)
    raise RecoveryExhausted(audit, last)


# ---------------------------------------------------------------------------
# iterative solves
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GuardedSolve:
    """:func:`pcg_guarded` outcome: the solution, the final CGResult when
    CG produced it (None for the exact fallback) and the audit trail."""

    x: Tensor
    result: Any
    audit: RecoveryAudit


def pcg_guarded(matvec, b, *, ridge=0.0, precond=None, fresh_precond=None,
                fresh_dot=None, exact_solve=None, tol: float = 1e-6,
                maxiter: int = 100, dot=None, x0=None, flexible: bool = True,
                require_converged: bool = True) -> GuardedSolve:
    """PCG under the re-precondition, cold-restart, exact ladder.

    Runs :func:`repro_torch.solvers.cg.pcg` and classifies the residual
    trace with :func:`~repro_torch.runtime.health.probe_cg`.  Repair
    rungs: ``fresh_precond()`` (a rebuilt preconditioner, warm start
    kept); a cold restart with the identity preconditioner and twice the
    iterations; ``exact_solve(b)``.  ``fresh_dot()`` supplies a rebuilt
    inner product for every repair rung.  ``require_converged`` treats a
    still-progressing ``maxiter`` exit as a failed rung too.
    """
    from repro_torch.solvers.cg import pcg

    audit = RecoveryAudit("pcg")
    attempts = [("initial", dict(precond=precond, x0=x0, maxiter=maxiter,
                                 flexible=flexible))]
    if fresh_precond is not None:
        attempts.append(("re-precondition",
                         dict(precond=None, x0=x0, maxiter=maxiter,
                              flexible=True, _fresh=True)))
    attempts.append(("cold restart", dict(precond=None, x0=None,
                                          maxiter=2 * maxiter,
                                          flexible=True)))

    last: Exception | None = None
    for rung, kw in attempts:
        if kw.pop("_fresh", False):
            kw["precond"] = fresh_precond()
        rung_dot = dot
        if rung != "initial" and fresh_dot is not None:
            rung_dot = fresh_dot()
        try:
            res = pcg(matvec, b, ridge=ridge, tol=tol, dot=rung_dot, **kw)
            health.probe_cg(res, tol=tol, force=True, context=f"rung={rung}")
            if require_converged and not bool(res.converged):
                raise NumericalFailure(
                    "solvers.cg", statistic="residual_maxiter",
                    value=float(res.residuals[int(res.iterations)]),
                    detail=f"not converged after {int(res.iterations)} "
                           f"iterations (tol={tol:g}) rung={rung}")
        except NumericalFailure as e:
            audit.record(rung, False, e)
            last = e
            continue
        audit.record(rung, True, note=f"iters={int(res.iterations)}")
        return GuardedSolve(res.x, res, audit)

    if exact_solve is not None:
        try:
            x = exact_solve(b)
            health.check_finite("solvers.exact", x, force=True)
        except NumericalFailure as e:
            audit.record("exact fallback", False, e)
            raise RecoveryExhausted(audit, e)
        audit.record("exact fallback", True)
        return GuardedSolve(x, None, audit)
    raise RecoveryExhausted(audit, last)


# ---------------------------------------------------------------------------
# online updates
# ---------------------------------------------------------------------------

def _validate_update(model, info):
    """Post-update invariants: finite factors and coefficients, a finite
    and converged re-solve residual."""
    health.probe_factors(model.factors, model.solve_config, force=True,
                         op="update.insert")
    health.check_finite("leaf_update", model.alpha,
                        config=model.solve_config, force=True,
                        detail="dual coefficients")
    if model.leaf_lo is not None:
        health.probe_leaf_factor(model.leaf_lo, model.solve_config,
                                 force=True, stage="leaf_update")
    resid = float(info.residual)
    if not math.isfinite(resid) or not info.converged:
        raise NumericalFailure(
            "solvers.cg", statistic="update_residual", value=resid,
            backend=getattr(model.solve_config, "backend", None),
            detail=f"refresh={info.refresh!r} iterations={info.iterations} "
                   f"converged={info.converged}")


def update_guarded(model, x_new, y_new, *, refresh: str = "inverse",
                   tol: float = 1e-8,
                   **kwargs) -> tuple[Any, Any, RecoveryAudit]:
    """``HCKRegressor.update`` under the refresh-escalation ladder.

    Rungs: the requested ``refresh``; the same refresh from a fresh base
    inverse (the cached ``inverse`` / ``leaf_lo`` dropped: the repair of a
    stale or poisoned cached pair); ``refresh="inverse"``;
    ``refresh="exact"`` (the grown hierarchy inverted from scratch).  Each
    candidate passes the post-update invariants before it is returned as
    ``(model_new, info, audit)``.  ``kwargs`` pass through to
    :func:`repro_torch.core.krr.fit_incremental` (``pad_index``,
    ``pad_noise``, ``generator``, ...).
    """
    audit = RecoveryAudit("update")
    plans = [(f"refresh={refresh!r}", model, refresh)]
    fresh = dataclasses.replace(model, inverse=None, leaf_lo=None)
    fresh._leaf_linv = model._leaf_linv
    plans.append((f"re-precondition (fresh inverse, refresh={refresh!r})",
                  fresh, refresh))
    if refresh != "inverse":
        plans.append(("refresh='inverse'", fresh, "inverse"))
    plans.append(("refresh='exact'", fresh, "exact"))

    last: Exception | None = None
    for rung, base, mode in plans:
        try:
            model_new, info = base.update(x_new, y_new, refresh=mode,
                                          tol=tol, **kwargs)
            _validate_update(model_new, info)
        except NumericalFailure as e:
            audit.record(rung, False, e)
            last = e
            continue
        audit.record(rung, True,
                     note=f"iterations={info.iterations} "
                          f"residual={info.residual:.3g}")
        return model_new, info, audit
    raise RecoveryExhausted(audit, last)
