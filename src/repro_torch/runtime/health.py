"""Numerical health probes at stage boundaries (counterpart of
``repro.runtime.health``).

Finite precision and online mutation break the paper's positive-definite
guarantee without a sound: a NaN basis, an indefinite leaf Schur
complement, a stalled CG column or a poisoned served batch.  The probes
here turn those into structured :class:`NumericalFailure` diagnostics:

  * the factors after ``build_hck`` / ``insert`` (:func:`probe_factors`:
    every factor finite and every Sigma Cholesky diagonal positive);
  * the leaf Schur Cholesky after ``leaf_factor`` / ``leaf_update``
    (:func:`probe_leaf_factor`, the definiteness witness);
  * CG residual traces (:func:`cg_diagnose`, :func:`probe_cg`);
  * served predictions (:func:`probe_predictions`).

Probes run between stages, never inside a kernel, so the kernels' launches
are the same with checks on or off.  They are gated by
``SolveConfig.checks``, whose default defers to the ``REPRO_STRICT_FINITE``
environment variable; off, a probe launches nothing and syncs nothing.
On, the happy path of :func:`probe_factors` costs one read-back from the
card for the whole factor set; the per-factor attribution runs only once
something is known to be bad.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

Tensor = torch.Tensor


def _dtype_name(dtype) -> str | None:
    """``float64`` for ``torch.float64`` (the reference's spelling)."""
    return None if dtype is None else str(dtype).removeprefix("torch.")


class NumericalFailure(RuntimeError):
    """A numerical invariant broke at a named stage boundary.

    Carries what a recovery ladder (or a human reading a serving log)
    needs to act without re-running the failure: the stage, the offending
    node or leaf, the operand dtype, the backend and the statistic that
    tripped.
    """

    def __init__(self, stage: str, *, statistic: str, value,
                 leaf: int | None = None, node: int | None = None,
                 dtype=None, backend: str | None = None, detail: str = ""):
        self.stage = stage
        self.statistic = statistic
        self.value = value
        self.leaf = leaf
        self.node = node
        self.dtype = _dtype_name(dtype)
        self.backend = backend
        self.detail = detail
        parts = [f"[{stage}] {statistic}={value!r}"]
        if leaf is not None:
            parts.append(f"leaf={leaf}")
        if node is not None:
            parts.append(f"node={node}")
        if self.dtype is not None:
            parts.append(f"dtype={self.dtype}")
        if backend is not None:
            parts.append(f"backend={backend}")
        if detail:
            parts.append(detail)
        super().__init__(" ".join(parts))

    def to_dict(self) -> dict[str, Any]:
        """JSON-serializable form (audit trails, fault matrices)."""
        return {
            "stage": self.stage,
            "statistic": self.statistic,
            "value": repr(self.value),
            "leaf": self.leaf,
            "node": self.node,
            "dtype": self.dtype,
            "backend": self.backend,
            "detail": self.detail,
        }


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

def strict_finite_env() -> bool:
    """The ``REPRO_STRICT_FINITE`` policy bit (default off)."""
    return os.environ.get("REPRO_STRICT_FINITE", "0").lower() not in (
        "", "0", "false", "off")


def checks_enabled(config=None) -> bool:
    """Whether probes run for ``config``: ``config.checks`` when set, else
    ``REPRO_STRICT_FINITE`` read at call time."""
    checks = getattr(config, "checks", None)
    if checks is None:
        return strict_finite_env()
    return bool(checks)


def _gate(config, force: bool) -> bool:
    return force or checks_enabled(config)


def _backend_of(config) -> str | None:
    return getattr(config, "backend", None)


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _first_bad_leaf(bad: Tensor, leaf_axis: int | None) -> int | None:
    """Index along ``leaf_axis`` of the first offending entry."""
    if leaf_axis is None:
        return None
    axes = tuple(i for i in range(bad.ndim) if i != leaf_axis)
    per_leaf = bad.any(dim=axes) if axes else bad
    return int(torch.argmax(per_leaf.to(torch.int8)))


def check_finite(stage: str, x: Tensor, *, config=None, force: bool = False,
                 statistic: str = "nonfinite_count",
                 leaf_axis: int | None = None, detail: str = "") -> bool:
    """Raise :class:`NumericalFailure` if ``x`` has NaN or Inf entries.

    Returns True when the probe ran, False when it was gated off.
    """
    if not _gate(config, force):
        return False
    bad = ~torch.isfinite(x)
    if bool(bad.any()):
        raise NumericalFailure(
            stage, statistic=statistic, value=int(bad.sum()),
            leaf=_first_bad_leaf(bad, leaf_axis), dtype=x.dtype,
            backend=_backend_of(config), detail=detail)
    return True


def _all_finite_pd(leaves, chos) -> bool:
    """Every array finite and every Cholesky diagonal positive, read back
    once.  Each array's l1 norm is finite exactly when the array is (short
    of an overflow of the sum, which sends the caller to its per-array
    attribution, which passes), and ``_foreach_norm`` takes all of them in
    a few multi-tensor launches instead of two launches an array."""
    finite = torch.isfinite(torch.stack(torch._foreach_norm(leaves, 1))).all()
    if chos:
        diag = torch.cat([torch.diagonal(c, dim1=-2, dim2=-1).reshape(-1)
                          for c in chos])
        finite = finite & (diag.min() > 0)
    return bool(finite)


def probe_factors(factors, config=None, *, force: bool = False,
                  op: str = "build") -> bool:
    """Finiteness of every HCK factor, attributed to its producing stage.

    ``adiag`` / ``sigma`` / ``sigma_cho`` come out of the ``build_gram``
    stage (with a positive-diagonal check of the Cholesky factor, the
    definiteness witness); ``u`` / ``w`` out of ``build_cross``.  ``op``
    names the caller ("build", "update.insert", a ladder's rung) in the
    message.
    """
    if not _gate(config, force):
        return False
    leaves = [factors.adiag, factors.u, *factors.sigma, *factors.sigma_cho,
              *factors.w]
    if _all_finite_pd(leaves, list(factors.sigma_cho)):
        return True
    check_finite("build_gram", factors.adiag, config=config, force=True,
                 leaf_axis=0, detail=f"op={op} factor=adiag")
    for lvl, (sig, cho) in enumerate(zip(factors.sigma, factors.sigma_cho)):
        check_finite("build_gram", sig, config=config, force=True,
                     leaf_axis=0, detail=f"op={op} factor=sigma level={lvl}")
        check_finite("build_gram", cho, config=config, force=True,
                     leaf_axis=0,
                     detail=f"op={op} factor=sigma_cho level={lvl}")
        diag = torch.diagonal(cho, dim1=-2, dim2=-1)
        if bool((diag <= 0).any()):
            raise NumericalFailure(
                "build_gram", statistic="min_cholesky_diag",
                value=float(diag.min()), node=_first_bad_leaf(diag <= 0, 0),
                dtype=cho.dtype, backend=_backend_of(config),
                detail=f"op={op} Sigma Cholesky not PD at level {lvl}")
    check_finite("build_cross", factors.u, config=config, force=True,
                 leaf_axis=0, detail=f"op={op} factor=u")
    for lvl, w in enumerate(factors.w):
        check_finite("build_cross", w, config=config, force=True,
                     leaf_axis=0, detail=f"op={op} factor=w level={lvl}")
    return True


def probe_leaf_factor(lo: Tensor, config=None, *, force: bool = False,
                      stage: str = "leaf_factor") -> bool:
    """Definiteness witness of the ridged leaf Schur complements.

    ``lo`` is the (P, n0, n0) Cholesky stack of ``invert_with_leaf`` /
    ``invert_extend``; a NaN or non-positive diagonal entry means the
    Schur complement went indefinite under the ridge.  ``stage=
    "leaf_update"`` names the bordered extension.
    """
    if not _gate(config, force):
        return False
    diag = torch.diagonal(lo, dim1=-2, dim2=-1)          # (P, n0)
    finite = torch.isfinite(diag)
    bad = ~finite | (diag <= 0)
    if bool(bad.any()):
        floor = torch.full_like(diag, -float("inf"))
        raise NumericalFailure(
            stage, statistic="min_schur_cholesky_diag",
            value=float(torch.where(finite, diag, floor).min()),
            leaf=_first_bad_leaf(bad, 0), dtype=lo.dtype,
            backend=_backend_of(config),
            detail="leaf Schur complement indefinite or non-finite "
                   "(raise the ridge, promote precision, or refit)")
    return True


def cg_diagnose(result, *, tol: float) -> str:
    """Classify a :class:`~repro_torch.solvers.cg.CGResult` trace.

    One of ``"converged"``, ``"nonfinite"``, ``"diverged"`` (the final
    residual grew past 10x the initial one), ``"stalled"`` (out of
    iterations with less than 10% progress over the trailing window of up
    to 10 iterations) and ``"maxiter"`` (still converging, slowly).
    """
    trace = result.residuals.detach().double().cpu().numpy()
    it = int(result.iterations)
    final = float(trace[it])
    if not np.isfinite(trace[: it + 1]).all():
        return "nonfinite"
    if bool(result.converged):
        return "converged"
    if final > 10.0 * float(trace[0]) + 1e-30:
        return "diverged"
    window = min(10, it) if it > 0 else 0
    if window and final > 0.9 * float(trace[it - window]) and final > tol:
        return "stalled"
    return "maxiter"


def probe_cg(result, *, tol: float, config=None, force: bool = False,
             context: str = "") -> str | None:
    """Stall and divergence detector on a CG residual trace.

    Raises :class:`NumericalFailure` (stage ``solvers.cg``) on the
    ``nonfinite`` / ``diverged`` / ``stalled`` verdicts; returns the
    verdict otherwise, or None when gated off.
    """
    if not _gate(config, force):
        return None
    verdict = cg_diagnose(result, tol=tol)
    if verdict in ("nonfinite", "diverged", "stalled"):
        it = int(result.iterations)
        raise NumericalFailure(
            "solvers.cg", statistic=f"residual_{verdict}",
            value=float(result.residuals[it]), dtype=result.x.dtype,
            backend=_backend_of(config),
            detail=f"after {it} iterations (tol={tol:g}) {context}".strip())
    return verdict


def probe_predictions(z: Tensor, config=None, *, force: bool = False,
                      stage: str = "predict") -> bool:
    """Finiteness of a served prediction batch (engine, canary gate)."""
    return check_finite(stage, z, config=config, force=force,
                        statistic="nonfinite_predictions")
