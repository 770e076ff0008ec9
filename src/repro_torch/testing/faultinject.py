"""Composable fault injection (counterpart of
``repro.testing.faultinject``).

Each injector produces a real poisoned object: factors with a NaN basis,
an indefinite leaf Schur complement, an indefinite preconditioner, an
inner product that turns NaN after N calls, a serving engine that lies.
The tests assert, per fault class, that the
:mod:`repro_torch.runtime.health` probes detect it (a structured
``NumericalFailure`` naming the stage) and the
:mod:`repro_torch.runtime.recover` ladders recover it.  Injectors do not
touch their input (factors, plans and models come back as new objects
over copied tensors), so faults compose.

:data:`FAULT_CLASSES` is the fault inventory, the reference's twelve
names; :func:`corrupt_tile_db` (``tile_db_corruption``) garbles the
autotune tile database of :mod:`repro_torch.kernels.autotune` on disk.
"""
from __future__ import annotations

import dataclasses
import time

import torch

Tensor = torch.Tensor

#: fault inventory: name -> (layer, description).
FAULT_CLASSES = {
    "factor_nan": (
        "build", "NaN injected into the build_cross basis U of one leaf"),
    "factor_inf": (
        "build", "Inf injected into a leaf Gram diagonal block"),
    "sigma_nan": (
        "build", "NaN injected into a middle Sigma factor"),
    "indefinite_leaf": (
        "invert", "one leaf Schur complement forced indefinite under the "
                  "fit ridge"),
    "bf16_ridge_floor": (
        "invert", "bf16-built factors inverted below the n0*eps_bf16 "
                  "ridge floor"),
    "cg_bad_preconditioner": (
        "solve", "indefinite preconditioner stalls/diverges CG"),
    "cg_nonsymmetric_column": (
        "solve", "one RHS column's operator made nonsymmetric (stalled "
                 "column)"),
    "collective_nan": (
        "solve", "the Nth inner-product collective returns NaN"),
    "tile_db_corruption": (
        "kernels", "autotune tile DB replaced with garbage bytes"),
    "update_poisoned_cache": (
        "update", "cached leaf Schur Cholesky NaN-poisoned before an "
                  "online insert"),
    "serving_poisoned_model": (
        "serving", "published model's OOS plan NaN-poisoned"),
    "serving_flaky_engine": (
        "serving", "live engine returns NaN / stalls for N calls"),
}

#: the fault classes whose targets are not ported yet: none since the
#: autotune tile database (ROADMAP A15b) came.
A15_FAULTS = ()


def _poked(t: Tensor, index, value: float) -> Tensor:
    out = t.clone()
    out[index] = value
    return out


# ---------------------------------------------------------------------------
# factor faults
# ---------------------------------------------------------------------------

def poison_factor(factors, field: str = "u", *, leaf: int = 0,
                  value: float = float("nan")):
    """Copy of ``factors`` with ``value`` poked into one entry of a named
    factor (``adiag`` / ``u`` at ``leaf``; the tuple factors ``sigma`` /
    ``sigma_cho`` / ``w`` at their last level, node 0)."""
    arr = getattr(factors, field)
    if isinstance(arr, tuple):
        last = arr[-1]
        new = arr[:-1] + (_poked(last, (0,) * last.ndim, value),)
    else:
        new = _poked(arr, (leaf,) + (0,) * (arr.ndim - 1), value)
    return dataclasses.replace(factors, **{field: new})


def indefinite_leaf(factors, *, leaf: int = 0, shift: float = 1.0):
    """Copy of ``factors`` whose leaf ``leaf`` Gram diagonal block is
    shifted by ``-shift * I``: its Schur complement goes indefinite once
    ``shift`` exceeds the ridge plus the Schur floor, and the
    ``leaf_factor`` Cholesky turns NaN."""
    adiag = factors.adiag.clone()
    n0 = adiag.shape[-1]
    adiag[leaf] -= shift * torch.eye(n0, dtype=adiag.dtype,
                                     device=adiag.device)
    return dataclasses.replace(factors, adiag=adiag)


def bf16_ridge_floor_factors(x: Tensor, *, levels: int, rank: int, kernel,
                             config=None, jitter: float = 1e-6,
                             **build_kwargs):
    """bf16-built factors that an inversion below the n0 * eps_bf16 ridge
    floor breaks, as the reference's recipe builds them
    (tests/test_robustness.py): ``x`` built under
    ``SolveConfig(precision="bf16")`` (``config``'s other fields kept)
    with the kernel's jitter set to ``jitter``, far below the bf16 factor
    error, and every factor (adiag, U, W, Sigma and its Cholesky factor)
    rounded to bfloat16 and stored in float32, as the reference's xla
    lane stores its bf16 stage outputs.  The port's kernels, like the
    reference's Pallas ones, write float32, and their factors carry only
    the data's rounding, which the leaf Schur complement survives; the
    rounded factors carry an O(eps_bf16) error, so the Schur complement
    goes indefinite at any moderate ridge.  ``build_kwargs`` pass through
    to ``build_hck``.  Returns ``(factors, kernel, config)``: the build's
    kernel and config, which the recovery ladder takes."""
    from repro_torch.core.hck import build_hck
    from repro_torch.kernels.registry import DEFAULT_CONFIG

    cfg = dataclasses.replace(config if config is not None else
                              DEFAULT_CONFIG, precision="bf16")
    ker = dataclasses.replace(kernel, jitter=jitter)
    f = build_hck(x, levels=levels, rank=rank, kernel=ker, config=cfg,
                  **build_kwargs)

    def rounded(t: Tensor) -> Tensor:
        return t.to(torch.bfloat16).to(t.dtype)

    f = dataclasses.replace(
        f, adiag=rounded(f.adiag), u=rounded(f.u),
        w=tuple(map(rounded, f.w)), sigma=tuple(map(rounded, f.sigma)),
        sigma_cho=tuple(map(rounded, f.sigma_cho)))
    return f, ker, cfg


# ---------------------------------------------------------------------------
# solver faults
# ---------------------------------------------------------------------------

def bad_preconditioner(sign_every: int = 7):
    """An indefinite 'preconditioner' that flips the sign of every
    ``sign_every``-th row: CG needs an SPD M^-1, and this one stalls or
    diverges the recurrence."""
    def precond(r: Tensor) -> Tensor:
        n = r.shape[0]
        idx = torch.arange(n, device=r.device)
        signs = torch.where(idx % sign_every == 0, -1.0, 1.0).to(r.dtype)
        return r * (signs[:, None] if r.ndim == 2 else signs)
    return precond


def nonsymmetric_column(matvec, col: int, eps: float = 0.5):
    """Wrap a batched matvec so that column ``col`` sees a nonsymmetric
    operator (a rolled perturbation): that column's CG stalls while the
    others converge."""
    def wrapped(v: Tensor) -> Tensor:
        av = matvec(v).clone()
        av[:, col] += eps * torch.roll(v[:, col], 1)
        return av
    return wrapped


def poisoned_dot(dot=None, *, after: int = 2):
    """Wrap a CG inner product so that every call past the ``after``-th
    returns NaN: one device dropping out of a collective mid-solve.
    Returns ``(dot, state)``; ``state['calls']`` is the live call count."""
    from repro_torch.solvers.cg import column_dot

    dot = dot if dot is not None else column_dot
    state = {"calls": 0}

    def wrapped(u: Tensor, v: Tensor) -> Tensor:
        out = dot(u, v)
        state["calls"] += 1
        if state["calls"] > after:
            return torch.full_like(out, float("nan"))
        return out

    return wrapped, state


# ---------------------------------------------------------------------------
# kernel-system faults
# ---------------------------------------------------------------------------

def corrupt_tile_db(path: str | None = None) -> str:
    """Overwrite the autotune tile database with non-JSON garbage and drop
    the process's cached copy, so the next consult reads the corrupt file.
    The contract under test: lookups degrade to the wrappers' plans
    (``TileDB.corrupt`` flags it), never raise, and the next ``save``
    repairs the file.  Returns the path written."""
    import os

    from repro_torch.kernels import autotune

    path = path or autotune.db_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write('{"entries": #### not json ####')
    autotune.reset_db()
    return path


# ---------------------------------------------------------------------------
# update / serving faults
# ---------------------------------------------------------------------------

def poison_cached_inverse(model):
    """Copy of a fitted HCKRegressor whose cached leaf Schur Cholesky is
    NaN-poisoned: the next ``refresh="inverse"`` update borders garbage."""
    lo = _poked(model.leaf_lo, (0,) * model.leaf_lo.ndim, float("nan"))
    poisoned = dataclasses.replace(model, leaf_lo=lo)
    poisoned._leaf_linv = model._leaf_linv
    return poisoned


def poison_plan(plan, *, value: float = float("nan")):
    """Copy of an OOS plan with one poisoned ``w_leaf`` entry: every query
    routed to that leaf serves ``value``."""
    w = _poked(plan.w_leaf, (0,) * plan.w_leaf.ndim, value)
    return dataclasses.replace(plan, w_leaf=w)


def poisoned_model(model):
    """Copy of a fitted model whose prediction plan is NaN-poisoned: it
    fits clean and serves garbage, what the registry's canary gate is for."""
    poisoned = dataclasses.replace(model, plan=poison_plan(model.plan))
    poisoned._leaf_linv = model._leaf_linv
    return poisoned


@dataclasses.dataclass
class FlakyEngine:
    """Engine wrapper that misbehaves for its first ``fail_first`` calls
    (``mode="nan"`` returns NaN, ``"raise"`` raises, ``"slow"`` sleeps
    ``delay_s``: a deadline fault), then heals; ``fail_first=-1`` never
    heals.  :func:`hijack_live_engine` puts one in a registry's live entry:
    a version that went bad after its canary passed."""

    inner: object
    fail_first: int = 1
    mode: str = "nan"
    delay_s: float = 0.05
    calls: int = 0

    def __call__(self, queries: Tensor) -> Tensor:
        self.calls += 1
        failing = self.fail_first < 0 or self.calls <= self.fail_first
        if failing and self.mode == "raise":
            raise FloatingPointError("faultinject: engine down")
        if failing and self.mode == "slow":
            time.sleep(self.delay_s)
        z = self.inner(queries)
        if failing and self.mode == "nan":
            return torch.full_like(z, float("nan"))
        return z

    @property
    def stats(self):
        """The wrapped engine's serving counters."""
        return self.inner.stats


def hijack_live_engine(registry, wrapper):
    """Replace the live registry entry's engine by ``wrapper(engine)`` in
    place (the serve loop's retry and degraded ladder owns this case, not
    the publish gate).  Returns the new entry."""
    with registry._lock:
        entry = registry._live
        new = dataclasses.replace(entry, engine=wrapper(entry.engine))
        registry._versions[entry.version] = new
        registry._live = new
    return new
