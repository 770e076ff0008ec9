"""Port parity: the runtime health probes (``repro_torch.runtime.health``)
and their wiring into ``krr.fit``, ``fit_incremental`` and ``gp.fit_gp``.

The reference fits its robustness problem (``tests/test_robustness.py``'s
``prob``: 256 points, d 5, rank 16, leaves of 32, 3 levels, gaussian
sigma 2, jitter 1e-8, lambda 1e-2) once in float64 under its ``xla``
backend with checks on; ``repro_torch.convert`` carries the model across,
so both packages probe the same factors.  The same injection in both must
give the same ``NumericalFailure`` record: stage, statistic, leaf and node
equal, the value within 1e-12 relative.  ``make_prob`` is shared with
``test_torch_recover.py`` and ``test_torch_registry.py``.
"""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws
from test_torch_oos import flatten_model

from repro.core import gp as jgp
from repro.core import hmatrix as jhmatrix
from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.runtime import health as jhealth
from repro.solvers.cg import CGResult as JCGResult
from repro.testing import faultinject as jfi
from repro_torch import convert
from repro_torch.core import gp, hmatrix, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels.registry import SolveConfig
from repro_torch.runtime import health
from repro_torch.solvers.cg import CGResult
from repro_torch.testing import faultinject as fi

N, D, RANK, LEAF, LEVELS = 256, 5, 16, 32, 3
SIGMA, JITTER, LAM = 2.0, 1e-8, 1e-2
JCFG = JSolveConfig(backend="xla", checks=True)
CFG = SolveConfig(checks=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=1)
def make_prob():
    """The reference's robustness problem and its model, fitted once a
    process, and the port's copy of the model (plus what a port build of
    the same tree and landmarks needs).  Callers do not mutate it."""
    kx, kw, kn, kq = jax.random.split(jax.random.PRNGKey(0), 4)
    x = jax.random.normal(kx, (N, D), jnp.float64)
    w = jax.random.normal(kw, (D, 2))
    y = x @ w + 0.05 * jax.random.normal(kn, (N, 2))
    jker = JKernel("gaussian", sigma=SIGMA, jitter=JITTER)
    jm = jkrr.fit(x, y, kernel=jker, lam=LAM, rank=RANK, leaf_size=LEAF,
                  levels=LEVELS, solve_config=JCFG)
    arrays = flatten_model(jm.factors, jm.plan, jm.alpha, jm.classes,
                           jm.inverse, jm.leaf_lo)
    m = convert.regressor_from_arrays(
        arrays, kernel="gaussian", sigma=SIGMA, jitter=JITTER, lam=LAM,
        squeeze=False, solve_config=CFG, device="cpu")
    _, kbuild = jax.random.split(jax.random.PRNGKey(0))
    build = dict(levels=LEVELS, rank=RANK,
                 directions=[_t(v) for v in jm.factors.tree.directions],
                 landmark_index=landmark_draws(kbuild, N, LEVELS, RANK))
    queries = jax.random.normal(kq, (64, D), jnp.float64)
    return types.SimpleNamespace(
        x=np.asarray(x), y=np.asarray(y), jx=x, jy=y, jker=jker,
        kernel=BaseKernel("gaussian", SIGMA, JITTER), jm=jm, m=m,
        build=build, kbuild=kbuild, jq=queries, q=_t(queries), lam=LAM)


def record_of(err) -> dict:
    """The fields of a failure record the two packages must share."""
    d = err.to_dict()
    return {k: d[k] for k in ("stage", "statistic", "leaf", "node")}


def same_record(err, jerr, rtol=1e-12):
    assert type(err).__name__ == "NumericalFailure"
    assert record_of(err) == record_of(jerr), (err, jerr)
    assert err.dtype == jerr.dtype
    v, jv = float(err.value), float(jerr.value)
    if math.isfinite(jv):
        assert abs(v - jv) <= rtol * max(abs(jv), 1e-300), (v, jv)
    else:
        assert v == jv or (math.isnan(v) and math.isnan(jv)), (v, jv)


@pytest.fixture(scope="module")
def prob(f64):
    return make_prob()


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [None, "1", "0", "false", "off", "", "yes"])
@pytest.mark.parametrize("checks", [None, True, False])
def test_checks_gating(monkeypatch, env, checks):
    if env is None:
        monkeypatch.delenv("REPRO_STRICT_FINITE", raising=False)
    else:
        monkeypatch.setenv("REPRO_STRICT_FINITE", env)
    assert health.strict_finite_env() == jhealth.strict_finite_env()
    got = health.checks_enabled(SolveConfig(checks=checks))
    assert got == jhealth.checks_enabled(JSolveConfig(checks=checks))
    if checks is None:
        assert health.checks_enabled(None) == got
    assert SolveConfig(checks=checks).checks is checks


def test_checks_off_probes_nothing_and_force_raises(prob, monkeypatch):
    monkeypatch.delenv("REPRO_STRICT_FINITE", raising=False)
    off = SolveConfig(checks=False)
    bad = fi.poison_factor(prob.m.factors, "u")
    assert health.probe_factors(bad, off) is False
    assert health.probe_leaf_factor(bad.adiag, off) is False
    assert health.check_finite("x", bad.u, config=off) is False
    assert health.probe_predictions(bad.u, off) is False
    with pytest.raises(health.NumericalFailure):
        health.probe_factors(bad, off, force=True)
    # the injector leaves its input untouched
    assert bool(torch.isfinite(prob.m.factors.u).all())
    assert health.probe_factors(prob.m.factors, CFG) is True


# ---------------------------------------------------------------------------
# factor and leaf faults: the same record in both packages
# ---------------------------------------------------------------------------

FAULTS = {
    "factor_nan": ("u", float("nan")),
    "factor_inf": ("adiag", float("inf")),
    "sigma_nan": ("sigma", float("nan")),
    "sigma_cho_nan": ("sigma_cho", float("nan")),
    "w_inf": ("w", float("inf")),
}


@pytest.mark.parametrize("fault", list(FAULTS) + ["indefinite_leaf"])
def test_fault_records_match_reference(prob, fault):
    if fault == "indefinite_leaf":
        bad = fi.indefinite_leaf(prob.m.factors, leaf=2, shift=5 * LAM)
        jbad = jfi.indefinite_leaf(prob.jm.factors, leaf=2, shift=5 * LAM)
        _, lo = hmatrix.invert_with_leaf(bad, LAM, CFG)
        _, jlo = jhmatrix.invert_with_leaf(jbad, LAM, JCFG)
        probe, jprobe, args, jargs = (health.probe_leaf_factor,
                                      jhealth.probe_leaf_factor, lo, jlo)
    else:
        field, value = FAULTS[fault]
        bad = fi.poison_factor(prob.m.factors, field, leaf=1, value=value)
        jbad = jfi.poison_factor(prob.jm.factors, field, leaf=1, value=value)
        probe, jprobe, args, jargs = (health.probe_factors,
                                      jhealth.probe_factors, bad, jbad)
    with pytest.raises(health.NumericalFailure) as ei:
        probe(args, CFG)
    with pytest.raises(jhealth.NumericalFailure) as jei:
        jprobe(jargs, JCFG)
    same_record(ei.value, jei.value)
    assert ei.value.detail == jei.value.detail


def test_indefinite_sigma_cholesky_record(prob):
    """A non-positive pivot of a Sigma Cholesky (finite): the definiteness
    witness of the build, with the node."""
    cho = prob.m.factors.sigma_cho
    jcho = prob.jm.factors.sigma_cho
    bad = dataclasses.replace(prob.m.factors, sigma_cho=cho[:-1] + (
        fi._poked(cho[-1], (3, 2, 2), -0.5),))
    jbad = dataclasses.replace(prob.jm.factors, sigma_cho=jcho[:-1] + (
        jcho[-1].at[3, 2, 2].set(-0.5),))
    with pytest.raises(health.NumericalFailure) as ei:
        health.probe_factors(bad, CFG, op="build")
    with pytest.raises(jhealth.NumericalFailure) as jei:
        jhealth.probe_factors(jbad, JCFG, op="build")
    same_record(ei.value, jei.value)
    assert ei.value.statistic == "min_cholesky_diag" and ei.value.node == 3


# ---------------------------------------------------------------------------
# CG traces
# ---------------------------------------------------------------------------

TRACES = {
    "converged": ([1.0, 0.1, 1e-9], 2, True),
    "nonfinite": ([1.0, 0.5, float("nan"), float("nan")], 2, False),
    "diverged": ([1.0, 3.0, 20.0, 40.0], 3, False),
    "stalled": ([1.0] + [0.5] * 12, 12, False),
    "maxiter": ([1.0, 0.5, 0.25, 0.125, 0.0625], 4, False),
}


@pytest.mark.parametrize("verdict", list(TRACES))
def test_cg_diagnose_matches_reference(verdict):
    trace, it, conv = TRACES[verdict]
    res = CGResult(torch.zeros(3, 1, dtype=torch.float64), it,
                   torch.tensor(trace, dtype=torch.float64), conv)
    jres = JCGResult(jnp.zeros((3, 1)), jnp.asarray(it),
                     jnp.asarray(trace), jnp.asarray(conv))
    assert health.cg_diagnose(res, tol=1e-8) == verdict
    assert jhealth.cg_diagnose(jres, tol=1e-8) == verdict
    if verdict in ("nonfinite", "diverged", "stalled"):
        with pytest.raises(health.NumericalFailure) as ei:
            health.probe_cg(res, tol=1e-8, force=True, context="t")
        with pytest.raises(jhealth.NumericalFailure) as jei:
            jhealth.probe_cg(jres, tol=1e-8, force=True, context="t")
        same_record(ei.value, jei.value)
        assert ei.value.detail == jei.value.detail
    else:
        assert health.probe_cg(res, tol=1e-8, force=True) == verdict
    assert health.probe_cg(res, tol=1e-8, config=SolveConfig(
        checks=False)) is None


def test_check_finite_counts_and_leaf(f64):
    x = np.ones((4, 3, 2))
    x[2, 1, 0] = np.nan
    x[3, 0, 1] = np.inf
    for axis in (None, 0, 1):
        with pytest.raises(health.NumericalFailure) as ei:
            health.check_finite("s", _t(x), force=True, leaf_axis=axis)
        with pytest.raises(jhealth.NumericalFailure) as jei:
            jhealth.check_finite("s", jnp.asarray(x), force=True,
                                 leaf_axis=axis)
        same_record(ei.value, jei.value)
        assert ei.value.value == 2
    with pytest.raises(health.NumericalFailure) as ei:
        health.probe_predictions(_t(x), force=True, stage="serve")
    assert ei.value.statistic == "nonfinite_predictions"
    assert ei.value.to_dict()["dtype"] == "float64"


# ---------------------------------------------------------------------------
# the probes wired into the fits
# ---------------------------------------------------------------------------

def _fit_both(prob, jitter, cfg, jcfg):
    """The port's fit and the reference's on the same tree and landmarks;
    returns (port error or model, reference error or model)."""
    out = []
    for run in (
            lambda: krr.fit(prob.x, prob.y, kernel=BaseKernel(
                "gaussian", SIGMA, jitter), lam=LAM, rank=RANK,
                leaf_size=LEAF, solve_config=cfg, device="cpu",
                **{k: v for k, v in prob.build.items() if k != "rank"}),
            lambda: jkrr.fit(prob.jx, prob.jy, kernel=JKernel(
                "gaussian", SIGMA, jitter), lam=LAM, rank=RANK,
                leaf_size=LEAF, levels=LEVELS, solve_config=jcfg)):
        try:
            out.append(run())
        except (health.NumericalFailure, jhealth.NumericalFailure) as e:
            out.append(e)
    return out


@pytest.mark.parametrize("how", ["checks", "env"])
def test_poisoned_fit_raises_the_reference_record(prob, monkeypatch, how):
    """A negative jitter makes the landmark Grams indefinite: with checks
    on both fits stop at the build probe with the same record (Sigma's
    Cholesky factor non-finite); with checks off both return non-finite
    coefficients silently."""
    if how == "env":
        monkeypatch.setenv("REPRO_STRICT_FINITE", "1")
        cfg, jcfg = SolveConfig(), JSolveConfig(backend="xla")
    else:
        monkeypatch.delenv("REPRO_STRICT_FINITE", raising=False)
        cfg, jcfg = CFG, JCFG
    err, jerr = _fit_both(prob, -0.05, cfg, jcfg)
    assert isinstance(jerr, jhealth.NumericalFailure)
    assert isinstance(err, health.NumericalFailure)
    same_record(err, jerr)
    assert (err.stage, err.statistic) == ("build_gram", "nonfinite_count")
    monkeypatch.delenv("REPRO_STRICT_FINITE", raising=False)
    m, jm = _fit_both(prob, -0.05, SolveConfig(checks=False),
                      JSolveConfig(backend="xla", checks=False))
    assert not bool(torch.isfinite(m.alpha).all())
    assert not bool(jnp.isfinite(jm.alpha).all())


@pytest.mark.parametrize("refresh", ["inverse", "exact", "stale"])
def test_fit_incremental_probes_match_reference(prob, refresh):
    """A poisoned cached leaf factor fails the bordered update at the
    leaf_update probe; the exact and stale refreshes ignore or do not
    re-factor it and probe clean.  A NaN arrival fails the insert probe."""
    rng = np.random.default_rng(13)
    x_new = rng.standard_normal((16, D))
    y_new = rng.standard_normal((16, 2))
    bad, jbad = fi.poison_cached_inverse(prob.m), jfi.poison_cached_inverse(
        prob.jm)
    kw = dict(refresh=refresh)
    if refresh == "inverse":
        with pytest.raises(health.NumericalFailure) as ei:
            bad.update(x_new, y_new, **kw)
        with pytest.raises(jhealth.NumericalFailure) as jei:
            jbad.update(jnp.asarray(x_new), jnp.asarray(y_new), **kw)
        same_record(ei.value, jei.value)
        assert ei.value.stage == "leaf_update" and ei.value.leaf == 0
    else:
        _, info = bad.update(x_new, y_new, **kw)
        assert math.isfinite(info.residual)
    x_nan = x_new.copy()
    x_nan[0, 0] = np.nan
    with pytest.raises(health.NumericalFailure) as ei:
        prob.m.update(x_nan, y_new, **kw)
    with pytest.raises(jhealth.NumericalFailure) as jei:
        prob.jm.update(jnp.asarray(x_nan), jnp.asarray(y_new), **kw)
    assert (ei.value.stage, ei.value.statistic) == (jei.value.stage,
                                                    jei.value.statistic)


def test_fit_gp_probes_match_reference(prob):
    """An indefinite GP (a negative jitter) stops at the same probe in
    both packages; a clean one probes clean."""
    y = prob.y[:, 0]
    err = jerr = None
    try:
        gp.fit_gp(prob.x, y, kernel=BaseKernel("gaussian", SIGMA, -0.05),
                  noise=LAM, solve_config=CFG, device="cpu", **prob.build)
    except health.NumericalFailure as e:
        err = e
    try:
        jgp.fit_gp(prob.jx, jnp.asarray(y), kernel=JKernel(
            "gaussian", SIGMA, -0.05), noise=LAM, rank=RANK, levels=LEVELS,
            key=prob.kbuild, solve_config=JCFG)
    except jhealth.NumericalFailure as e:
        jerr = e
    assert err is not None and jerr is not None
    same_record(err, jerr)
    clean = gp.fit_gp(prob.x, y, kernel=prob.kernel, noise=LAM,
                      solve_config=CFG, device="cpu", **prob.build)
    assert bool(torch.isfinite(clean.alpha).all())
