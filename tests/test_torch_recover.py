"""Port parity: the recovery ladders (``repro_torch.runtime.recover``).

Each ladder gets the same fault in both packages, on the robustness
problem of ``test_torch_health.make_prob`` (the reference's model carried
across in float64).  The audits' rung names and ok flags must be equal,
the failure records of the failed rungs equal in stage and statistic, and
the recovered outputs within 1e-10 relative.  A ladder that runs dry
raises ``RecoveryExhausted`` with the same audit in both.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_health import LAM, LEAF, RANK, make_prob, same_record
from test_torch_update import insert_draws

from repro.core import hck as jhck
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.runtime import recover as jrecover
from repro.testing import faultinject as jfi
from repro_torch.core import hck
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels.registry import SolveConfig
from repro_torch.runtime import recover
from repro_torch.testing import faultinject as fi

JCFG = JSolveConfig(backend="xla")
CFG = SolveConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def same_audit(audit, jaudit):
    assert audit.op == jaudit.op
    assert audit.rungs == jaudit.rungs
    assert [a.ok for a in audit.attempts] == [a.ok for a in jaudit.attempts]
    assert audit.recovered == jaudit.recovered
    for a, ja in zip(audit.attempts, jaudit.attempts):
        if ja.failure is None:
            assert a.failure is None
        else:
            keys = ("stage", "statistic", "leaf", "node")
            assert {k: a.failure.get(k) for k in keys} == {
                k: ja.failure.get(k) for k in keys}, (a, ja)


def _factors_close(f, jf, rtol=1e-10):
    for field in ("u", "adiag"):
        _close(getattr(f, field), getattr(jf, field), rtol)
    for field in ("sigma", "sigma_cho", "w"):
        for a, b in zip(getattr(f, field), getattr(jf, field)):
            _close(a, b, rtol)


@pytest.fixture(scope="module")
def prob(f64):
    return make_prob()


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["transient", "permanent"])
def test_build_guarded_matches_reference(prob, monkeypatch, fault):
    """A transient fault (the first build's U poisoned) recovers on the
    first jitter rung; a permanent one (every build's U poisoned) fails
    every rung and exhausts the ladder with the same audit."""
    for mod, inj in ((hck, fi), (jhck, jfi)):
        inner, calls = mod.build_hck, []

        def flaky(*a, inner=inner, inj=inj, calls=calls, **kw):
            calls.append(1)
            f = inner(*a, **kw)
            bad = fault == "permanent" or len(calls) == 1
            return inj.poison_factor(f, "u", leaf=3) if bad else f

        monkeypatch.setattr(mod, "build_hck", flaky)
    run = lambda: recover.build_guarded(                        # noqa: E731
        _t(prob.x), kernel=prob.kernel, config=CFG, jitter_rungs=1,
        **prob.build)
    jrun = lambda: jrecover.build_guarded(                      # noqa: E731
        prob.jx, kernel=prob.jker, config=JCFG, jitter_rungs=1, levels=3,
        rank=RANK, key=prob.kbuild)
    if fault == "permanent":
        with pytest.raises(recover.RecoveryExhausted) as ei:
            run()
        with pytest.raises(jrecover.RecoveryExhausted) as jei:
            jrun()
        same_audit(ei.value.audit, jei.value.audit)
        same_record(ei.value.last, jei.value.last)
        assert not ei.value.audit.ok and ei.value.last.leaf == 3
        return
    g, jg = run(), jrun()
    same_audit(g.audit, jg.audit)
    assert g.audit.rungs == ["initial", "jitter x10"] and g.audit.recovered
    assert g.kernel.jitter == jg.kernel.jitter
    _factors_close(g.factors, jg.factors)


# ---------------------------------------------------------------------------
# repair_factors and invert_guarded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("u", float("nan")), ("adiag", float("inf")), ("sigma", float("nan")),
    (None, None)])
def test_repair_factors_matches_reference(prob, field, value):
    f, jf = prob.m.factors, prob.jm.factors
    if field is not None:
        f = fi.poison_factor(f, field, leaf=1, value=value)
        jf = jfi.poison_factor(jf, field, leaf=1, value=value)
    rep, audit = recover.repair_factors(f, prob.kernel, CFG)
    jrep, jaudit = jrecover.repair_factors(jf, prob.jker, JCFG)
    same_audit(audit, jaudit)
    if field is None:
        assert rep is f and audit.rungs == ["probe"]
        return
    assert audit.recovered
    _factors_close(rep, jrep)
    _factors_close(rep, prob.jm.factors, 1e-9)      # the clean build


def test_repair_factors_exhausted_matches_reference(prob):
    """NaN landmarks reach every rung's inputs: the ladder runs dry."""
    f = fi.poison_factor(prob.m.factors, "landmarks")
    jf = jfi.poison_factor(prob.jm.factors, "landmarks")
    f = fi.poison_factor(f, "sigma")
    jf = jfi.poison_factor(jf, "sigma")
    with pytest.raises(recover.RecoveryExhausted) as ei:
        recover.repair_factors(f, prob.kernel, CFG)
    with pytest.raises(jrecover.RecoveryExhausted) as jei:
        jrecover.repair_factors(jf, prob.jker, JCFG)
    same_audit(ei.value.audit, jei.value.audit)
    assert ei.value.audit.rungs == ["probe", "refit_frozen", "rebuild_middle"]


@pytest.mark.parametrize("shift,kernel", [(5 * LAM, True), (5 * LAM, False),
                                          (5e3 * LAM, True)])
def test_invert_guarded_matches_reference(prob, shift, kernel):
    """Ridge escalation repairs a mildly indefinite leaf; a deeply
    indefinite one climbs to the refit rung (with a kernel) or exhausts
    the ladder (without)."""
    bad = fi.indefinite_leaf(prob.m.factors, leaf=2, shift=shift)
    jbad = jfi.indefinite_leaf(prob.jm.factors, leaf=2, shift=shift)
    kw = dict(kernel=prob.kernel) if kernel else {}
    jkw = dict(kernel=prob.jker) if kernel else {}
    try:
        g = recover.invert_guarded(bad, LAM, CFG, **kw)
    except recover.RecoveryExhausted as e:
        g = e
    try:
        jg = jrecover.invert_guarded(jbad, LAM, JCFG, **jkw)
    except jrecover.RecoveryExhausted as e:
        jg = e
    same_audit(g.audit, jg.audit)
    if isinstance(jg, jrecover.RecoveryExhausted):
        assert isinstance(g, recover.RecoveryExhausted)
        assert shift > 1.0 and not kernel
        return
    assert g.audit.recovered and g.ridge == jg.ridge
    _close(g.lo, jg.lo)
    _close(g.inverse.linv, jg.inverse.linv)
    for a, b in zip(g.inverse.sigma, jg.inverse.sigma):
        _close(a, b)
    _factors_close(g.factors, jg.factors)


def test_precision_promotion_rung_names_a15(prob):
    """A promotion rung (ROADMAP A15a) rebuilds every factor on the frozen
    hierarchy at the promoted precision, as the reference's does: under
    an f32 policy a deeply indefinite leaf climbs to "promote:f64", whose
    factors and inverse equal the reference's."""
    bad = fi.indefinite_leaf(prob.m.factors, leaf=2, shift=5e3 * LAM)
    jbad = jfi.indefinite_leaf(prob.jm.factors, leaf=2, shift=5e3 * LAM)
    g = recover.invert_guarded(bad, LAM, SolveConfig(precision="f32"),
                               kernel=prob.kernel, jitter_rungs=0)
    jg = jrecover.invert_guarded(
        jbad, LAM, JSolveConfig(backend="xla", precision="f32"),
        kernel=prob.jker, jitter_rungs=0)
    same_audit(g.audit, jg.audit)
    assert g.audit.rungs == ["initial", "promote:f64"]
    assert g.config.precision == "f64" and g.ridge == LAM
    _factors_close(g.factors, jg.factors, 1e-9)
    _close(g.inverse.linv, jg.inverse.linv, 1e-9)
    assert recover._promotions(CFG) == jrecover._promotions(JCFG) == ()
    assert recover._promotions(SolveConfig(precision="bf16")) == (
        "f32", "f64")


# ---------------------------------------------------------------------------
# pcg_guarded
# ---------------------------------------------------------------------------

def _spd(n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T / n + np.eye(n), rng.standard_normal((n, k))


def _pcg_both(fault, a, b):
    """The same ladder on the same fault: (port outcome, reference
    outcome), each a GuardedSolve."""
    ta, ja = _t(a), jnp.asarray(a)
    out = []
    for mv_of, inj, solve, vec in (
            (lambda v: ta @ v, fi, torch.linalg.solve, _t),
            (lambda v: ja @ v, jfi, jnp.linalg.solve, jnp.asarray)):
        mod = recover if inj is fi else jrecover
        mat = ta if inj is fi else ja
        kw = dict(tol=1e-10)
        if fault == "bad_preconditioner":
            kw.update(precond=inj.bad_preconditioner(),
                      fresh_precond=lambda: None, maxiter=100,
                      flexible=False)
            mv = mv_of
        elif fault == "nonsymmetric_column":
            mv = inj.nonsymmetric_column(mv_of, col=1, eps=2.0)
            kw.update(maxiter=40,
                      exact_solve=lambda bb, m=mat, s=solve: s(m, bb))
        else:
            mv = mv_of
            kw.update(dot=inj.poisoned_dot(after=3)[0],
                      fresh_dot=lambda: None, maxiter=60)
        out.append(mod.pcg_guarded(mv, vec(b), **kw))
    return out


@pytest.mark.parametrize("fault,last", [
    ("bad_preconditioner", "re-precondition"),
    ("nonsymmetric_column", "exact fallback"),
    ("poisoned_dot", "cold restart")])
def test_pcg_guarded_matches_reference(f64, fault, last):
    a, b = _spd(48, 2, 9)
    g, jg = _pcg_both(fault, a, b)
    same_audit(g.audit, jg.audit)
    assert g.audit.rungs[-1] == last and g.audit.recovered
    _close(g.x, jg.x)
    _close(g.x, np.linalg.solve(a, b), 1e-8)


def test_pcg_guarded_exhausted_matches_reference(f64):
    """A permanently nonsymmetric column without an exact solve: every
    rung fails in both packages."""
    a, b = _spd(32, 2, 10)
    ta, ja = _t(a), jnp.asarray(a)
    with pytest.raises(recover.RecoveryExhausted) as ei:
        recover.pcg_guarded(fi.nonsymmetric_column(lambda v: ta @ v, 1, 2.0),
                            _t(b), tol=1e-10, maxiter=30)
    with pytest.raises(jrecover.RecoveryExhausted) as jei:
        jrecover.pcg_guarded(
            jfi.nonsymmetric_column(lambda v: ja @ v, 1, 2.0),
            jnp.asarray(b), tol=1e-10, maxiter=30)
    same_audit(ei.value.audit, jei.value.audit)
    assert ei.value.audit.rungs == ["initial", "cold restart"]


# ---------------------------------------------------------------------------
# update_guarded
# ---------------------------------------------------------------------------

def test_update_guarded_matches_reference(prob):
    """A poisoned cached leaf factor: the bordered update fails its probe
    and the fresh-inverse rung recovers; the recovered predictions
    agree."""
    rng = np.random.default_rng(13)
    x_new = rng.standard_normal((16, 5))
    y_new = rng.standard_normal((16, 2))
    key = jax.random.PRNGKey(21)
    bad, jbad = fi.poison_cached_inverse(prob.m), jfi.poison_cached_inverse(
        prob.jm)
    jm2, jinfo, jaudit = jrecover.update_guarded(
        jbad, jnp.asarray(x_new), jnp.asarray(y_new), key=key)
    m2, info, audit = recover.update_guarded(
        bad, x_new, y_new, **insert_draws(
            key, prob.m.factors.num_leaves, jinfo.record.k, LEAF))
    same_audit(audit, jaudit)
    assert audit.rungs[-1].startswith("re-precondition") and audit.recovered
    assert info.converged == jinfo.converged
    assert math.isfinite(info.residual)
    _close(m2.predict(prob.q), jm2.predict(prob.jq))
    _close(m2.alpha, jm2.alpha)
