"""Port parity: the versioned serving registry and the KRR serve loop
(``repro_torch.serving.predict_service.ModelRegistry``,
``repro_torch.serving.serve_loop.KRRServeLoop``), the launcher's
``--task krr`` and the fault matrix of ``repro_torch.testing.faultinject``.

On the robustness problem of ``test_torch_health.make_prob`` (the
reference's model carried across in float64): publish, rollback (bitwise
within the port) and retire; the canary gate's rejects, which leave the
registry as it was; ``update_and_publish``, plain and guarded, whose
predictions agree with the reference registry's within 1e-10 relative;
the serve loop's retry, degrade and deadline ladder; a hot swap under
load from a second thread; and one detect and one recover case for every
fault class, the autotune tile database's corruption among them (detected
as ``TileDB.corrupt``, recovered by the next save, as the reference's
``tests/test_robustness.py`` holds it).
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_health import LAM, LEAF, make_prob
from test_torch_update import insert_draws

from repro.runtime import recover as jrecover
from repro.serving.predict_service import ModelRegistry as JModelRegistry
from repro.testing import faultinject as jfi
from repro_torch.core import hmatrix
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime import health, recover
from repro_torch.serving.predict_service import ModelRegistry
from repro_torch.serving.serve_loop import KRRServeLoop
from repro_torch.solvers.cg import pcg
from repro_torch.testing import faultinject as fi

BUCKETS = dict(min_bucket=32, max_bucket=256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


@pytest.fixture(scope="module")
def prob(f64):
    return make_prob()


@pytest.fixture(scope="module")
def arrivals(prob):
    rng = np.random.default_rng(13)
    x_new = rng.standard_normal((16, 5))
    return x_new, x_new @ rng.standard_normal((5, 2))


def _registry(model, cls=ModelRegistry, **kw):
    kw.setdefault("canary", model.factors.x_sorted[:32])
    kw.setdefault("canary_tol", 0.5)
    return cls(model, **BUCKETS, **kw)


def _snapshot(reg):
    return (reg.live_version, tuple(reg.versions()), reg._next,
            id(reg.live), id(reg.live.engine), reg.stats["swaps"])


def _update_both(prob, arrivals, jbase, base, **kw):
    """``update_and_publish`` on a reference registry over ``jbase`` and a
    port registry over ``base``, with the same insert draws."""
    x_new, y_new = arrivals
    key = jax.random.PRNGKey(5)
    jreg, reg = _registry(jbase, JModelRegistry), _registry(base)
    jv, jinfo = jreg.update_and_publish(jnp.asarray(x_new),
                                        jnp.asarray(y_new), key=key, **kw)
    v, info = reg.update_and_publish(x_new, y_new, **kw, **insert_draws(
        key, base.factors.num_leaves, jinfo.record.k, LEAF))
    assert v == jv == 2 and info.record.k == jinfo.record.k
    return jreg, reg


# ---------------------------------------------------------------------------
# publish, update, rollback, retire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("guarded", [False, True])
def test_update_and_publish_matches_reference(prob, arrivals, guarded):
    """Plain on the clean model; guarded on a poisoned cached inverse,
    which the ladder repairs.  Then rollback: bitwise what v1 served."""
    base = fi.poison_cached_inverse(prob.m) if guarded else prob.m
    jbase = jfi.poison_cached_inverse(prob.jm) if guarded else prob.jm
    q = prob.q
    z1 = _registry(base).predict(q)[0]
    jreg, reg = _update_both(prob, arrivals, jbase, base, guarded=guarded)
    (z2, v), (jz2, jv) = reg.predict(q), jreg.predict(prob.jq)
    assert v == jv == 2
    _close(z2, jz2)
    assert not torch.equal(z1, z2)
    audit = reg.last_audit
    assert (audit is None) if not guarded else (
        audit.recovered and not audit.attempts[0].ok)
    assert reg.rollback() == jreg.rollback() == 1
    z3, v = reg.predict(q)
    assert v == 1 and torch.equal(z3, reg.get(1).engine(q))
    _close(z3, z1, 0)
    assert reg.stats == jreg.stats
    with pytest.raises(ValueError, match="live"):
        reg.retire(1)
    reg.retire(2)
    assert reg.versions() == [1]
    with pytest.raises(KeyError):
        reg.rollback(2)


def test_update_and_publish_is_transactional(prob, arrivals):
    x_new, y_new = arrivals
    reg = _registry(fi.poison_cached_inverse(prob.m))
    before = _snapshot(reg)
    with pytest.raises(health.NumericalFailure):
        reg.update_and_publish(x_new, y_new, refresh="inverse")
    assert _snapshot(reg) == before
    # NaN labels defeat every rung of the guarded ladder
    with pytest.raises(recover.RecoveryExhausted):
        reg.update_and_publish(x_new, y_new * np.nan, guarded=True)
    assert _snapshot(reg) == before
    assert reg.stats["canary_rejects"] == 0


@pytest.mark.parametrize("fault", ["poisoned", "drifted"])
def test_canary_rejects_and_leaves_the_registry(prob, fault):
    def bad_of(model, inj):
        if fault == "poisoned":
            return inj.poisoned_model(model)
        plan = dataclasses.replace(model.plan, w_leaf=model.plan.w_leaf * 3)
        return dataclasses.replace(model, plan=plan)

    tol = 1e-3 if fault == "drifted" else None
    jreg, reg = _registry(prob.jm, JModelRegistry), _registry(prob.m)
    before = _snapshot(reg)
    with pytest.raises(health.NumericalFailure) as ei:
        reg.publish(bad_of(prob.m, fi), canary_tol=tol)
    with pytest.raises(Exception) as jei:
        jreg.publish(bad_of(prob.jm, jfi), canary_tol=tol)
    assert _snapshot(reg) == before and reg.live_version == 1
    err, jerr = ei.value, jei.value
    assert (err.stage, err.statistic) == (jerr.stage, jerr.statistic)
    assert err.stage == "serving.canary"
    if fault == "drifted":
        assert err.statistic == "canary_drift"
        _close(err.value, jerr.value)
    st, jst = reg.stats, jreg.stats
    assert st["canary_rejects"] == jst["canary_rejects"] == 1
    for k in ("stage", "statistic", "leaf", "node"):
        assert st["last_reject"][k] == jst["last_reject"][k]
    # the clean model still publishes behind the same gate
    assert reg.publish(prob.m) == 2


def test_registry_without_a_model_and_mesh(prob):
    reg = ModelRegistry()
    assert reg.live_version is None and reg.stats["versions"] == []
    with pytest.raises(ValueError):
        reg.predict(prob.q)
    with pytest.raises(ValueError):
        reg.rollback()
    with pytest.raises(NotImplementedError, match="A14"):
        ModelRegistry(prob.m, mesh=object())


# ---------------------------------------------------------------------------
# the serve loop's ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nan", "raise", "slow"])
def test_serve_loop_retries_degrades_and_times_out(prob, arrivals, mode):
    reg = _registry(prob.m)
    loop = KRRServeLoop(reg, max_retries=1)
    q = prob.q[:32]
    assert loop.serve(q).version == 1              # v1 is the last good
    if mode == "nan":
        # v2 passes its canary, then goes bad for good: retry, degrade
        reg.publish(prob.m)
        fi.hijack_live_engine(reg, lambda e: fi.FlakyEngine(
            e, fail_first=-1, mode="nan"))
        out = loop.serve(q)
        assert out.degraded and out.version == 1
        assert "nonfinite" in out.failure and out.retries == 1
        assert torch.equal(out.z, reg.get(1).engine(q))
        st = loop.stats()
        assert (st["degraded_batches"], st["failures"]) == (1, 2)
    elif mode == "raise":
        fi.hijack_live_engine(reg, lambda e: fi.FlakyEngine(
            e, fail_first=1, mode="raise"))
        out = loop.serve(q)
        assert not out.degraded and out.retries == 1
        assert "engine_error" in out.failure and "engine down" in out.failure
        assert loop.stats()["failures"] == 1
    else:
        fi.hijack_live_engine(reg, lambda e: fi.FlakyEngine(
            e, fail_first=1, mode="slow", delay_s=0.2))
        loop.deadline_s = 0.1
        out = loop.serve(q)
        assert not out.degraded and out.retries == 1
        assert "deadline_s" in out.failure
        assert loop.stats()["deadline_misses"] == 1
    assert bool(torch.isfinite(out.z).all())
    # a malformed batch is the caller's error: not retried, not degraded
    with pytest.raises(ValueError, match="feature dim"):
        loop.serve(torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="micro_batch"):
        loop.run(q, 0)


def test_hot_swap_under_load(prob, arrivals):
    """A serving thread drains batches while the main thread updates and
    publishes: every response is bitwise its stamped version's engine on
    its batch, and versions flip once, 1 to 2."""
    x_new, y_new = arrivals
    reg = ModelRegistry(prob.m, warmup=True, **BUCKETS)
    loop = KRRServeLoop(reg)
    gen = torch.Generator().manual_seed(3)
    batches = [torch.randn((16, 5), generator=gen, dtype=torch.float64)
               for _ in range(8)]
    served, stop = [], threading.Event()

    def worker():
        i = 0
        while not stop.is_set():
            served.append((i % 8, loop.serve(batches[i % 8])))
            i += 1

    t = threading.Thread(target=worker)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while len(served) < 5 and time.monotonic() < deadline:
            time.sleep(0.002)
        v2, _ = reg.update_and_publish(x_new, y_new, warmup=True)
        while (not any(r.version == v2 for _, r in served)
               and time.monotonic() < deadline):
            time.sleep(0.002)
    finally:
        stop.set()
        t.join(timeout=60)
    versions = [r.version for _, r in served]
    assert versions[0] == 1 and versions[-1] == 2
    assert versions == sorted(versions)
    assert loop.versions_served == [1, 2]
    for bi, r in served:
        assert torch.equal(r.z, reg.get(r.version).engine(batches[bi]))


def test_launcher_krr_on_cpu(capsys, f64):
    out = launch_serve.main(["--task", "krr", "--device", "cpu", "--n",
                             "2048", "--queries", "2048", "--micro-batch",
                             "256", "--update-batch", "64", "--rollback"])
    loop = out["loop"]
    assert (loop["failures"], loop["retries"], loop["degraded_batches"],
            loop["deadline_misses"]) == (0, 0, 0, 0)
    assert loop["batches"] == 8 and out["versions_in_order"] == [1, 2, 1]
    assert out["rollback_bitwise"] is True
    assert out["registry_stats"]["versions"] == [1, 2]
    assert out["registry_stats"]["live_version"] == 1
    assert out["p50_ms"] > 0 and out["qps"] > 0 and out["update"]["k"] > 0
    # each whole loop.serve call holds its engine attempt and the probe
    assert out["p50_ms"] >= out["engine_p50_ms"]
    assert "versions served in order [1, 2, 1]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the fault matrix: every class detected and recovered
# ---------------------------------------------------------------------------

def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return _t(a @ a.T / n + np.eye(n)), _t(rng.standard_normal((n, 2)))


def _fault_case(name, prob, arrivals):
    """Detect ``name`` (a NumericalFailure) and recover it; return the
    detecting stage and the recovering rungs."""
    m, ker, cfg = prob.m, prob.kernel, prob.m.solve_config
    if name in ("factor_nan", "factor_inf", "sigma_nan"):
        field, value = {"factor_nan": ("u", float("nan")),
                        "factor_inf": ("adiag", float("inf")),
                        "sigma_nan": ("sigma", float("nan"))}[name]
        bad = fi.poison_factor(m.factors, field, leaf=1, value=value)
        with pytest.raises(health.NumericalFailure) as ei:
            health.probe_factors(bad, cfg)
        _, audit = recover.repair_factors(bad, ker, cfg)
        return ei.value.stage, audit
    if name == "indefinite_leaf":
        bad = fi.indefinite_leaf(m.factors, leaf=2, shift=5 * LAM)
        with pytest.raises(health.NumericalFailure) as ei:
            health.probe_leaf_factor(hmatrix.invert_with_leaf(
                bad, LAM, cfg)[1], cfg)
        return ei.value.stage, recover.invert_guarded(
            bad, LAM, cfg, kernel=ker).audit
    if name == "bf16_ridge_floor":
        # bf16-built factors (jitter 1e-6) inverted at a ridge far below
        # n0 * eps_bf16: the leaf Schur Cholesky fails; promotion to f32
        # at the original ridge repairs it, as in the reference
        bf, ker16, cfg16 = fi.bf16_ridge_floor_factors(
            _t(prob.x), kernel=ker, config=cfg, **prob.build)
        assert bf.u.dtype == torch.float32
        with pytest.raises(health.NumericalFailure) as ei:
            health.probe_leaf_factor(hmatrix.invert_with_leaf(
                bf, 1e-3, cfg16)[1], cfg16, force=True)
        g = recover.invert_guarded(bf, 1e-3, cfg16, kernel=ker16,
                                   jitter_rungs=0)
        assert g.audit.rungs[-1] == "promote:f32" and g.ridge == 1e-3
        return ei.value.stage, g.audit
    if name.startswith("cg_") or name == "collective_nan":
        a, b = _spd(32, 11)
        mv = lambda v: a @ v                                 # noqa: E731
        kw, gkw = {}, {}
        if name == "cg_bad_preconditioner":
            kw = gkw = dict(precond=fi.bad_preconditioner(), flexible=False)
            gkw = dict(gkw, fresh_precond=lambda: None)
        elif name == "cg_nonsymmetric_column":
            mv = fi.nonsymmetric_column(mv, col=1, eps=2.0)
            gkw = dict(exact_solve=lambda bb: torch.linalg.solve(a, bb))
        else:
            kw = dict(dot=fi.poisoned_dot(after=3)[0])
            gkw = dict(dot=fi.poisoned_dot(after=3)[0],
                       fresh_dot=lambda: None)
        with pytest.raises(health.NumericalFailure) as ei:
            health.probe_cg(pcg(mv, b, tol=1e-10, maxiter=40, **kw),
                            tol=1e-10, force=True)
        return ei.value.stage, recover.pcg_guarded(
            mv, b, tol=1e-10, maxiter=40, **gkw).audit
    if name == "tile_db_corruption":
        # REPRO_TILE_DB points into the test's tmp_path
        from repro_torch.kernels import autotune

        fi.corrupt_tile_db()
        db = autotune.get_db()
        assert db.corrupt and db.entries == {}        # detected, degraded
        assert autotune.lookup_block("oos_local", n0=64, r=0, k=2,
                                     d=4) is None     # the plan, no raise
        db.put("probe", {"block": 32})
        db.save()                                     # the save repairs it
        autotune.reset_db()
        healed = autotune.get_db()
        assert not healed.corrupt and healed.get("probe") == {"block": 32}
        autotune.reset_db()
        return "kernels.autotune", recover.RecoveryAudit(
            "tile_db", [recover.Attempt("consult-corrupt-db", False),
                        recover.Attempt("save-rewrites", True)])
    x_new, y_new = arrivals
    if name == "update_poisoned_cache":
        bad = fi.poison_cached_inverse(m)
        with pytest.raises(health.NumericalFailure) as ei:
            bad.update(x_new, y_new)
        return ei.value.stage, recover.update_guarded(bad, x_new, y_new)[2]
    reg = _registry(m)
    if name == "serving_poisoned_model":
        with pytest.raises(health.NumericalFailure) as ei:
            reg.publish(fi.poisoned_model(m))
        reg.publish(m)
        return ei.value.stage, recover.RecoveryAudit(
            "publish", [recover.Attempt("canary-reject", False),
                        recover.Attempt("publish-clean", True)])
    loop = KRRServeLoop(reg, max_retries=1)
    loop.serve(prob.q[:32])
    reg.publish(m)
    fi.hijack_live_engine(reg, lambda e: fi.FlakyEngine(e, fail_first=-1))
    out = loop.serve(prob.q[:32])
    assert out.degraded and "nonfinite" in out.failure
    return "serve", recover.RecoveryAudit(
        "serve", [recover.Attempt("retry", False),
                  recover.Attempt("degrade-to-last-good", True)])


@pytest.mark.parametrize("name", list(fi.FAULT_CLASSES))
def test_zz_fault_matrix_covers_every_class(prob, arrivals, name, tmp_path,
                                            monkeypatch):
    assert fi.FAULT_CLASSES == jfi.FAULT_CLASSES
    assert fi.A15_FAULTS == ()
    monkeypatch.setenv("REPRO_TILE_DB", str(tmp_path / "tile_db.json"))
    stage, audit = _fault_case(name, prob, arrivals)
    assert stage, name
    assert audit.ok and not audit.attempts[0].ok, (name, audit)
    assert jrecover.RecoveryAudit  # the reference's audit type, same shape
    assert set(audit.to_dict()) == {"op", "recovered", "attempts"}
