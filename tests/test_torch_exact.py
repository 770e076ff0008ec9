"""Port parity: exact-kernel KRR (repro_torch.core.krr.fit_exact and
ExactKRR), ``gp.mle_grid(logdet="slq")``, the baselines, GP sampling and
the converters of this slice.  ``test_torch_exact_pallas.py`` holds the
same fits against the reference's Pallas route, and the float32 solve of
the structured inverse (ROADMAP C4): the two slow halves of this slice's
tests sit in two files, so that a scheduler that gives each file one
worker runs them side by side.

The JAX reference fits in float64 under its ``xla`` backend (here) and its
Pallas kernels in interpret mode; the port fits the same numpy data on the CPU
with the reference's draws injected: the preconditioner's padding rows,
noise, directions and landmarks, EigenPro's subsample, the SLQ probes and
the baselines' draws.  n = 450 does not fill the preconditioner's tree,
so the weighted embed and extract of the padded rows is exercised.
Tolerance 1e-10 relative (to the largest entry) unless a line says
otherwise; the CG iteration counts are equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws, port_build

from repro.core import baselines as jbaselines
from repro.core import gp as jgp
from repro.core import hck as jhck
from repro.core import krr as jkrr
from repro.core import partition as jpartition
from repro.core import sampling as jsampling
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch import convert
from repro_torch.core import baselines, gp, hck, hmatrix, krr, sampling
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import auto_levels

N, D, RANK = 450, 4, 32
SIGMA, JITTER, LAM, TOL = 1.0, 1e-5, 1.0, 1e-9
CASES = ["cg", "plain", "eigenpro", "binary", "multiclass"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _close_pred(got, want, model, queries, rtol=1e-10):
    """Predictions sum_j alpha_j k(x_j, q) cancel, so each is held to rtol
    times the sum of its terms' magnitudes, |K(q, X)| |alpha|."""
    terms = model.kernel.cross(_t(queries), model.x).abs() @ model.alpha.abs()
    err = np.abs(np.asarray(got) - np.asarray(want)).reshape(terms.shape)
    assert (err <= rtol * terms.numpy()).all(), (err / terms.numpy()).max()


def _data(case, seed=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D))
    score = np.sin(x[:, 0]) + 0.25 * np.cos(2 * x[:, 1])
    if case == "binary":
        y = np.where(score > 0.2, 1, -1)
    elif case == "multiclass":
        y = np.digitize(score, [-0.4, 0.4])          # labels 0, 1, 2
    else:
        y = score
    return x, y, rng.standard_normal((37, D))


def precond_draws(key, x, rank):
    """The padding rows, padding noise, tree directions and landmark rows
    that the reference's ``_hck_preconditioner`` draws from ``key``
    (automatic sizing: floor levels, ceil leaf)."""
    n, d = x.shape
    levels = max(1, auto_levels(n, rank))
    leaf = max(-(-n // (1 << levels)), rank)
    extra = leaf * (1 << levels) - n
    kpad, kbuild = jax.random.split(key)
    k1, k2 = jax.random.split(kpad)
    idx = jax.random.randint(k1, (extra,), 0, n)
    noise = 1e-4 * jax.random.normal(k2, (extra, d), dtype=jnp.float64)
    x_pad = jnp.concatenate([jnp.asarray(x), jnp.asarray(x)[idx] + noise])
    kpart, _ = jax.random.split(kbuild)
    _, tree = jpartition.build_partition(x_pad, levels, kpart)
    return dict(pad_index=_t(idx), pad_noise=_t(noise),
                directions=[_t(v) for v in tree.directions],
                landmark_index=landmark_draws(kbuild, x_pad.shape[0], levels,
                                              rank))


def fit_cases(backend):
    """Per case: (reference model under ``backend``, port model fitted on
    the CPU, queries)."""
    cfg = JSolveConfig(backend=backend, interpret=True)
    key = jax.random.PRNGKey(3)
    out = {}
    for case in CASES:
        x, y, q = _data(case)
        opts = dict(lam=LAM, rank=RANK, tol=TOL, maxiter=300)
        kw = dict(classification=case in ("binary", "multiclass"),
                  precondition=case != "plain",
                  solver="eigenpro" if case == "eigenpro" else "cg")
        if case == "eigenpro":
            kw.update(eigenpro_components=60, eigenpro_subsample=256)
        m = jkrr.fit_exact(jnp.asarray(x), jnp.asarray(y),
                           kernel=JKernel("gaussian", SIGMA, JITTER), key=key,
                           solve_config=cfg, row_chunk=128, **opts, **kw)
        draws = (dict(eigenpro_permutation=_t(jax.random.permutation(key, N)))
                 if case == "eigenpro" else precond_draws(key, x, RANK))
        pm = krr.fit_exact(x, y, kernel=BaseKernel("gaussian", SIGMA, JITTER),
                           device="cpu", row_chunk=128, **opts, **kw, **draws)
        out[case] = (m, pm, q)
    return out


@pytest.fixture(scope="module", params=["xla"])
def exact_fits(request, f64):
    """Per case: (reference model, port model fitted on the CPU, queries)."""
    return fit_cases(request.param)


@pytest.mark.parametrize("case", CASES)
def test_fit_exact_matches_reference(exact_fits, case):
    """alpha, the iteration count, convergence and the predictions (and
    labels) of every solver and task.  The residual traces are not held
    entry by entry: on a Gaussian kernel's fast-decaying spectrum CG
    magnifies the round-off of two BLAS' summation orders, which part the
    traces by 1e-9 once they pass ~3e-9 with the preconditioner and ~4e-4
    without it, and the iterates meet again as they converge.  At tol 1e-9
    every stop is decided with a margin of 13% or more (26 to 40
    iterations)."""
    m, pm, q = exact_fits[case]
    assert isinstance(pm, krr.ExactKRR) and pm.lam == LAM
    assert pm.result.iterations == int(m.result.iterations)
    assert pm.result.converged and bool(m.result.converged)
    _close(pm.alpha, m.alpha)
    res = pm.result.residuals
    assert res.shape == (301,)
    assert float(res[pm.result.iterations]) <= TOL
    assert pm.squeeze == m.squeeze
    _close_pred(pm.predict(_t(q)), m.predict(jnp.asarray(q)), pm, q)
    if case in ("binary", "multiclass"):
        np.testing.assert_array_equal(pm.classes.numpy(),
                                      np.asarray(m.classes))
        np.testing.assert_array_equal(
            pm.predict_class(_t(q)).numpy(),
            np.asarray(m.predict_class(jnp.asarray(q))))
    else:
        assert pm.predict(_t(q)).shape == (37,)
        with pytest.raises(ValueError, match="regression"):
            pm.predict_class(_t(q))


def test_fit_exact_carried_across(exact_fits):
    """A reference model carried across by convert predicts as it does."""
    for case in ("cg", "multiclass"):
        m, _, q = exact_fits[case]
        arrays = {"x": np.asarray(m.x), "alpha": np.asarray(m.alpha)}
        if m.classes is not None:
            arrays["classes"] = np.asarray(m.classes)
        cm = convert.exact_krr_from_arrays(
            arrays, kernel="gaussian", sigma=SIGMA, jitter=JITTER, lam=LAM,
            squeeze=m.squeeze, device="cpu")
        assert cm.result is None and cm.lam == LAM
        _close(cm.predict(_t(q)), m.predict(jnp.asarray(q)))
        if m.classes is not None:
            np.testing.assert_array_equal(
                cm.predict_class(_t(q)).numpy(),
                np.asarray(m.predict_class(jnp.asarray(q))))


def test_fit_exact_against_the_dense_solve(f64):
    """The port on its own draws: CG with and without the preconditioner
    reaches torch.linalg.solve(gram + lam I, y) within 1e-6 and predicts
    as the dense cross form; the preconditioner cuts the iterations."""
    x, y, q = _data("cg")
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    want = torch.linalg.solve(ker.gram(_t(x)) + LAM * torch.eye(N),
                              _t(y)[:, None])
    fits = {pre: krr.fit_exact(x, y, kernel=ker, lam=LAM, rank=RANK, tol=TOL,
                               maxiter=400, precondition=pre, device="cpu",
                               generator=torch.Generator().manual_seed(5))
            for pre in (True, False)}
    for model in fits.values():
        assert model.result.converged
        assert float((model.alpha - want).abs().max()) < 1e-6
        pred = model.predict(_t(q))
        assert float((pred - (ker.cross(_t(q), _t(x)) @ want)[:, 0])
                     .abs().max()) < 1e-6
    assert fits[True].result.iterations < fits[False].result.iterations
    pred = fits[True].predict(_t(x))
    assert float(krr.relative_error(pred, _t(y))) == pytest.approx(
        float(torch.linalg.vector_norm(pred - _t(y))
              / torch.linalg.vector_norm(_t(y))))
    assert float(krr.accuracy(torch.tensor([1, 2, 3]),
                              torch.tensor([1, 2, 4]))) == pytest.approx(2 / 3)


def test_fit_exact_rejects_what_it_cannot_do(monkeypatch, f64):
    """The capacity ValueError of an undersized preconditioner tree, an
    unknown solver, and the default device: the card, which raises
    without one."""
    x, y = np.zeros((600, 3)), np.zeros((600,))
    ker = BaseKernel("gaussian", 1.0)
    with pytest.raises(ValueError, match="capacity"):
        krr.fit_exact(x, y, kernel=ker, lam=1e-2, rank=32, levels=2,
                      maxiter=1, device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        krr.fit_exact(x, y, kernel=ker, lam=1e-2, solver="gmres",
                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            krr.fit_exact(x, y, kernel=ker, lam=1e-2, device=device)
    with pytest.raises(RuntimeError, match="is_available"):
        gp.mle_grid(x[:64], y[:64], levels=2, rank=4, sigmas=[1.0],
                    noises=[0.1], logdet="slq")


# ---------------------------------------------------------------------------
# gp.mle_grid(logdet="slq")
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gp_problem(f64):
    """(x (512, 3), y, key, the reference's tree and landmark draws)."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((512, 3))
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.standard_normal(512)
    key = jax.random.PRNGKey(31)
    jf = jhck.build_hck(jnp.asarray(x), levels=5, rank=8, key=key,
                        kernel=JKernel("gaussian", 1.5, 1e-8))
    draws = dict(directions=[_t(v) for v in jf.tree.directions],
                 landmark_index=landmark_draws(key, 512, 5, 8))
    return x, y, key, draws


def test_mle_grid_slq_matches_reference(gp_problem):
    """The SLQ surface with the reference's probes (drawn from its slq_key)
    injected, 2 x 2 grid: within 1e-10 of the reference's; its quadratic
    terms within cg_tol of the exact path's."""
    x, y, key, draws = gp_problem
    sigmas, noises = (0.8, 1.6), (1e-2, 1.0)
    slq_key = jax.random.PRNGKey(42)
    kw = dict(levels=5, rank=8, sigmas=sigmas, noises=noises)
    want = jgp.mle_grid(jnp.asarray(x), jnp.asarray(y), key=key,
                        logdet="slq", slq_probes=8, slq_iters=12,
                        slq_key=slq_key, cg_tol=1e-10, **kw)
    probes = _t(jax.random.rademacher(slq_key, (8, 512), dtype=jnp.float64))
    got = gp.mle_grid(x, y, logdet="slq", slq_iters=12,
                      slq_probe_vectors=probes, cg_tol=1e-10, device="cpu",
                      **kw, **draws)
    assert got.shape == (2, 2)
    _close(got, want)
    exact = gp.mle_grid(x, y, device="cpu", **kw, **draws)
    plan = hck.build_sweep_plan(x, levels=5, rank=8, device="cpu", **draws)
    for s, sigma in enumerate(sigmas):
        f = hck.sweep_factors(plan, BaseKernel("gaussian", sigma, 1e-5))
        ys = _t(y)[plan.tree.perm][:, None]
        quads, lds = gp.slq_row(f, ys, noises, probe_vectors=probes,
                                iters=12, ridge0=0.1, cg_tol=1e-10,
                                cg_maxiter=200)
        const = 0.5 * 512 * math.log(2 * math.pi)
        _close(0.5 * quads + 0.5 * lds + const, got[s])
        for g, lam in enumerate(noises):
            inv = hmatrix.invert(f, lam)
            q_exact = float(ys[:, 0] @ hmatrix.apply_inverse(inv, ys)[:, 0])
            assert abs(float(quads[g]) - q_exact) <= 1e-10 * abs(q_exact)
            assert (float(exact[s, g]) - 0.5 * q_exact - const) == \
                pytest.approx(0.5 * float(inv.logabsdet), rel=1e-10)


def test_mle_grid_slq_warns_when_pcg_stops_early(gp_problem):
    x, y, _, draws = gp_problem
    with pytest.warns(UserWarning, match="stopped at 1 iterations"):
        gp.mle_grid(x, y, levels=5, rank=8, sigmas=[1.0],
                    noises=[0.01, 1.0], logdet="slq", slq_probes=2,
                    slq_iters=4, cg_maxiter=1,
                    device="cpu", slq_generator=torch.Generator()
                    .manual_seed(1), **draws)


# ---------------------------------------------------------------------------
# Baselines and sampling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def baseline_data(f64):
    rng = np.random.default_rng(50)
    x = rng.standard_normal((256, 3))
    y = np.sin(x[:, 0]) + 0.1 * x[:, 2]
    return x, y, rng.standard_normal((29, 3)), jax.random.PRNGKey(51)


@pytest.mark.parametrize("name", ["gaussian", "laplace"])
def test_nystrom_and_rff_match_reference(baseline_data, name):
    """The reference's landmark permutation and spectral draws injected."""
    x, y, q, key = baseline_data
    jk, k = JKernel(name, 1.3, 1e-6), BaseKernel(name, 1.3, 1e-6)
    jm = jbaselines.fit_nystrom(jnp.asarray(x), jnp.asarray(y), kernel=jk,
                                lam=1e-2, rank=40, key=key)
    m = baselines.fit_nystrom(
        x, y, kernel=k, lam=1e-2, rank=40, device="cpu",
        landmark_index=_t(jax.random.permutation(key, 256)[:40]))
    _close(m.predict(_t(q)), jm.predict(jnp.asarray(q)))
    jr = jbaselines.fit_rff(jnp.asarray(x), jnp.asarray(y), kernel=jk,
                            lam=1e-2, rank=64, key=key)
    r = baselines.fit_rff(x, y, kernel=k, lam=1e-2, rank=64, device="cpu",
                          omega=_t(jr.omega), bias=_t(jr.bias))
    _close(r.predict(_t(q)), jr.predict(jnp.asarray(q)))
    own = baselines.fit_rff(x, y, kernel=k, lam=1e-2, rank=64, device="cpu",
                            generator=torch.Generator().manual_seed(2))
    assert own.omega.shape == (3, 64) and bool(torch.isfinite(
        own.predict(_t(q))).all())
    assert float(own.bias.min()) >= 0 and float(own.bias.max()) < 2 * math.pi


def test_independent_and_dense_match_reference(baseline_data):
    x, y, q, key = baseline_data
    jk, k = JKernel("gaussian", 1.3, 1e-6), BaseKernel("gaussian", 1.3, 1e-6)
    jm = jbaselines.fit_independent(jnp.asarray(x), jnp.asarray(y), kernel=jk,
                                    lam=1e-2, levels=3, key=key)
    m = baselines.fit_independent(
        x, y, kernel=k, lam=1e-2, levels=3, device="cpu",
        directions=[_t(v) for v in jm.tree.directions])
    np.testing.assert_array_equal(m.tree.perm.numpy(),
                                  np.asarray(jm.tree.perm))
    _close(m.alpha, jm.alpha)
    _close(m.predict(_t(q)), jm.predict(jnp.asarray(q)))
    jp = jbaselines.fit_independent(jnp.asarray(x), jnp.asarray(y), kernel=jk,
                                    lam=1e-2, levels=3, key=key, method="pca")
    p = baselines.fit_independent(x, y, kernel=k, lam=1e-2, levels=3,
                                  method="pca", device="cpu")
    np.testing.assert_array_equal(p.tree.perm.numpy(), np.asarray(jp.tree.perm))
    _close(p.predict(_t(q)), jp.predict(jnp.asarray(q)))
    jd = jbaselines.fit_exact(jnp.asarray(x), jnp.asarray(y), kernel=jk,
                              lam=1e-2)
    d = baselines.fit_exact(x, y, kernel=k, lam=1e-2, device="cpu")
    _close(d(_t(q)), jd(jnp.asarray(q)))


def test_sampling_matches_reference(f64):
    """The spectral range (the reference's power-iteration start injected),
    sample_prior with the reference's noise, and sqrt_matvec, whose square
    is K_hck + ridge I applied (1e-6: the truncation of the degree-64 Chebyshev series)."""
    x = np.random.default_rng(60).standard_normal((256, 3))
    key = jax.random.PRNGKey(61)
    ker = JKernel("gaussian", 1.5, 1e-5)
    jf = jhck.build_hck(jnp.asarray(x), levels=4, rank=8, key=key,
                        kernel=ker)
    f = port_build(jf, x, key, BaseKernel("gaussian", 1.5, 1e-5), 8)
    v0 = _t(jax.random.normal(jax.random.PRNGKey(0), (256,)))
    lo, hi = sampling.estimate_spectral_range(f, 1.0, v0=v0)
    jlo, jhi = jsampling.estimate_spectral_range(jf, 1.0)
    assert lo == pytest.approx(jlo, rel=1e-12)
    assert hi == pytest.approx(jhi, rel=1e-10)
    skey = jax.random.PRNGKey(62)
    eps = _t(jax.random.normal(skey, (3, 256), dtype=jnp.float64))
    got = sampling.sample_prior(f, ridge=1.0, num_samples=3, eps=eps, v0=v0)
    want = jsampling.sample_prior(jf, ridge=1.0, key=skey, num_samples=3)
    assert got.shape == (3, 256)
    _close(got, want)
    e = eps[0]
    half = sampling.sqrt_matvec(f, e, ridge=1.0, v0=v0)
    _close(half, jsampling.sqrt_matvec(jf, jnp.asarray(e), ridge=1.0))
    twice = sampling.sqrt_matvec(f, half, ridge=1.0, v0=v0)
    _close(twice, hmatrix.matvec(f, e) + 1.0 * e, 1e-6)
    own = sampling.sample_prior(f, ridge=1.0, num_samples=2,
                                generator=torch.Generator().manual_seed(4))
    assert own.shape == (2, 256) and bool(torch.isfinite(own).all())
