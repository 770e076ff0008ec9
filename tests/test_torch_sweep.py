"""Port parity: the sigma x lambda sweep engine (repro_torch.core.hck
``build_sweep_plan`` / ``sweep_factors``, ``hmatrix.invert_multi`` and
``krr.fit_path``) and its two stages, B8 ``build_gram_dist`` and B9
``build_cross_dist``.

The same numpy inputs go through the JAX reference in float64 -- its
``xla`` path and its Pallas kernels in interpret mode -- and through the
port's plain PyTorch path on the CPU, with the reference's tree and
landmark draws injected.  Tolerance 1e-10 relative (to the largest
entry) unless a line says otherwise.  The CUDA kernels run only on the
card, where chip_smoke.py holds them against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws
from test_torch_fit import reference_draws
from test_torch_oos import flatten_model

from repro.core import hck as jhck
from repro.core import hmatrix as jhm
from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.build_stage import ops as jbuild_ops
from repro.kernels.build_stage import ref as jbuild_ref
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.kernels.registry import get_impl as jget_impl
from repro_torch import convert
from repro_torch.core import hck, hmatrix, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build, registry
from repro_torch.kernels.build_stage import ops as build_ops
from repro_torch.kernels.build_stage.ref import (build_cross_dist_ref,
                                                 build_gram_dist_ref,
                                                 direct_dist,
                                                 pairwise_dist_ref)

KERNELS = ["gaussian", "imq", "laplace"]
METRIC = {"gaussian": "l2", "imq": "l2", "laplace": "l1"}
N, D, RANK, LEAF, LEVELS = 512, 3, 8, 16, 5
SIGMA, JITTER = 0.7, 1e-8
LAMS = [1e-3, 1e-2, 1e-1, 1.0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _jcfg(backend):
    return JSolveConfig(backend=backend, interpret=True)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(20).standard_normal((N, D))


@pytest.fixture(scope="module")
def plans(f64, data):
    """Per metric: (reference plan, port plan with its draws, key)."""
    key = jax.random.PRNGKey(21)
    out = {}
    for name in ("gaussian", "laplace"):
        jp = jhck.build_sweep_plan(jnp.asarray(data), levels=LEVELS,
                                   rank=RANK, key=key, name=name)
        p = hck.build_sweep_plan(
            _t(data), levels=LEVELS, rank=RANK, name=name, device="cpu",
            directions=[_t(v) for v in jp.tree.directions],
            landmark_index=landmark_draws(key, N, LEVELS, RANK))
        out[METRIC[name]] = (jp, p, key)
    return out


# ---------------------------------------------------------------------------
# B8 build_gram_dist and B9 build_cross_dist: plain versions vs reference
# ---------------------------------------------------------------------------

def _dist(rng, shape, name):
    """Nonnegative distances of the kernel's metric."""
    d = rng.standard_normal(shape) ** 2 * 2.0
    if shape[-1] == shape[-2]:
        d = 0.5 * (d + np.swapaxes(d, -1, -2))
        d[..., np.arange(shape[-1]), np.arange(shape[-1])] = 0.0
    return d if METRIC[name] == "l2" else np.sqrt(d)


@pytest.mark.parametrize("want_chol", [True, False], ids=["chol", "gram"])
@pytest.mark.parametrize("name", KERNELS)
def test_build_gram_dist_matches_reference(f64, name, want_chol):
    pts = np.random.default_rng(22).standard_normal((6, 12, D))
    dist = np.asarray(jbuild_ref.pairwise_dist_ref(
        jnp.asarray(pts), jnp.asarray(pts), METRIC[name]))
    opts = dict(name=name, sigma=1.5, jitter=1e-3, want_chol=want_chol)
    wants = [jget_impl("build_gram_dist", "xla")(jnp.asarray(dist), **opts),
             jbuild_ops.build_gram_dist(jnp.asarray(dist), interpret=True,
                                        **opts)]
    before = build_ops.build_gram_dist.launches
    for got in (build_gram_dist_ref(_t(dist), **opts),
                build_ops.build_gram_dist(_t(dist), **opts)):
        for want in wants:
            _close(got[0], want[0])
            if want_chol:
                _close(got[1], want[1])
            else:
                assert got[1] is None and want[1] is None
    assert build_ops.build_gram_dist.launches == before


@pytest.mark.parametrize("name", KERNELS)
def test_build_cross_dist_matches_reference(f64, name):
    rng = np.random.default_rng(23)
    dist = _dist(rng, (4, 32, 8), name)
    linv = np.tril(rng.standard_normal((4, 8, 8))) + 4 * np.eye(8)
    args = (jnp.asarray(dist), jnp.asarray(linv))
    wants = [jget_impl("build_cross_dist", "xla")(*args, name=name,
                                                  sigma=1.5),
             jbuild_ops.build_cross_dist(*args, name=name, sigma=1.5,
                                         interpret=True)]
    before = build_ops.build_cross_dist.launches
    for got in (build_cross_dist_ref(_t(dist), _t(linv), name=name,
                                     sigma=1.5),
                build_ops.build_cross_dist(_t(dist), _t(linv), name=name,
                                           sigma=1.5)):
        for want in wants:
            _close(got, want)
    assert build_ops.build_cross_dist.launches == before


def test_indefinite_distance_tile_gives_nan(f64):
    """No pivot clamp: a Gram that is not positive definite gives NaN, as
    the reference's Cholesky does, not an exception or a clamped factor."""
    pts = np.random.default_rng(24).standard_normal((3, 6, D))
    pts[1, 3] = pts[1, 0]                       # block 1: a repeated point
    dist = np.asarray(jbuild_ref.pairwise_dist_ref(
        jnp.asarray(pts), jnp.asarray(pts), "l2"))
    want = jget_impl("build_gram_dist", "xla")(jnp.asarray(dist),
                                               jitter=0.0)[1]
    gram, chol = build_gram_dist_ref(_t(dist), jitter=0.0)
    assert torch.isfinite(gram).all() and torch.isnan(chol[1]).any()
    np.testing.assert_array_equal(np.isnan(chol.numpy()),
                                  np.isnan(np.asarray(want)))
    _close(chol[[0, 2]], np.asarray(want)[[0, 2]])


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_pairwise_dist_matches_reference(f64, metric):
    rng = np.random.default_rng(25)
    x, y = rng.standard_normal((3, 10, D)), rng.standard_normal((3, 7, D))
    want = jbuild_ref.pairwise_dist_ref(jnp.asarray(x), jnp.asarray(y),
                                        metric)
    _close(pairwise_dist_ref(_t(x), _t(y), metric), want)
    # the card's l2 plan pass sums (x - y)^2 directly: equal to the
    # identity's value to round-off in float64
    _close(direct_dist(_t(x), _t(y), metric), want, 1e-12)


def test_dist_wrappers_reject_bad_shapes_and_oversized_tiles():
    with pytest.raises(ValueError, match="build_gram_dist"):
        build_ops.build_gram_dist(torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="unknown base kernel"):
        build_ops.build_gram_dist(torch.zeros(2, 4, 4), name="cauchy")
    with pytest.raises(ValueError, match="build_cross_dist"):
        build_ops.build_cross_dist(torch.zeros(2, 8, 4), torch.zeros(2, 3, 3))
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_dist_ref(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), "l3")
    # only the tile is resident: m <= 240 in f32, m <= 169 in f64
    assert build_ops.gram_dist_smem(240, 4) <= _build.SMEM_MAX
    assert build_ops.gram_dist_smem(241, 4) > _build.SMEM_MAX
    assert build_ops.gram_dist_smem(169, 8) <= _build.SMEM_MAX
    assert build_ops.gram_dist_smem(170, 8) > _build.SMEM_MAX
    rows = dict(smem=build_ops.cross_dist_smem, stage="build_cross_dist")
    assert build_ops.cross_rows(256, 128, 4, **rows) == 128
    assert build_ops.cross_rows(256, 128, 8, **rows) == 64
    # past them the panel forms: m up to 512, r up to 256 (one tile height)
    assert build_ops.gram_route("t", 241, 4, dist=True) == "panel"
    assert build_ops.cross_rows(512, 256, 4, **rows) == \
        build_ops.PANEL_ROWS[4]
    with pytest.raises(ValueError, match="build_cross_dist.*panel form"):
        build_ops.cross_rows(512, 257, 4, **rows)


# ---------------------------------------------------------------------------
# The plan and the factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_sweep_plan_matches_reference(plans, metric):
    jp, p, _ = plans[metric]
    assert p.metric == jp.metric == metric
    assert (p.levels, p.num_leaves, p.leaf_size, p.rank) == (
        LEVELS, 1 << LEVELS, N >> LEVELS, RANK)
    np.testing.assert_array_equal(p.tree.perm.numpy(), np.asarray(jp.tree.perm))
    np.testing.assert_array_equal(p.x_sorted.numpy(), np.asarray(jp.x_sorted))
    for field in ("landmarks", "lm_self", "lm_cross"):
        assert len(getattr(p, field)) == len(getattr(jp, field))
        for got, want in zip(getattr(p, field), getattr(jp, field)):
            _close(got, want)
    _close(p.leaf_self, jp.leaf_self)
    _close(p.leaf_cross, jp.leaf_cross)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", KERNELS)
def test_sweep_factors_match_reference_and_build_hck(plans, data, name,
                                                     backend):
    jp, p, key = plans[METRIC[name]]
    draws = dict(directions=[_t(v) for v in jp.tree.directions],
                 landmark_index=landmark_draws(key, N, LEVELS, RANK))
    kernel = (name, SIGMA, JITTER)
    jf = jhck.sweep_factors(jp, JKernel(*kernel), _jcfg(backend))
    f = hck.sweep_factors(p, BaseKernel(*kernel))
    built = hck.build_hck(_t(data), levels=LEVELS, rank=RANK,
                          kernel=BaseKernel(*kernel), **draws)
    for field in ("sigma", "sigma_cho"):
        for got, want, own in zip(getattr(f, field), getattr(jf, field),
                                  getattr(built, field)):
            _close(got, want)
            _close(got, own)
    _close(f.adiag, jf.adiag)
    _close(f.adiag, built.adiag)
    # U and W are amplified by kappa(Sigma): held at the operator level
    _close(hck.to_dense(f), jhck.to_dense(jf))
    _close(hck.to_dense(f), hck.to_dense(built))
    assert f.x_sorted is p.x_sorted and f.rank_mask is None


def test_generator_draws_match_build_hck(f64, data):
    """With one generator seed the plan draws the tree and landmarks that
    build_hck draws, so the factors agree."""
    ker = BaseKernel("imq", 1.1, JITTER)
    p = hck.build_sweep_plan(_t(data), levels=4, rank=RANK, name="imq",
                             device="cpu",
                             generator=torch.Generator().manual_seed(3))
    f = hck.build_hck(_t(data), levels=4, rank=RANK, kernel=ker,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(p.tree.perm, f.tree.perm)
    for got, want in zip(p.landmarks, f.landmarks):
        assert torch.equal(got, want)
    _close(hck.to_dense(hck.sweep_factors(p, ker)), hck.to_dense(f))


def test_sweep_rejects_mismatched_and_unsweepable_kernels(plans):
    _, p, _ = plans["l2"]
    with pytest.raises(ValueError, match="metric"):
        hck.sweep_factors(p, BaseKernel("laplace"))
    x = torch.zeros(64, D)
    with pytest.raises(ValueError, match="metric"):
        hck.build_sweep_plan(x, levels=2, rank=4, name="matern",
                             device="cpu")
    with pytest.raises(ValueError, match="levels >= 1"):
        hck.build_sweep_plan(x, levels=0, rank=4, device="cpu")


def test_unported_sweep_options_raise(plans):
    """No sweep option raises any more: ``config.precision`` (ROADMAP
    A15a) leaves the plan in the dtype of x and instantiates the factors
    under the policy, equal to ``build_hck`` under it (bf16 in
    test_torch_mixed_precision.py); the policy axis and the rank budget,
    ported with A10, run (their parity with the reference is in
    tests/test_torch_landmarks.py)."""
    _, p, _ = plans["l2"]
    x = torch.zeros(64, D)
    cfg = registry.SolveConfig(precision="f32")
    assert hck.build_sweep_plan(x, levels=2, rank=4, device="cpu",
                                config=cfg).x_sorted.dtype == x.dtype
    f64 = hck.sweep_factors(p, BaseKernel(),
                            config=registry.SolveConfig(precision="f64"))
    ref = hck.sweep_factors(p, BaseKernel())
    assert f64.u.dtype == torch.float64 and torch.equal(f64.u, ref.u)
    f32 = hck.sweep_factors(p, BaseKernel(), config=cfg)
    assert f32.u.dtype == f32.adiag.dtype == torch.float32
    assert torch.allclose(f32.adiag.double(), ref.adiag, atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((64, D)))
    for kw in (dict(policy="kmeans"), dict(shared_landmarks=True),
               dict(method="pca")):
        assert hck.build_sweep_plan(x, levels=2, rank=4, device="cpu",
                                    **kw).rank == 4
    f = hck.sweep_factors(p, BaseKernel(), rank_budget=p.rank * 4)
    assert f.rank_mask is not None and f.ranks.total <= p.rank * 4
    assert hck.replan_policy(p, rank=4, policy="kmeans").rank == 4
    path = krr.fit_path(x, torch.zeros(64, dtype=x.dtype), kernel=BaseKernel(),
                        lams=LAMS, rank=4, device="cpu", landmarks="leverage")
    assert torch.isfinite(path.alphas).all()


def test_sweep_plan_carried_across(plans):
    """A reference plan carried across by convert gives the factors the
    reference's sweep_factors gives."""
    jp, _, _ = plans["l2"]
    arrays = {"x_sorted": jp.x_sorted, "perm": jp.tree.perm,
              "leaf_self": jp.leaf_self, "leaf_cross": jp.leaf_cross}
    for field in ("directions", "thresholds"):
        for i, v in enumerate(getattr(jp.tree, field)):
            arrays[f"{field}/{i}"] = v
    for field in ("landmarks", "lm_self", "lm_cross"):
        for i, v in enumerate(getattr(jp, field)):
            arrays[f"{field}/{i}"] = v
    p = convert.sweep_plan_from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}, metric="l2",
        device="cpu")
    ker = (1.3, JITTER)
    jf = jhck.sweep_factors(jp, JKernel("gaussian", *ker))
    f = hck.sweep_factors(p, BaseKernel("gaussian", *ker))
    _close(hck.to_dense(f), jhck.to_dense(jf))
    for got, want in zip(f.sigma_cho, jf.sigma_cho):
        _close(got, want)


# ---------------------------------------------------------------------------
# lambda axis: invert_multi
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def factors(plans):
    """(reference factors at sigma 1.2, the same factors in the port)."""
    jp, p, _ = plans["l2"]
    return (jhck.sweep_factors(jp, JKernel("gaussian", 1.2, JITTER)),
            hck.sweep_factors(p, BaseKernel("gaussian", 1.2, JITTER)))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_invert_multi_matches_reference(factors, backend):
    jf, f = factors
    want = jhm.invert_multi(jf, jnp.asarray(LAMS), _jcfg(backend))
    got = hmatrix.invert_multi(f, LAMS)
    assert got.logabsdet.shape == (len(LAMS),)
    for field in ("adiag", "u", "linv", "logabsdet"):
        _close(getattr(got, field), getattr(want, field))
    for field in ("sigma", "w"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            _close(a, b)


def test_invert_multi_bit_matches_invert_loop(factors):
    """Grid point g is invert_with_leaf(f, lams[g]) bit for bit: the one
    stacked leaf_factor launch factors every block as a launch of its own
    would, and the tail is the same code on the same blocks."""
    _, f = factors
    multi, lo_all = hmatrix.invert_multi_with_leaf(f, LAMS)
    for g, lam in enumerate(LAMS):
        one, lo = hmatrix.invert_with_leaf(f, lam)
        at = multi.at(g)
        assert torch.equal(lo_all[g], lo)
        for field in ("adiag", "u", "linv", "logabsdet"):
            assert torch.equal(getattr(at, field), getattr(one, field))
            assert getattr(at, field).is_contiguous()
        for a, b in zip(at.sigma + at.w, one.sigma + one.w):
            assert torch.equal(a, b)


def test_invert_multi_levels0(f64):
    x = np.random.default_rng(26).standard_normal((32, D))
    jf = jhck.build_hck(jnp.asarray(x), levels=0, rank=4,
                        key=jax.random.PRNGKey(1),
                        kernel=JKernel("gaussian", 1.5, JITTER))
    f = hck.build_hck(_t(x), levels=0, rank=4,
                      kernel=BaseKernel("gaussian", 1.5, JITTER))
    want = jhm.invert_multi(jf, jnp.asarray(LAMS))
    got = hmatrix.invert_multi(f, LAMS)
    assert got.linv is None and got.adiag.shape == (4, 1, 32, 32)
    _close(got.adiag, want.adiag)
    _close(got.logabsdet, want.logabsdet)
    for g, lam in enumerate(LAMS):
        assert torch.equal(got.at(g).adiag, hmatrix.invert(f, lam).adiag)


# ---------------------------------------------------------------------------
# fit_path
# ---------------------------------------------------------------------------

def _task_data(task):
    rng = np.random.default_rng(27)
    x = rng.standard_normal((500, D))
    score = np.sin(x).sum(axis=1)
    y = {"regression": score, "binary": np.where(score > 0, 1, -1),
         "multiclass": np.digitize(score, [-0.8, 0.8])}[task]
    xv = rng.standard_normal((70, D))
    sv = np.sin(xv).sum(axis=1)
    yv = {"regression": sv, "binary": np.where(sv > 0, 1, -1),
          "multiclass": np.digitize(sv, [-0.8, 0.8])}[task]
    return x, y, xv, yv


@pytest.mark.parametrize("task", ["regression", "binary", "multiclass"])
def test_fit_path_matches_reference(f64, task):
    x, y, xv, yv = _task_data(task)
    cls = task != "regression"
    key = jax.random.PRNGKey(28)
    jpath = jkrr.fit_path(
        jnp.asarray(x), jnp.asarray(y), kernel=JKernel("gaussian", 1.5,
                                                       JITTER),
        lams=jnp.asarray(LAMS), rank=RANK, leaf_size=LEAF, key=key,
        classification=cls, x_val=jnp.asarray(xv), y_val=jnp.asarray(yv))
    path = krr.fit_path(
        x, y, kernel=BaseKernel("gaussian", 1.5, JITTER), lams=LAMS,
        rank=RANK, leaf_size=LEAF, classification=cls, x_val=xv, y_val=yv,
        device="cpu",
        directions=[_t(v) for v in jpath.factors.tree.directions],
        **reference_draws(key, x, LEAF, jpath.factors.levels, RANK))
    assert path.alphas.shape == (len(LAMS), 512, jpath.alphas.shape[2])
    _close(path.alphas, jpath.alphas)
    _close(path.lams, jpath.lams)
    if cls:
        np.testing.assert_array_equal(path.scores.numpy(),
                                      np.asarray(jpath.scores))
        np.testing.assert_array_equal(path.classes.numpy(),
                                      np.asarray(jpath.classes))
    else:
        _close(path.scores, jpath.scores)
    best, jbest = path.best(), jpath.best()
    assert best.lam == jbest.lam == LAMS[int(torch.argmin(path.scores))]
    _close(best.predict(_t(xv)), jbest.predict(jnp.asarray(xv)))
    # a path carried across by convert predicts as the reference's does
    arrays = flatten_model(jpath.factors, jbest.plan)
    arrays.update({k: np.asarray(v) for k, v in (
        ("lams", jpath.lams), ("alphas", jpath.alphas),
        ("scores", jpath.scores), ("classes", jpath.classes))
        if v is not None})
    cp = convert.path_from_arrays(arrays, kernel="gaussian", sigma=1.5,
                                  jitter=JITTER, squeeze=jpath.squeeze,
                                  device="cpu")
    for g in (0, 3):
        _close(cp.model(g).predict(_t(xv)),
               jpath.model(g).predict(jnp.asarray(xv)))


def test_fit_path_on_prebuilt_sweep_factors(factors, plans):
    """fit_path on one sigma of a sweep: each lambda's alpha is what
    krr.fit's solve gives at that lambda on the same factors."""
    _, f = factors
    _, p, _ = plans["l2"]
    y = torch.sin(p.x_sorted).sum(dim=1)[torch.argsort(p.tree.perm)]
    x = p.x_sorted[torch.argsort(p.tree.perm)]
    path = krr.fit_path(x, y, kernel=BaseKernel("gaussian", 1.2, JITTER),
                        lams=LAMS, factors=f, device="cpu")
    assert path.scores is None and path.squeeze
    with pytest.raises(ValueError, match="validation"):
        path.best()
    y_sorted = y[f.tree.perm][:, None]
    for g, lam in enumerate(LAMS):
        inv, _ = hmatrix.invert_with_leaf(f, lam)
        want = hmatrix.solve_with_inverse(f, inv, y_sorted, ridge=lam)
        assert torch.equal(path.alphas[g], want)
        assert path.model(g).lam == lam
    with pytest.raises(ValueError, match="pad x and y"):
        krr.fit_path(x[:100], y[:100], kernel=BaseKernel(), lams=LAMS,
                     factors=f, device="cpu")
    with pytest.raises(ValueError, match="rank is required"):
        krr.fit_path(x, y, kernel=BaseKernel(), lams=LAMS, device="cpu")


def test_sweep_entry_points_run_on_the_card_by_default(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        hck.build_sweep_plan(_t(data), levels=2, rank=4)
    with pytest.raises(RuntimeError, match="is_available"):
        krr.fit_path(data, data[:, 0], kernel=BaseKernel(), lams=LAMS,
                     rank=4)


def test_dist_stages_registered_for_both_backends():
    assert "build_gram_dist" in registry.STAGES
    for stage in ("build_gram_dist", "build_cross_dist"):
        assert registry.resolve_backend(None, stage, torch.zeros(2)) == "torch"
        for backend in ("torch", "cuda"):
            assert callable(registry.get_impl(stage, backend))
        with pytest.raises(ValueError, match="CUDA tensors only"):
            registry.resolve_backend(registry.SolveConfig(backend="cuda"),
                                     stage, torch.zeros(2))
